"""Train and eval steps (port of ``srl_zoo_tpu/training/train_step.py``
``_loss_fn`` / ``train_step`` / ``eval_step``).

A batch comes from the loader (data/loader.py) in one of three forms. An
index batch reads the device-resident store (data/device_cache.py): the
gather kernel (K2) reads its rows from the uint8 store and normalizes
them, and once more the next frames, rows ``min(i + 1, N - 1)``, when a
loss reads the next state (priors, forward, inverse, reward). A config
that stacks both camera views gathers each view from its own store and
joins them on the channel axis. The triplet loss gathers two more: the
positive, the same rows of the second view (``frames_2``), and the
negative, the rows ``neg_indices`` of the first. A hybrid batch
(data/hybrid.py) addresses the store by slot instead (``cache_slots``,
``next_cache_slots``, ``neg_cache_slots``). A streamed batch carries its
uint8 pixels on the device (data/transfer.py), and K2 normalizes them
over the identity index, so that it computes what the cached step
computes, bit for bit. The indices stay on the host and the metadata goes
up without a synchronise, so the host can queue a step while the device still runs the
one before. The model runs forward (the pools' K1 forward writes the
argmax plane), the loss is taken, the backward runs (K1's backward at each
pool) and the optimizer counts a micro-step (training/state.py: Adam
steps on every ``grad_accum``-th). A cached phase of the learner runs
whole instead (training/epoch.py, the JAX package's ``train_epoch`` /
``eval_epoch``): its index batches are stacked once on the host
(``step_keys``, ``step_arrays``), and each step (``cached_train_step``,
``cached_eval_step``) reads its row of the stacked device tensors, so
that K2 gathers by a device index and the step holds no host work that a
CUDA graph could not capture.

Random draws come in from the caller. In train mode a VAE's ``eps`` is
drawn from the caller's ``torch.Generator``, one (B, state_dim) normal for
the state and one for the next state, and so is the denoising
autoencoder's corruption of the frames the encoder reads (``corruption``:
the occlusion's patch corners, or the gaussian noise). Eval draws nothing:
a DAE's eval step takes the run's one validation corruption, which the
learner draws once and passes to every validation batch of every epoch,
as the JAX package's fixed eval key does.

The episode prior applies the discriminator twice to the state pairs
``(s, s[episode_partners])`` of its slice: on detached states, so that
its loss trains the discriminator alone, and through a detached copy of
the discriminator's parameters, so that its encoder loss trains the
encoder alone. The perceptual loss reads a frozen DAE (``frozen_dae``,
kept out of the model) on the reconstruction, which the gradient flows
through, and on the clean frames. The JAX package pads an epoch's step
axis to a bucket to reuse compiled programs and skips the padded steps;
here only the real steps run.

In a process group (parallel/mesh.py) every rank reads the same global
batch and computes its block of B/world rows of it: the store's gather
(K2, or the sharded store's reduce-scatter and K2) gives this rank's rows,
a streamed batch carries only those rows' pixels (data/loader.py), which
K2 normalizes as they are, and the random draws are the global batch's, of which each rank keeps its
rows, so that they are the single process's draws. BatchNorm takes the
global batch's statistics (models/batchnorm.py). The model's state-sized
outputs are then gathered into the global batch with a gradient
(``mesh.gather_rows``), as are the per-sample pixel errors, so that every
rank computes the same global loss, whose pairs may join rows of two
ranks. The gather's backward sums the ranks' gradients, so each rank's
parameter gradients are world x its share, and the parameters that the
global part reads directly (the regularizers, the episode prior's
discriminator) get the whole gradient on every rank: the optimizer's mean
over the ranks (``mesh.average_gradients``) is then the single process's
gradient.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from srl_zoo_tpu_torch.data.device_cache import (gather_obs, gather_view,
                                                  store_rows)
from srl_zoo_tpu_torch.losses.registry import compute_total_loss
from srl_zoo_tpu_torch.models.srl_modules import SRLModules, slice_state
from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.ops.preproc import (draw_gaussian_noise,
                                           draw_occlusion, gaussian_noise,
                                           occlude)
from srl_zoo_tpu_torch.utils.device import upload

_PAIRS = {"same_action_partners": torch.int64,
          "same_action_mask": torch.float32,
          "dissimilar_partners": torch.int64,
          "dissimilar_mask": torch.float32}


def _metadata(cfg) -> Dict[str, torch.dtype]:
    """The batch's metadata that the config's losses read, and the dtype
    each goes up as."""
    keys = {}
    if cfg.use_forward or cfg.use_inverse:
        keys["actions"] = torch.int64
    if cfg.use_reward:
        keys["reward_classes"] = torch.int64
    if cfg.use_priors:
        keys.update(_PAIRS)
    if "reward-prior" in cfg.loss_names:
        keys["rewards"] = torch.float32
    if cfg.use_supervised:
        keys["gt_states"] = torch.float32
    if cfg.use_episode_prior:
        keys["episode_partners"] = torch.int64
        keys["episode_labels"] = torch.float32
    return keys


def draw_corruption(cfg, generator: torch.Generator, batch: int, device):
    """The DAE's draw for ``batch`` frames of ``cfg``'s shape: the gaussian
    noise, else the occlusion's patch corners."""
    if cfg.noise_type == "gaussian":
        return draw_gaussian_noise(generator, (batch,) + cfg.img_shape,
                                   device)
    return draw_occlusion(generator, batch, cfg.img_height, cfg.img_width,
                          cfg.occlusion_percentage, device)


def corrupt(cfg, obs: torch.Tensor, corruption) -> torch.Tensor:
    """The normalized frames with the DAE's corruption applied."""
    if cfg.noise_type == "gaussian":
        return gaussian_noise(obs, corruption, cfg.noise_std)
    return occlude(obs, corruption, cfg.occlusion_percentage)


def normalize_streamed(u8, mode: str, device: torch.device) -> torch.Tensor:
    """A streamed uint8 batch (B, H, W, C) normalized by the gather kernel
    over the identity index, on ``device`` (a host array goes up first):
    the same arithmetic as the cached gather of the same frames, so a
    streamed step computes what the cached step computes, bit for bit. A
    6-channel batch is one launch: both normalize modes are per-channel
    affine maps whose 6-channel parameters are the 3-channel ones twice."""
    if not isinstance(u8, torch.Tensor):
        u8 = upload(np.asarray(u8), device)
    return gather_normalize(u8, np.arange(u8.shape[0]), mode)


def _images(model: SRLModules, store: Optional[Dict[str, torch.Tensor]],
            batch: Dict):
    """(obs, next_obs, pos_obs, neg_obs) normalized on the device, the
    last three None where no loss reads them: from the batch's uint8
    pixels (a streamed batch, data/transfer.py, whose pixels are this
    rank's rows already: nothing shards them again), or gathered from the
    store by row index, or by store slot (``cache_slots``,
    ``next_cache_slots``, ``neg_cache_slots``: the hybrid store)."""
    cfg = model.cfg
    mode = cfg.normalize_mode
    if "obs" in batch:
        dev = next(model.parameters()).device

        def norm(key):
            return normalize_streamed(batch[key], mode, dev)
        return (norm("obs"), norm("next_obs") if cfg.needs_next_obs else None,
                norm("pos_obs") if cfg.use_triplet else None,
                norm("neg_obs") if cfg.use_triplet else None)
    idx = np.asarray(batch.get("cache_slots", batch["indices"]), np.int64)
    obs = gather_obs(store, idx, cfg)
    next_obs = pos_obs = neg_obs = None
    if cfg.needs_next_obs:
        nxt = batch.get("next_cache_slots")
        nxt = np.minimum(idx + 1, store_rows(store) - 1) if nxt is None \
            else np.asarray(nxt, np.int64)
        next_obs = gather_obs(store, nxt, cfg)
    if cfg.use_triplet:
        pos_obs = gather_view(store, "frames_2", idx, mode)
        neg = batch.get("neg_cache_slots", batch.get("neg_indices"))
        neg_obs = gather_view(store, "frames", np.asarray(neg, np.int64),
                              mode)
    return obs, next_obs, pos_obs, neg_obs


def _inputs(model: SRLModules, store: Optional[Dict[str, torch.Tensor]],
            batch: Dict, generator: Optional[torch.Generator] = None,
            corruption=None) -> Dict:
    """The model's and the loss's inputs on the device: ``obs`` (the clean
    frames), ``next_obs`` (None unless a loss reads it), ``pos_obs`` and
    ``neg_obs`` (None without the triplet loss), ``valid``, ``batch`` (the
    metadata tensors), ``noise`` (the VAE's eps in train mode) and
    ``corruption`` (the DAE's draw: from ``generator`` in train mode, the
    given one in eval mode). In a process group the frames and the noise
    are this rank's rows, the metadata and the corruption the global
    batch's."""
    cfg = model.cfg
    # host indices and metadata go up pinned and non-blocking: building a
    # step's inputs waits for nothing on the device
    images = _images(model, store, batch)
    dev = images[0].device
    tensors = {k: upload(np.asarray(batch[k]), dev, dt)
               for k, dt in _metadata(cfg).items()}
    return _draws(model, images, tensors,
                  upload(batch["valid"], dev, torch.float32), generator,
                  corruption)


def step_keys(cfg) -> Dict[str, torch.dtype]:
    """The inputs of a cached step in the form the epoch runner stacks
    (training/epoch.py), and the dtype each goes up as: the store rows
    (``rows``: the whole store's rows or the hybrid store's slots), the
    next frames' rows (``next_rows``, where a loss reads them), the
    triplet's negatives' rows (``neg_rows``), the metadata the losses
    read and ``valid``."""
    keys = {"rows": torch.int64}
    if cfg.needs_next_obs:
        keys["next_rows"] = torch.int64
    if cfg.use_triplet:
        keys["neg_rows"] = torch.int64
    return keys | _metadata(cfg) | {"valid": torch.float32}


def step_arrays(batch: Dict, cfg, n_rows: int) -> Dict[str, np.ndarray]:
    """``step_keys``'s arrays of one index batch of a store of ``n_rows``
    rows: the rows the per-step form gathers (by slot where the batch
    carries slots; the next rows ``min(i + 1, n_rows - 1)`` otherwise),
    computed on the host once, and the metadata as it comes."""
    rows = np.asarray(batch.get("cache_slots", batch["indices"]), np.int64)
    out = {"rows": rows}
    if cfg.needs_next_obs:
        nxt = batch.get("next_cache_slots")
        out["next_rows"] = np.minimum(rows + 1, n_rows - 1) if nxt is None \
            else np.asarray(nxt, np.int64)
    if cfg.use_triplet:
        out["neg_rows"] = np.asarray(batch.get(
            "neg_cache_slots", batch.get("neg_indices")), np.int64)
    for k in _metadata(cfg):
        out[k] = np.asarray(batch[k])
    out["valid"] = np.asarray(batch["valid"])
    return out


def _cached_inputs(model: SRLModules, store, xs: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   corruption=None) -> Dict:
    """``_inputs`` of one step of ``step_keys``'s tensors ``xs``, which
    lie on the store's device already: K2 gathers by the device index
    (range-checked when the epoch was stacked), and nothing crosses the
    host link, so the step can be captured into a CUDA graph."""
    cfg = model.cfg
    mode = cfg.normalize_mode
    rows = xs["rows"]
    obs = gather_obs(store, rows, cfg)
    next_obs = gather_obs(store, xs["next_rows"], cfg) \
        if cfg.needs_next_obs else None
    pos_obs = neg_obs = None
    if cfg.use_triplet:
        pos_obs = gather_view(store, "frames_2", rows, mode)
        neg_obs = gather_view(store, "frames", xs["neg_rows"], mode)
    return _draws(model, (obs, next_obs, pos_obs, neg_obs),
                  {k: xs[k] for k in _metadata(cfg)}, xs["valid"],
                  generator, corruption)


def _draws(model: SRLModules, images, tensors: Dict[str, torch.Tensor],
           valid: torch.Tensor, generator: Optional[torch.Generator],
           corruption) -> Dict:
    """The inputs dict of ``_inputs`` from the normalized frames, the
    metadata tensors and ``valid``, with the train mode's random draws
    (the VAE's eps, then the DAE's corruption) from ``generator``."""
    cfg = model.cfg
    obs, next_obs, pos_obs, neg_obs = images
    dev = obs.device
    b = valid.shape[0]
    noise = None
    if cfg.use_vae and model.training:
        noise = {name: mesh.shard_rows(torch.randn(
                     (b, cfg.state_dim), generator=generator, device=dev))
                 for name in ("state", "next_state")[:1 + cfg.needs_next_obs]}
    if cfg.use_dae and model.training:
        corruption = draw_corruption(cfg, generator, b, dev)
    return {"obs": obs, "next_obs": next_obs, "pos_obs": pos_obs,
            "neg_obs": neg_obs, "valid": valid, "batch": tensors,
            "noise": noise, "corruption": corruption}


def _perceptual(model: SRLModules, outputs: Dict[str, torch.Tensor],
                target: torch.Tensor,
                frozen_dae: Optional[SRLModules]) -> None:
    """The perceptual loss's frozen-DAE features of the reconstruction and
    of the clean frames, added to ``outputs``."""
    if "perceptual" in model.cfg.loss_names:
        if frozen_dae is None:
            raise ValueError("perceptual loss requires a frozen DAE "
                             "(--path-to-dae)")
        outputs["feat_recon"] = frozen_dae.encode(outputs["recon"])
        outputs["feat_target"] = frozen_dae.encode(target)


def _episode_prior(model: SRLModules, outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]) -> None:
    """The episode prior's two discriminator applies on the batch's state
    pairs, added to ``outputs``."""
    cfg = model.cfg
    if cfg.use_episode_prior:
        s1 = slice_state(outputs["state"], cfg.slices["episode-prior"])
        s2 = s1[batch["episode_partners"]]
        # the discriminator learns on detached states ...
        outputs["disc_logits_d"] = model.discriminate(s1.detach(),
                                                      s2.detach())
        # ... and the encoder fools a copy whose parameters are detached
        frozen = {k: v.detach()
                  for k, v in model.discriminator.named_parameters()}
        outputs["disc_logits_e"] = functional_call(model.discriminator,
                                                   frozen, (s1, s2))


def _local(corruption):
    """This rank's rows of a DAE draw of the global batch (the gaussian
    noise, or the occlusion's tuple of corners)."""
    if isinstance(corruption, tuple):
        return tuple(mesh.shard_rows(t) for t in corruption)
    return mesh.shard_rows(corruption)


def _loss(model: SRLModules, inputs: Dict,
          frozen_dae: Optional[SRLModules] = None):
    """(total, metrics) of ``_inputs``: the encoder reads the frames the
    DAE corrupts, the reconstruction losses hold the clean ones. In a
    process group the state-sized outputs and the pixel errors are
    gathered into the global batch first."""
    cfg = model.cfg
    enc_obs = inputs["obs"]
    if cfg.use_dae:
        if inputs["corruption"] is None:
            raise ValueError("a DAE step needs its corruption (eval: the "
                             "validation draw)")
        enc_obs = corrupt(cfg, enc_obs, _local(inputs["corruption"]))
    batch = inputs["batch"]
    actions = batch.get("actions")
    outputs = model(enc_obs, inputs["next_obs"],
                    None if actions is None else mesh.shard_rows(actions),
                    inputs["noise"], inputs["pos_obs"], inputs["neg_obs"])
    _perceptual(model, outputs, inputs["obs"], frozen_dae)
    if mesh.active():
        # one gather a tensor (a model without the VAE returns its state
        # as mu too)
        pairs = []
        for k, v in list(outputs.items()):
            if k == "recon":
                continue
            g = next((g for t, g in pairs if t is v), None)
            if g is None:
                g = mesh.gather_rows(v)
                pairs.append((v, g))
            outputs[k] = g
    _episode_prior(model, outputs, batch)
    return compute_total_loss(cfg, outputs, inputs["obs"],
                              inputs["valid"], model.parameters(), batch,
                              rows=mesh.gather_rows if mesh.active()
                              else None)


def train_step(model: SRLModules, optimizer,
               store: Optional[Dict[str, torch.Tensor]], batch: Dict,
               generator: torch.Generator,
               frozen_dae: Optional[SRLModules] = None
               ) -> Dict[str, torch.Tensor]:
    """One micro-step in train mode (BatchNorm batch statistics, running
    averages updated; the VAE's eps and the DAE's corruption drawn from
    ``generator``): the gradient is added and the optimizer
    (training/state.py ``AccumulatingAdam``) steps on every
    ``grad_accum``-th call. Returns the batch's metrics, on the device."""
    model.train()
    total, metrics = _loss(model, _inputs(model, store, batch, generator),
                           frozen_dae)
    optimizer.backward(total)
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def cached_train_step(model: SRLModules, optimizer, store,
                      xs: Dict[str, torch.Tensor],
                      generator: torch.Generator, frozen_dae=None,
                      apply: bool = True) -> Dict[str, torch.Tensor]:
    """``train_step`` of one step of stacked device inputs (``xs``, as
    ``_cached_inputs`` reads them), without the optimizer's host count:
    the caller counts the micro-step (``optimizer.advance()``) and passes
    whether the Adams step (``apply``), so that one graph captures an
    accumulating micro-step and another a stepping one."""
    model.train()
    total, metrics = _loss(model, _cached_inputs(model, store, xs,
                                                 generator), frozen_dae)
    optimizer.backward(total)
    if apply:
        optimizer.apply()
    return {k: v.detach() for k, v in metrics.items()}


def cached_eval_step(model: SRLModules, store, xs: Dict[str, torch.Tensor],
                     corruption=None, frozen_dae=None
                     ) -> Dict[str, torch.Tensor]:
    """``eval_step`` of one step of stacked device inputs."""
    model.eval()
    with torch.no_grad():
        return _loss(model, _cached_inputs(model, store, xs,
                                           corruption=corruption),
                     frozen_dae)[1]


def eval_step(model: SRLModules, store: Optional[Dict[str, torch.Tensor]],
              batch: Dict, corruption=None,
              frozen_dae: Optional[SRLModules] = None
              ) -> Dict[str, torch.Tensor]:
    """The batch's metrics in eval mode (running statistics, the VAE's
    mu; a DAE's frames corrupted by ``corruption``, the run's validation
    draw), no update."""
    model.eval()
    with torch.no_grad():
        return _loss(model, _inputs(model, store, batch,
                                    corruption=corruption), frozen_dae)[1]
