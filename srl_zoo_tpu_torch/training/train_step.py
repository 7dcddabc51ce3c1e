"""Train and eval steps over the device-resident frame store (port of
``srl_zoo_tpu/training/train_step.py`` ``_loss_fn`` / ``train_step`` /
``eval_step``, cached mode).

A batch is the loader's index batch (data/loader.py); the store is the
dict of data/device_cache.py. The gather kernel (K2) reads its rows from
the uint8 store and normalizes them, and once more the next frames, rows
``min(i + 1, N - 1)``, when a loss reads the next state (priors, forward,
inverse, reward). A config that stacks both camera views gathers each
view from its own store and joins them on the channel axis. The triplet
loss gathers two more: the positive, the same rows of the second view
(``frames_2``), and the negative, the rows ``neg_indices`` of the first.
The indices stay on the host and the metadata goes up without a
synchronise, so the host can queue a step while the device still runs the
one before. The model runs forward (the pools' K1 forward writes the
argmax plane), the loss is taken, the backward runs (K1's backward at each
pool) and the optimizer counts a micro-step (training/state.py: Adam
steps on every ``grad_accum``-th).

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
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from srl_zoo_tpu_torch.data.device_cache import gather_obs
from srl_zoo_tpu_torch.losses.registry import compute_total_loss
from srl_zoo_tpu_torch.models.srl_modules import SRLModules, slice_state
from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
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


def _inputs(model: SRLModules, store: Dict[str, torch.Tensor],
            batch: Dict[str, np.ndarray],
            generator: Optional[torch.Generator] = None,
            corruption=None) -> Dict:
    """The model's and the loss's inputs on the device: ``obs`` (the clean
    frames), ``next_obs`` (None unless a loss reads it), ``pos_obs`` and
    ``neg_obs`` (None without the triplet loss), ``valid``, ``batch`` (the
    metadata tensors), ``noise`` (the VAE's eps in train mode) and
    ``corruption`` (the DAE's draw: from ``generator`` in train mode, the
    given one in eval mode)."""
    cfg = model.cfg
    frames = store["frames"]
    dev = frames.device
    # host indices and metadata go up pinned and non-blocking: building a
    # step's inputs waits for nothing on the device
    idx = np.asarray(batch["indices"], np.int64)
    obs = gather_obs(store, idx, cfg)
    next_obs = gather_obs(store, np.minimum(idx + 1, frames.shape[0] - 1),
                          cfg) if cfg.needs_next_obs else None
    pos_obs = neg_obs = None
    if cfg.use_triplet:
        pos_obs = gather_normalize(store["frames_2"], idx,
                                   cfg.normalize_mode)
        neg_obs = gather_normalize(frames, np.asarray(batch["neg_indices"],
                                                      np.int64),
                                   cfg.normalize_mode)
    tensors = {k: upload(np.asarray(batch[k]), dev, dt)
               for k, dt in _metadata(cfg).items()}
    noise = None
    if cfg.use_vae and model.training:
        shape = (len(idx), cfg.state_dim)
        noise = {name: torch.randn(shape, generator=generator, device=dev)
                 for name in ("state", "next_state")[:1 + cfg.needs_next_obs]}
    if cfg.use_dae and model.training:
        corruption = draw_corruption(cfg, generator, len(idx), dev)
    return {"obs": obs, "next_obs": next_obs, "pos_obs": pos_obs,
            "neg_obs": neg_obs,
            "valid": upload(batch["valid"], dev, torch.float32),
            "batch": tensors, "noise": noise, "corruption": corruption}


def _extras(model: SRLModules, outputs: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], target: torch.Tensor,
            frozen_dae: Optional[SRLModules]) -> None:
    """The outputs that need more than the model's forward, added to
    ``outputs``: the episode prior's two discriminator applies and the
    perceptual loss's frozen-DAE features."""
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
    if "perceptual" in cfg.loss_names:
        if frozen_dae is None:
            raise ValueError("perceptual loss requires a frozen DAE "
                             "(--path-to-dae)")
        outputs["feat_recon"] = frozen_dae.encode(outputs["recon"])
        outputs["feat_target"] = frozen_dae.encode(target)


def _loss(model: SRLModules, inputs: Dict,
          frozen_dae: Optional[SRLModules] = None):
    """(total, metrics) of ``_inputs``: the encoder reads the frames the
    DAE corrupts, the reconstruction losses hold the clean ones."""
    cfg = model.cfg
    enc_obs = inputs["obs"]
    if cfg.use_dae:
        if inputs["corruption"] is None:
            raise ValueError("a DAE step needs its corruption (eval: the "
                             "validation draw)")
        enc_obs = corrupt(cfg, enc_obs, inputs["corruption"])
    outputs = model(enc_obs, inputs["next_obs"],
                    inputs["batch"].get("actions"), inputs["noise"],
                    inputs["pos_obs"], inputs["neg_obs"])
    _extras(model, outputs, inputs["batch"], inputs["obs"], frozen_dae)
    return compute_total_loss(cfg, outputs, inputs["obs"],
                              inputs["valid"], model.parameters(),
                              inputs["batch"])


def train_step(model: SRLModules, optimizer, store: Dict[str, torch.Tensor],
               batch: Dict[str, np.ndarray], generator: torch.Generator,
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


def eval_step(model: SRLModules, store: Dict[str, torch.Tensor],
              batch: Dict[str, np.ndarray], corruption=None,
              frozen_dae: Optional[SRLModules] = None
              ) -> Dict[str, torch.Tensor]:
    """The batch's metrics in eval mode (running statistics, the VAE's
    mu; a DAE's frames corrupted by ``corruption``, the run's validation
    draw), no update."""
    model.eval()
    with torch.no_grad():
        return _loss(model, _inputs(model, store, batch,
                                    corruption=corruption), frozen_dae)[1]
