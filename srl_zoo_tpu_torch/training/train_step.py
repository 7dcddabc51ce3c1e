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
pool) and Adam steps. In train mode a VAE's ``eps`` is drawn from the
caller's ``torch.Generator``, one (B, state_dim) normal for the state and
one for the next state; eval draws nothing. The JAX package pads an
epoch's step axis to a bucket to reuse compiled programs and skips the
padded steps; here only the real steps run.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from srl_zoo_tpu_torch.data.device_cache import gather_obs
from srl_zoo_tpu_torch.losses.registry import compute_total_loss
from srl_zoo_tpu_torch.models.srl_modules import SRLModules
from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
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
    return keys


def _inputs(model: SRLModules, store: Dict[str, torch.Tensor],
            batch: Dict[str, np.ndarray],
            generator: Optional[torch.Generator] = None) -> Dict:
    """The model's and the loss's inputs on the device: ``obs``,
    ``next_obs`` (None unless a loss reads it), ``pos_obs`` and
    ``neg_obs`` (None without the triplet loss), ``valid``, ``batch`` (the
    metadata tensors) and ``noise`` (the VAE's eps in train mode)."""
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
    return {"obs": obs, "next_obs": next_obs, "pos_obs": pos_obs,
            "neg_obs": neg_obs,
            "valid": upload(batch["valid"], dev, torch.float32),
            "batch": tensors, "noise": noise}


def _loss(model: SRLModules, inputs: Dict):
    outputs = model(inputs["obs"], inputs["next_obs"],
                    inputs["batch"].get("actions"), inputs["noise"],
                    inputs["pos_obs"], inputs["neg_obs"])
    return compute_total_loss(model.cfg, outputs, inputs["obs"],
                              inputs["valid"], model.parameters(),
                              inputs["batch"])


def train_step(model: SRLModules, optimizer: torch.optim.Optimizer,
               store: Dict[str, torch.Tensor], batch: Dict[str, np.ndarray],
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One update in train mode (BatchNorm batch statistics, running
    averages updated; the VAE's eps drawn from ``generator``). Returns
    the batch's metrics, on the device."""
    model.train()
    total, metrics = _loss(model, _inputs(model, store, batch, generator))
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def eval_step(model: SRLModules, store: Dict[str, torch.Tensor],
              batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The batch's metrics in eval mode (running statistics, the VAE's
    mu), no update."""
    model.eval()
    with torch.no_grad():
        return _loss(model, _inputs(model, store, batch))[1]
