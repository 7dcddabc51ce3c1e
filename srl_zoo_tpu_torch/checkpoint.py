"""Run-folder checkpoints (port of ``srl_zoo_tpu/training/checkpoint.py``).

* The trained-model contract: ``srl_model.pth`` (the ``torch.save`` of the
  SRLModules state dict, the reference's file name) beside
  ``exp_config.json``. ``save_srl_model`` / ``load_srl_model``.
* Full-state resume checkpoints: ``checkpoints/state_latest.pth`` holds the
  model, the optimizer, the state of the generator that draws the VAE's
  noise, the step, the epochs completed and the best validation loss so
  far, and ``checkpoints/meta.json`` the last three, so
  that ``--resume`` continues a run where it stopped. The JAX package
  writes these on a background thread; here the writes are synchronous.

Every write goes to a temporary file that then replaces the target, so a
reader (a server, a resumed run) never sees a torn file.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.srl_modules import SRLModules

MODEL_FILE = "srl_model.pth"
RESUME_DIR = "checkpoints"
STATE_FILE = "state_latest.pth"


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def write_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def save_srl_model(log_folder: str, model: SRLModules,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> str:
    """exp_config.json and srl_model.pth of ``model`` (or of the given
    state dict of a model of the same config)."""
    os.makedirs(log_folder, exist_ok=True)
    model.cfg.save(log_folder)
    path = os.path.join(log_folder, MODEL_FILE)
    write_state_dict(path, model.state_dict() if state_dict is None
                     else state_dict)
    return path


def read_state_dict(log_folder: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(log_folder, MODEL_FILE),
                      map_location="cpu", weights_only=True)


def load_srl_model(log_folder: str, device: torch.device
                   ) -> Tuple[SRLConfig, SRLModules]:
    """Rebuild the model from exp_config.json and load its weights, in eval
    mode on ``device`` with channels_last activations."""
    cfg = SRLConfig.load(log_folder)
    model = SRLModules(cfg)
    model.load_state_dict(read_state_dict(log_folder))
    model = model.to(device=device, memory_format=torch.channels_last)
    return cfg, model.eval()


def save_train_state(log_folder: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     generator: torch.Generator, step: int, epoch: int,
                     best_val: float) -> str:
    """The resume checkpoint after ``epoch`` completed epochs."""
    ckpt_dir = os.path.join(log_folder, RESUME_DIR)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, STATE_FILE)
    _atomic_save({"model": model.state_dict(),
                  "optimizer": optimizer.state_dict(),
                  "generator": generator.get_state(), "step": int(step),
                  "epoch": int(epoch), "best_val": float(best_val)}, path)
    meta = {"step": int(step), "epoch": int(epoch)}
    if best_val != float("inf"):
        meta["best_val"] = float(best_val)
    meta_path = os.path.join(ckpt_dir, "meta.json")
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".tmp", meta_path)
    return path


def load_meta(log_folder: str) -> dict:
    path = os.path.join(log_folder, RESUME_DIR, "meta.json")
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return {}  # a torn meta must not break crash recovery


def restore_train_state(log_folder: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        generator: torch.Generator) -> Optional[dict]:
    """Load the resume checkpoint into ``model``, ``optimizer`` and
    ``generator`` (a checkpoint written before the generator was kept
    leaves it at its seed); returns
    {"step", "epoch", "best_val"}, or None when there is nothing to
    resume."""
    path = os.path.join(log_folder, RESUME_DIR, STATE_FILE)
    if not os.path.exists(path):
        return None
    dev = next(model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    try:
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
        if "generator" in ckpt:
            # a generator's state is a CPU byte tensor on every device
            generator.set_state(ckpt["generator"].cpu())
    except (RuntimeError, ValueError, KeyError) as e:
        raise ValueError(
            f"Resume checkpoint in {log_folder} does not match the current "
            "model and optimizer. --resume requires the SAME model and "
            "optimizer flags as the original run (--model-type, --losses, "
            f"--state-dim, ...); underlying error: {type(e).__name__}: {e}"
        ) from e
    return {k: ckpt[k] for k in ("step", "epoch", "best_val")}
