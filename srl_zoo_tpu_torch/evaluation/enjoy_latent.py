"""Latent-space exploration: decoded sweeps of each state dimension (port
of ``srl_zoo_tpu/evaluation/enjoy_latent.py``).

For each of the first K state dims, the dim is swept across +-3 sigma of
the run's exported states, the other dims held at the mean state, and the
decoded frames make one row of ``latent_sweeps.png``. Every sweep is
decoded in one batched call on the device. It needs a run whose losses
include a decoder (autoencoder, vae).

    python -m srl_zoo_tpu_torch.evaluation.enjoy_latent \\
        --log-folder logs/<run> [--n-dims 8] [--n-steps 7] [--device cpu]

It runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from srl_zoo_tpu_torch import checkpoint as ckpt
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.srl_modules import SRLModules, slice_state
from srl_zoo_tpu_torch.ops.preproc import denormalize_images
from srl_zoo_tpu_torch.utils.device import resolve_device, use_strict_float32
from srl_zoo_tpu_torch.utils.misc import printGreen


def model_recon_slice(cfg: SRLConfig):
    """The state slice the decoder reads; ValueError for a run without
    a decoder."""
    if not cfg.use_decoder:
        raise ValueError("This run has no decoder (no reconstruction loss) "
                         "— latent exploration needs autoencoder/vae/dae")
    return cfg.recon_slice


def decode_states(cfg: SRLConfig, model: SRLModules,
                  states: np.ndarray) -> np.ndarray:
    """states (B, state_dim) -> decoded frames (B, H, W, C) in [0, 1],
    in one call of the eval-mode decoder on the model's device."""
    sl = model_recon_slice(cfg)
    dev = next(model.parameters()).device
    z = torch.from_numpy(np.asarray(states, np.float32)).to(dev)
    with torch.inference_mode():
        recon = model.eval().decoder(slice_state(z, sl)).permute(0, 2, 3, 1)
        return denormalize_images(recon, cfg.normalize_mode).cpu().numpy()


def latent_sweep_grid(cfg: SRLConfig, model: SRLModules, states: np.ndarray,
                      n_dims: int = 8, n_steps: int = 7) -> np.ndarray:
    """(n_dims, n_steps, H, W, C) decoded sweep around the mean state."""
    mean = states.mean(axis=0)
    std = states.std(axis=0) + 1e-8
    n_dims = min(n_dims, cfg.state_dim)
    sweeps = np.tile(mean, (n_dims * n_steps, 1))
    for d in range(n_dims):
        rows = slice(d * n_steps, (d + 1) * n_steps)
        sweeps[rows, d] = mean[d] + np.linspace(-3, 3, n_steps) * std[d]
    decoded = decode_states(cfg, model, sweeps)
    return decoded.reshape((n_dims, n_steps) + decoded.shape[1:])


def main(argv=None) -> str:
    from srl_zoo_tpu_torch.plotting import raster

    p = argparse.ArgumentParser(description="Decode latent-dimension sweeps")
    p.add_argument("--log-folder", type=str, required=True)
    p.add_argument("--n-dims", type=int, default=8)
    p.add_argument("--n-steps", type=int, default=7)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    use_strict_float32()

    cfg, model = ckpt.load_srl_model(args.log_folder, device)
    states = np.load(os.path.join(args.log_folder,
                                  "states_rewards.npz"))["states"]
    grid = latent_sweep_grid(cfg, model, states, args.n_dims, args.n_steps)
    n_dims, n_steps = grid.shape[:2]
    offsets = np.linspace(-3, 3, n_steps)
    img = raster.image_grid(
        [list(grid[d]) for d in range(n_dims)],
        [[f"{v:+.1f} sd" for v in offsets]] * n_dims,
        max(64, min(cfg.img_height, 112)),
        row_labels=[f"dim {d}" for d in range(n_dims)],
        title="Latent sweeps (rows: state dims, cols: -3 sd .. +3 sd)")
    out = os.path.join(args.log_folder, "latent_sweeps.png")
    raster.save_png(img, out)
    printGreen(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
