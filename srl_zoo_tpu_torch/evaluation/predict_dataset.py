"""Export states for a whole dataset from the device-resident frame store.

Port of ``srl_zoo_tpu/evaluation/predict_dataset.py`` and the learner's
``predict_states``: index batches into the resident uint8 store go through
the gather kernel (gather + normalize; one gather per camera view where the
config stacks both, as training does) and the encoder; the states are
written to ``states_rewards.npz``, the hand-off artifact for downstream RL.

    python -m srl_zoo_tpu_torch.evaluation.predict_dataset \\
        --log-folder logs/<run> [--data-folder data/<ds>] [-n N]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from srl_zoo_tpu_torch.data.device_cache import build_cache, gather_obs
from srl_zoo_tpu_torch.data.schema import load_dataset, save_states_rewards
from srl_zoo_tpu_torch.inference import StateEncoder


BATCH = 256  # rows per export batch


def predict_states(encoder: StateEncoder, store: Dict[str, torch.Tensor],
                   indices: Optional[np.ndarray] = None) -> np.ndarray:
    """(len(indices), state_dim) float32 states of rows of the resident
    store (data/device_cache.py; all rows when ``indices`` is None)."""
    frames = store["frames"]
    if frames.device != encoder.device:
        raise ValueError(f"frame store on {frames.device}, encoder on "
                         f"{encoder.device}")
    if indices is None:
        indices = np.arange(frames.shape[0])
    # host index slices and states kept on the device until the end: the
    # batches queue without a synchronise between them
    idx = np.asarray(indices, np.int64)
    out = []
    with torch.inference_mode():
        for start in range(0, len(idx), BATCH):
            x = gather_obs(store, idx[start:start + BATCH], encoder.cfg)
            out.append(encoder.model.encode(x))
    if not out:
        return np.zeros((0, encoder.cfg.state_dim), np.float32)
    return torch.cat(out).cpu().numpy()


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Predict states for a dataset "
                                            "with a trained model")
    p.add_argument("--log-folder", type=str, required=True)
    p.add_argument("--data-folder", type=str, default="",
                   help="Defaults to the training dataset from exp_config")
    p.add_argument("-n", "--n-samples", type=int, default=-1,
                   help="Only predict the first N samples (-1 = all)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    encoder = StateEncoder.load(args.log_folder, device=args.device)
    dataset = load_dataset(args.data_folder or encoder.cfg.data_folder)
    store = build_cache(dataset, encoder.device, encoder.cfg.stack_views)
    indices = None
    if args.n_samples > 0:
        indices = np.arange(min(args.n_samples, dataset.n_samples))
    states = predict_states(encoder, store, indices)
    rewards = dataset.rewards if indices is None else dataset.rewards[indices]
    path = save_states_rewards(args.log_folder, states, rewards)
    print(f"Saved {path} ({states.shape})")
    return path


if __name__ == "__main__":
    main()
