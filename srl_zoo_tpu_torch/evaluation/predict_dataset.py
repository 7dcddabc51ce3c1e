"""Export states for a whole dataset (port of
``srl_zoo_tpu/evaluation/predict_dataset.py`` and the learner's
``predict_states``).

Rows of a device-resident store (data/device_cache.py) are index batches
through the gather kernel (gather + normalize; one gather per camera view
where the config stacks both, as training does) and the encoder. Without a
store the rows stream: the loader's uint8 batches go up
(data/transfer.py) and the gather kernel normalizes them over the
identity index. A hybrid store (data/hybrid.py) encodes its resident rows
by slot and streams the rest, and the states come back in the caller's
order. The CLI picks the store as training does (``--device-cache`` of the
run's config) and writes ``states_rewards.npz``, the hand-off artifact
for downstream RL.

In a process group (parallel/mesh.py) each rank encodes its rows of every
export batch, from the store (whole, sharded or hybrid, which the ranks
read in step) or streamed (the loader fetches this rank's rows only), and
the states are gathered to every rank, as JAX's export shards its batches
over the mesh and gathers them across processes.

    python -m srl_zoo_tpu_torch.evaluation.predict_dataset \\
        --log-folder logs/<run> [--data-folder data/<ds>] [-n N]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from srl_zoo_tpu_torch.data.device_cache import gather_obs, open_store
from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
from srl_zoo_tpu_torch.data.schema import (Dataset, load_dataset,
                                           save_states_rewards)
from srl_zoo_tpu_torch.data.transfer import stream_batches
from srl_zoo_tpu_torch.inference import StateEncoder
from srl_zoo_tpu_torch.ops.sharded_store import ShardedStore
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.training.train_step import normalize_streamed


BATCH = 256  # rows per export batch


def predict_states(encoder: StateEncoder, store,
                   indices: Optional[np.ndarray] = None) -> np.ndarray:
    """(len(indices), state_dim) float32 states of rows of the resident
    store (data/device_cache.py; all rows when ``indices`` is None)."""
    sharded = isinstance(store, ShardedStore)
    device = store.device if sharded else store["frames"].device
    if device != encoder.device:
        raise ValueError(f"frame store on {device}, encoder on "
                         f"{encoder.device}")
    if indices is None:
        indices = np.arange(store.rows if sharded
                            else store["frames"].shape[0])
    # host index slices and states kept on the device until the end: the
    # batches queue without a synchronise between them
    idx = np.asarray(indices, np.int64)
    out = []
    with torch.inference_mode():
        for start in range(0, len(idx), BATCH):
            rows = idx[start:start + BATCH]
            x = gather_obs(store, mesh.pad_to_world(rows), encoder.cfg)
            out.append(mesh.all_gather_rows(
                encoder.model.encode(x))[:len(rows)])
    if not out:
        return np.zeros((0, encoder.cfg.state_dim), np.float32)
    return torch.cat(out).cpu().numpy()


def predict_streamed(encoder: StateEncoder, dataset: Dataset,
                     indices: Optional[np.ndarray] = None) -> np.ndarray:
    """(len(indices), state_dim) float32 states of dataset rows streamed
    from the host (all rows when ``indices`` is None), in that order. In a
    process group the export batch is a multiple of the world size (the
    loader pads the last one), and each rank encodes its rows of it."""
    cfg, dev = encoder.cfg, encoder.device
    idx = np.arange(dataset.n_samples) if indices is None \
        else np.asarray(indices)
    if len(idx) == 0:
        return np.zeros((0, cfg.state_dim), np.float32)
    flags = {k: v for k, v in batch_flags(cfg).items()
             if k in ("stack_views", "img_hw", "num_threads")}
    loader = DataLoader(dataset, idx, BATCH + (-BATCH) % mesh.world(),
                        shuffle=False, wraparound=False, emit_images=True,
                        pin_memory=dev.type == "cuda", **flags)
    out = []
    with torch.inference_mode():
        for batch in stream_batches(loader, dev, cfg.stream_overlap):
            states = mesh.all_gather_rows(encoder.model.encode(
                normalize_streamed(batch["obs"], cfg.normalize_mode, dev)))
            out.append(states[:int(batch["valid"].sum())])
    return torch.cat(out).cpu().numpy()


def predict_dataset(encoder: StateEncoder, dataset: Dataset, store,
                    hot_store=None,
                    indices: Optional[np.ndarray] = None) -> np.ndarray:
    """States of dataset rows (all when ``indices`` is None) in that order,
    from the whole ``store``, streamed (``store`` None), or from a hybrid
    store: the resident rows by slot, the rest streamed."""
    if store is None:
        return predict_streamed(encoder, dataset, indices)
    if hot_store is None:
        return predict_states(encoder, store, indices)
    idx = np.arange(dataset.n_samples) if indices is None \
        else np.asarray(indices)
    hot = hot_store.resident_mask(idx)
    states = np.empty((len(idx), encoder.cfg.state_dim), np.float32)
    states[hot] = predict_states(encoder, store, hot_store.slots(idx[hot]))
    states[~hot] = predict_streamed(encoder, dataset, idx[~hot])
    return states


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
    store, hot_store = open_store(dataset, encoder.cfg, encoder.device,
                                  second_view=encoder.cfg.stack_views)
    indices = None
    if args.n_samples > 0:
        indices = np.arange(min(args.n_samples, dataset.n_samples))
    states = predict_dataset(encoder, dataset, store, hot_store, indices)
    rewards = dataset.rewards if indices is None else dataset.rewards[indices]
    path = save_states_rewards(args.log_folder, states, rewards)
    print(f"Saved {path} ({states.shape})")
    return path


if __name__ == "__main__":
    main()
