"""Shared pieces of the card tests (``test_torch_zoo_card_*.py`` and
``test_torch_zoo_epoch_card.py``): the ``cuda`` fixture, the BASELINE
configs at config 1's width, the kernels' launch counters, the near-tie
rule of the top-k checks and the two-camera training dataset.

The ``cuda`` fixture skips without a CUDA device and every fixture that
builds data depends on it, so on a machine without a GPU the card tests
skip before any dataset or kernel is built. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

IMG = (224, 224, 3)
STATE_DIM = 200
BATCH = 32  # config 1's batch, and the serve batch
SEED = 0
N_FRAMES = 20_000  # the inference path's store
KNN_QUERIES = 4096
POOLS = (IMG[0] // 2, IMG[0] // 8, IMG[0] // 32)  # 112, 28, 7 at 224
TRAIN_FRAMES = 4096
TRAIN_EPISODES = 16
HYBRID_ROWS = TRAIN_FRAMES // 2  # a hybrid store's resident rows, about half
RESNET_VIEWS = {"model_type": "resnet", "multi_view": True}
BF16 = {"compute_dtype": "bfloat16"}
# BASELINE configs 1-5: name, --losses tokens, epochs of the train CLI (30
# in the configs, cut to keep a card run short) and the config's other
# fields; then the 6-channel input of --multi-view without triplet
TRAIN_CONFIGS = (
    ("autoencoder", ("autoencoder",), 3, {}),
    ("vae", ("vae",), 2, {}),
    ("priors", ("priors",), 2, {}),
    ("splits", ("autoencoder:1:100", "inverse:2:50", "forward:1:25",
                "reward:1:25"), 2, {}),
    ("triplet", ("triplet",), 2, RESNET_VIEWS),
    ("multiview", ("priors",), 2, RESNET_VIEWS),
)
# configs 1 and 5 at --dtype bfloat16 and the dense model types. The
# dense runs take lr 1e-4: Adam moves each weight of their first Dense,
# 150,528 raw pixels wide, by about lr a step, so at 5e-3 the linear map
# runs away under the priors and the mlp's ReLUs die
DENSE_LR = 1e-4
BF16_DENSE_CONFIGS = (
    ("autoencoder-bf16", ("autoencoder",), 2, BF16),
    ("triplet-bf16", ("triplet",), 2, {**RESNET_VIEWS, **BF16}),
    ("mlp", ("autoencoder",), 2, {"model_type": "mlp",
                                  "learning_rate": DENSE_LR}),
    ("linear", ("priors",), 2, {"model_type": "linear",
                                "learning_rate": DENSE_LR}),
)
# the rest of the loss zoo at config 1's width (epochs 0: the step check
# alone); ``path_to_dae`` names the run of this list that it reads
ZOO_CONFIGS = (
    ("dae", ("dae",), 2, {}),
    ("dae-gaussian", ("dae",), 0, {"noise_type": "gaussian"}),
    ("perceptual", ("perceptual",), 2, {"path_to_dae": "dae"}),
    ("episode-prior", ("episode-prior", "autoencoder"), 2,
     {"episode_prior_optimizer": "separate"}),
    ("reward-prior", ("reward-prior", "autoencoder"), 2, {}),
    # the ground truth is 2 wide: the supervised loss reads a 2-wide slice
    ("supervised", ("supervised:1:2", f"autoencoder:1:{STATE_DIM - 2}"), 2,
     {}),
    ("grad-accum", ("autoencoder",), 2, {"grad_accum": 4}),
    ("random", ("random",), 2, {}),
)
ALL_CONFIGS = TRAIN_CONFIGS + BF16_DENSE_CONFIGS + ZOO_CONFIGS
POOL_KERNELS = ("relu_max_pool", "relu_max_pool_bwd")
# the names of K1f's, K1b's and K2's kernels in a profiler trace
TRACED = {"relu_max_pool": "relu_max_pool_fwd",
          "relu_max_pool_bwd": "relu_max_pool_bwd",
          "gather_normalize": "gather_norm_kernel"}


@pytest.fixture(scope="session")
def cuda():
    """The first CUDA device, float32 convolutions in full float32 (as
    the port's entry points run them); skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from srl_zoo_tpu_torch.utils.device import use_strict_float32
    use_strict_float32()
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def train_data(cuda, tmp_path_factory) -> str:
    """The folder of ``write_train_dataset``, written once a session:
    every module that asks finds the first one's."""
    folder = tmp_path_factory.getbasetemp() / "train_data"
    if not (folder / "done").exists():
        write_train_dataset(str(folder))
        (folder / "done").touch()
    return str(folder)


def train_config(tokens, batch_size: int = BATCH, model_kw=None):
    """SRLConfig of a --losses token list at config 1's width (4 actions,
    2 reward classes, as the training dataset), with the fields of
    ``model_kw`` (custom_cnn on one view if empty)."""
    from srl_zoo_tpu_torch.config import SRLConfig, parse_loss_arguments
    losses, splits = parse_loss_arguments(list(tokens), STATE_DIM)
    return SRLConfig(state_dim=STATE_DIM, img_height=IMG[0],
                     img_width=IMG[1], batch_size=batch_size, seed=SEED,
                     losses=tuple(losses.items()),
                     split_dims=tuple(splits.items()), n_actions=4,
                     n_reward_classes=2, **(model_kw or {}))


def kernel_counters() -> dict:
    """Each kernel's wrapper by name: the launch counts live on them."""
    from srl_zoo_tpu_torch.ops import (fused_pool, gather_norm, knn_topk,
                                       pairwise)
    return {"relu_max_pool": fused_pool.relu_max_pool,
            "relu_max_pool_bwd": fused_pool.relu_max_pool_bwd,
            "gather_normalize": gather_norm.gather_normalize,
            "knn_topk": knn_topk.knn_topk_with_dist,
            "pairwise_sqdist": pairwise.pairwise_sqdist}


@contextlib.contextmanager
def launches():
    """Zeroes every kernel's launch counters; the dict it yields holds,
    once the block has ended, the launches by kernel and the pools'
    bfloat16 launches under ``<kernel>/bf16``. Fails unless every launch
    of a kernel with a vector path (K1f, K1b, K2) took it."""
    counters = kernel_counters()
    for c in counters.values():
        for name in ("launches", "vector_launches", "bf16_launches"):
            if hasattr(c, name):
                setattr(c, name, 0)
    out = {}
    yield out
    out.update({k: c.launches for k, c in counters.items()})
    out.update({f"{k}/bf16": c.bf16_launches for k, c in counters.items()
                if hasattr(c, "bf16_launches")})
    vector = {k: c.vector_launches for k, c in counters.items()
              if hasattr(c, "vector_launches")}
    assert all(vector[k] == out[k] for k in vector), (
        f"a launch took the scalar path: {vector} of {out}")


def assert_no_sync(calls) -> None:
    """Each of the (name, call) ``calls`` under
    ``torch.cuda.set_sync_debug_mode("error")``, after showing that the
    mode catches a pageable upload."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones(4).to("cuda")
        for what, call in calls:
            try:
                call()
            except RuntimeError as e:
                raise AssertionError(f"{what} synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def near_ties(q, refs, got, want, rtol: float) -> None:
    """Fails unless each index where two top-k results of ``q`` among
    ``refs`` differ is a tie within ``rtol`` in float64 distances."""
    qi, slot = (got != want).nonzero(as_tuple=True)
    qv = q[qi].double()
    da = ((refs[got[qi, slot]].double() - qv) ** 2).sum(1)
    db = ((refs[want[qi, slot]].double() - qv) ** 2).sum(1)
    far = (da - db).abs() > rtol * torch.maximum(da, db)
    assert not bool(far.any()), (
        f"queries {qi[far].tolist()[:8]} pick neighbours farther than a "
        f"near tie: {da[far].tolist()[:8]} vs {db[far].tolist()[:8]}")


def write_train_dataset(folder: str) -> None:
    """A two-camera dataset folder of TRAIN_FRAMES 224x224x3 frames in
    TRAIN_EPISODES episodes: a red square walks on a shaded background,
    and its centre (scaled to [0, 1]) is the ground truth; a reward of 1
    near the middle. The second view (``frames_2.npy``) is the scene
    mirrored left to right in other colours. View 1's frames are also
    written as the JPEGs that ``images_path`` names (cv2), which the
    KNN-MSE neighbour grids decode."""
    import cv2
    rng = np.random.RandomState(SEED)
    n, (h, w, c) = TRAIN_FRAMES, IMG
    ep_len = n // TRAIN_EPISODES
    actions = rng.randint(0, 4, n).astype(np.int32)
    moves = np.array([[0, 6], [0, -6], [6, 0], [-6, 0]])
    pos = np.empty((n, 2))
    for e in range(TRAIN_EPISODES):
        s = slice(e * ep_len, (e + 1) * ep_len)
        walk = rng.uniform(40, h - 40, 2) + np.cumsum(moves[actions[s]], 0)
        pos[s] = np.clip(walk, 14, h - 15)
    starts = np.zeros(n, bool)
    starts[::ep_len] = True
    gt = (pos / h).astype(np.float32)
    rewards = (np.abs(gt - 0.5).max(axis=1) < 0.1).astype(np.float32)
    os.makedirs(folder, exist_ok=True)
    np.savez(os.path.join(folder, "preprocessed_data.npz"), actions=actions,
             rewards=rewards, episode_starts=starts)
    np.savez(os.path.join(folder, "ground_truth.npz"),
             ground_truth_states=gt,
             images_path=np.array([f"frame{i:06d}.jpg" for i in range(n)]))
    yy = np.arange(h)[None, :, None]
    xx = np.arange(w)[None, None, :]
    views = (("frames", (60, 80, 40), (220, 40, 40), pos),
             ("frames_2", (90, 50, 70), (40, 200, 60),
              np.stack([pos[:, 0], w - 1 - pos[:, 1]], axis=1)))
    for name, (base, dy, dx), colour, p_all in views:
        frames = np.lib.format.open_memmap(
            os.path.join(folder, f"{name}.npy"), mode="w+", dtype=np.uint8,
            shape=(n, h, w, c))
        shade = (base + dy * yy / h + dx * xx / w).astype(np.uint8)[0]
        for s in range(0, n, 256):
            p = p_all[s:s + 256]
            sq = (np.abs(yy - p[:, 0, None, None]) < 12) & \
                (np.abs(xx - p[:, 1, None, None]) < 12)
            block = np.empty((len(p), h, w, c), np.uint8)
            block[:] = shade[None, :, :, None]
            block[sq] = colour
            frames[s:s + 256] = block
            if name == "frames":
                for i, frame in enumerate(block, s):
                    if not cv2.imwrite(os.path.join(
                            folder, f"frame{i:06d}.jpg"), frame[..., ::-1]):
                        raise OSError(f"could not write frame {i}")
        frames.flush()
        del frames
