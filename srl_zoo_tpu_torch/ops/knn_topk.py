"""k nearest references by squared L2 distance: fused distance + top-k.

Kernel: ``csrc/knn_topk.cu``, which replaces the TPU kernels
``srl_zoo_tpu/ops/knn_topk.py`` ``_topk_pallas_t`` (``_knn_kernel_t``, the
TPU default for k <= 8) and ``_topk_pallas`` (``_knn_kernel``, k <= 64).
It is bound by float32 operations on the H100 (2*Q*N*D multiply-adds);
the source note says how the design meets that.

    d2[q, j] = max(|q|^2 + |r_j|^2 - 2 q.r_j, 0)
    returns the k smallest (d2, j) per query, ascending, ties to the lowest j

The (Q, N) distance matrix never reaches device memory: each block keeps
its distances in registers and each query's running best-k in shared
memory, and a last pass merges the lists of the blocks that split N. The
wrapper sizes the split from the kernel's occupancy on the card
(:func:`split_plan`).

``impl`` names the JAX package's routes. ``"auto"``, ``"pallas"`` and
``"pallas_t"`` take the fused kernel (one CUDA kernel serves the two TPU
layouts). ``"full"`` writes the (Q, N) matrix with the pairwise kernel
(K4, ops/pairwise.py) and keeps each row's k smallest with a stable sort,
ties to the lowest index as ``lax.top_k`` gives them.
"""

from __future__ import annotations

import functools

import torch

from srl_zoo_tpu_torch.ops import _build
from srl_zoo_tpu_torch.ops.pairwise import (pairwise_sqdist,
                                            pairwise_sqdist_plain)

MAX_K = 64
FUSED_IMPLS = ("auto", "pallas", "pallas_t")
_TQ, _TR = 64, 256  # query and reference tile of the kernel


def knn_topk_plain(q: torch.Tensor, refs: torch.Tensor, k: int,
                   query_chunk: int = 4096):
    """Plain PyTorch version: chunked product, stable sort cut to k (the
    stable sort gives ties to the lowest index; torch.topk promises no tie
    order)."""
    parts = [_smallest_k(pairwise_sqdist_plain(q[s:s + query_chunk], refs), k)
             for s in range(0, q.shape[0], query_chunk)]
    if not parts:
        return (torch.zeros((0, k), device=q.device),
                torch.zeros((0, k), dtype=torch.int64, device=q.device))
    return torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts])


def _smallest_k(d2: torch.Tensor, k: int):
    """Each row's k smallest (value, column), ascending, ties to the lowest
    column."""
    d, i = torch.sort(d2, dim=1, stable=True)
    return d[:, :k], i[:, :k]


def split_plan(q_tiles: int, r_tiles: int, sms: int,
               blocks_per_sm: int) -> tuple[int, int]:
    """(splits, tiles_per_split) of the kernel's reference range.

    ``q_tiles`` x splits blocks run ``blocks_per_sm`` at a time on each of
    ``sms`` SMs: the splits are as many as fill those slots once (at least
    one, at most one per reference tile), the tiles are shared out evenly,
    and no split is empty."""
    splits = max(1, min(sms * blocks_per_sm // q_tiles, r_tiles))
    tiles = -(-r_tiles // splits)
    return -(-r_tiles // tiles), tiles


@functools.lru_cache(maxsize=256)
def _blocks_per_sm(device_index: int, d: int, k: int) -> int:
    """Resident blocks per SM of the kernel instance that (d, k) selects,
    as the CUDA runtime reports it from registers and shared memory."""
    with torch.cuda.device(device_index):
        nb = _build.entry("knn_topk", "srl_knn_blocks_per_sm")(d, k)
    if nb < 1:
        raise _build.KernelLaunchError(f"knn_topk: no block of the kernel "
                                       f"fits an SM at D={d}, k={k} "
                                       f"(CUDA error {-nb})")
    return nb


def knn_topk_with_dist(q: torch.Tensor, refs: torch.Tensor, k: int,
                       impl: str = "auto"):
    """(distances (Q, k) float32, indices (Q, k) int64), ascending.

    The fused route launches its kernel for CUDA tensors (k <= ``MAX_K``)
    and takes :func:`knn_topk_plain` for CPU tensors (any k); the ``full``
    route goes through :func:`pairwise_sqdist`, which does the same per
    device. Any other device raises."""
    if impl == "blocked":
        raise NotImplementedError(
            "knn_topk impl 'blocked' is not ported yet: ROADMAP.md queue A "
            "item 10 'the measured alternatives'")
    if impl not in FUSED_IMPLS + ("full",):
        raise ValueError(f"unknown impl {impl!r}")
    if not 1 <= k <= refs.shape[0]:
        raise ValueError(f"k={k} outside [1, {refs.shape[0]} reference "
                         "points]")
    if q.device != refs.device:
        raise ValueError(f"knn_topk: q on {q.device}, refs on {refs.device}")
    if impl == "full":
        return _smallest_k(pairwise_sqdist(q, refs), k)
    if q.device.type == "cpu":
        return knn_topk_plain(q, refs, k)
    if q.device.type != "cuda":
        raise ValueError(f"knn_topk: no kernel for device {q.device}")
    if k > MAX_K:
        raise ValueError(f"knn_topk: the kernel takes k <= {MAX_K}, got {k}")
    if q.dim() != 2 or refs.dim() != 2 or q.shape[1] != refs.shape[1]:
        raise ValueError(f"knn_topk: expected (Q, D) and (N, D), got "
                         f"{tuple(q.shape)} and {tuple(refs.shape)}")
    q = q.to(torch.float32).contiguous()
    refs = refs.to(torch.float32).contiguous()
    nq, d = q.shape
    n = refs.shape[0]
    if d == 0:
        raise ValueError("knn_topk: zero-width points")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out_d, out_i.to(torch.int64)
    dev = q.get_device()
    q_tiles, r_tiles = -(-nq // _TQ), -(-n // _TR)
    splits, tiles = split_plan(q_tiles, r_tiles, _build.sm_count(dev),
                               _blocks_per_sm(dev, d, k))
    norms = torch.empty(q_tiles * _TQ + r_tiles * _TR, dtype=torch.float32,
                        device=q.device)
    part_d = torch.empty((nq, splits, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=q.device)
    code = _build.launch(_build.entry("knn_topk"), q, q.data_ptr(),
                         refs.data_ptr(), norms.data_ptr(), part_d.data_ptr(),
                         part_i.data_ptr(), out_d.data_ptr(),
                         out_i.data_ptr(), nq, n, d, k, splits, tiles)
    _build.check(code, "knn_topk")
    knn_topk_with_dist.launches += 1
    return out_d, out_i.to(torch.int64)


knn_topk_with_dist.launches = 0


def knn_topk(q: torch.Tensor, refs: torch.Tensor, k: int,
             impl: str = "auto") -> torch.Tensor:
    """Indices (Q, k) int64 of each query's k nearest references."""
    return knn_topk_with_dist(q, refs, k, impl)[1]
