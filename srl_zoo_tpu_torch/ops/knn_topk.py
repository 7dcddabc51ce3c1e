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
ties to the lowest index as ``lax.top_k`` gives them. ``"blocked"``
(:func:`knn_topk_blocked`, plain tensor code on either device) walks the
references in tiles of ``BLOCK_TILE`` rows, keeps each tile's k smallest
and merges them into a running best k: the (Q, N) matrix is never whole,
one (Q, tile) block at a time is. chip_smoke.py phase 2c measures it
against the other two routes (PERF.md §6).

``knn_topk_sharded`` (port of ``srl_zoo_tpu/ops/knn_topk.py``
``knn_topk_sharded``) splits the references over the ranks of a process
group (parallel/mesh.py): each rank runs a route (the kernel by default)
on its block, offsets its indices, and the ranks' (Q, k) candidate
lists, all-gathered, are merged into the final k (``merge_topk``, which
takes any list of blocks, so one card can run it over several).
"""

from __future__ import annotations

import functools

import torch

from srl_zoo_tpu_torch.ops import _build
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.ops.pairwise import (pairwise_sqdist,
                                            pairwise_sqdist_plain)

MAX_K = 64
FUSED_IMPLS = ("auto", "pallas", "pallas_t")
_TQ, _TR = 64, 256  # query and reference tile of the kernel
BLOCK_TILE = 2048  # reference rows a step of the blocked route


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


def knn_topk_blocked(q: torch.Tensor, refs: torch.Tensor, k: int):
    """(dist, idx) (Q, k) by the blocked route (port of JAX's
    ``_topk_blocked``): for each tile of ``BLOCK_TILE`` references, the
    squared distances max(|q|^2 + |r|^2 - 2 q.r, 0) in float32 and the
    tile's k smallest; then the k smallest of the running best (at first
    k entries of the float32 maximum, index -1) followed by them. Every
    selection is a stable sort, so ties go to the running best, that is
    to the lowest column, as ``lax.top_k`` gives them."""
    q = q.to(torch.float32)
    refs = refs.to(torch.float32)
    qq = (q * q).sum(dim=1, keepdim=True)
    best_d = torch.full((q.shape[0], k), torch.finfo(torch.float32).max,
                        device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                        device=q.device)
    for off in range(0, refs.shape[0], BLOCK_TILE):
        rt = refs[off:off + BLOCK_TILE]
        d2 = torch.clamp(qq + (rt * rt).sum(dim=1)[None, :] - 2.0 * (q @ rt.T),
                         min=0.0)
        # a last tile of fewer than k rows gives fewer candidates: JAX's
        # padding columns would lose to the running best anyway
        td, ti = _smallest_k(d2, k)
        best_d, order = _smallest_k(torch.cat([best_d, td], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ti + off], dim=1), 1, order)
    return best_d, best_i


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
    device; the ``blocked`` route is tensor code on either device. Any
    other device raises."""
    if impl not in FUSED_IMPLS + ("full", "blocked"):
        raise ValueError(f"unknown impl {impl!r}")
    if not 1 <= k <= refs.shape[0]:
        raise ValueError(f"k={k} outside [1, {refs.shape[0]} reference "
                         "points]")
    if q.device != refs.device:
        raise ValueError(f"knn_topk: q on {q.device}, refs on {refs.device}")
    if impl == "full":
        return _smallest_k(pairwise_sqdist(q, refs), k)
    if impl == "blocked":
        return knn_topk_blocked(q, refs, k)
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


# a padding row of a reference block: never a nearest neighbour, and every
# distance to it (about D x PAD_COORD^2) stays finite in float32
PAD_COORD = 1e15


def reference_block(refs: torch.Tensor, blocks: int, i: int
                    ) -> tuple[torch.Tensor, int]:
    """(block i of ``blocks`` contiguous blocks of ceil(N / blocks) rows of
    ``refs``, padded with ``PAD_COORD`` rows; the global index of its first
    row)."""
    size = -(-refs.shape[0] // blocks)
    block = refs[i * size:(i + 1) * size]
    pad = size - block.shape[0]
    if pad:
        block = torch.cat([block, torch.full((pad, refs.shape[1]), PAD_COORD,
                                             dtype=refs.dtype,
                                             device=refs.device)])
    return block, i * size


def merge_topk(parts, k: int):
    """The k smallest of per-block candidate lists ``parts`` [(dist (Q,
    k_b), global idx (Q, k_b)), ...] in block order: (dist, idx) (Q, k),
    ascending, ties to the earlier block (the lower index, the blocks being
    contiguous and ascending)."""
    d = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([p[1] for p in parts], dim=1)
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(i, 1, order[:, :k])


def knn_topk_sharded(q: torch.Tensor, refs: torch.Tensor, k: int,
                     impl: str = "auto"):
    """(dist, idx) (Q, k) of ``knn_topk_with_dist(q, refs, k, impl)``, with
    the references split over the ranks: every rank passes the same ``q``
    and ``refs``, runs the route ``impl`` on its block, and the ranks'
    candidates are all-gathered and merged. With one rank, or blocks of
    fewer than k rows, it is the plain call."""
    w = mesh.world()
    if w == 1 or refs.shape[0] // w < k:
        return knn_topk_with_dist(q, refs, k, impl)
    block, start = reference_block(refs, w, mesh.rank())
    d, i = knn_topk_with_dist(q, block, k, impl)
    ds = mesh.all_gather_rows(d[None])
    is_ = mesh.all_gather_rows((i + start)[None])
    return merge_topk(list(zip(ds, is_)), k)
