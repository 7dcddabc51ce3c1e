"""Data parallelism over ``torch.distributed``, one process per GPU (the
port's counterpart of ``srl_zoo_tpu/parallel/mesh.py``).

JAX runs one process over an N-device mesh and shards each batch's leading
axis over it (``shard_batch``: contiguous blocks of B/N rows, in device
order). The port runs N processes instead, one per GPU (``nccl``) or, on
the CPU, one per ``gloo`` rank, joined by :func:`initialize_distributed`.
Every rank draws the same global batch from the same seed and computes
its contiguous block of B/world rows (:func:`shard_rows`), rank 0 first.

The collectives the data-parallel step needs live here, each counted in
:data:`counts` where it is issued:

* :func:`all_reduce_sum`: a sum over the ranks, in place (BatchNorm's
  global batch statistics and the global sums of its backward);
* :func:`gather_rows`: the ranks' row blocks joined into the global batch,
  with a gradient (the losses' state-sized inputs, whose partner rows may
  live on another rank); its backward sums the ranks' gradients and keeps
  this rank's rows;
* :func:`all_gather_rows`: the same without a gradient (exported states,
  the sharded top-k's candidates);
* :func:`reduce_scatter_rows`: the sharded store's gather;
* :func:`average_gradients`: one flat all-reduce of the parameters'
  gradients, divided by the world size.

Without a process group every helper is the identity of world size 1 and
issues nothing. A group of world size 1 (one GPU, ``--coordinator-address``
given) takes the collective paths all the same, so that they can be
exercised on one card.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np
import torch
import torch.distributed as dist

# collectives issued through this module since the counts were zeroed
counts: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                          "reduce_scatter": 0}


def active() -> bool:
    """Whether a process group is up (the data-parallel paths are taken)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, device: torch.device) -> None:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator_address`` (``host:port``): ``nccl`` for a
    CUDA device (which becomes the process's current device), ``gloo`` on
    the CPU."""
    if not coordinator_address:
        raise ValueError("--coordinator-address host:port is needed to "
                         "start a process group")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} outside [0, "
                         f"{num_processes})")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if active():
        dist.destroy_process_group()


def rank_folder(run_folder: str) -> str:
    """Where this rank writes: the run folder on rank 0, which owns the
    run's artifacts; ``<run>/.proc<i>`` on rank i."""
    r = rank()
    return run_folder if r == 0 else os.path.join(run_folder, f".proc{r}")


def check_batch_size(batch_size: int, what: str = "--batch-size") -> None:
    """A global batch must split into equal row blocks: JAX replicates a
    batch its mesh does not divide, and the port cannot."""
    w = world()
    if batch_size % w:
        raise ValueError(f"{what} {batch_size} is not divisible by the "
                         f"world size {w}: each rank computes B/world rows")


def shard_rows(x):
    """This rank's contiguous block of the leading axis of ``x`` (numpy or
    a tensor), as ``shard_batch`` lays a batch over a mesh."""
    w = world()
    if w == 1:
        return x
    n = x.shape[0]
    check_batch_size(n, "a batch of")
    b = n // w
    r = rank()
    return x[r * b:(r + 1) * b]


def _all_gather_into(out: torch.Tensor, t: torch.Tensor) -> None:
    # torch 2.13 names the one-tensor collectives all_gather_single and
    # reduce_scatter_single and deprecates the older names, which are all
    # that earlier releases have
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t.contiguous())
    counts["all_gather"] += 1


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' equal row blocks joined in rank order, no gradient."""
    if not active():
        return t
    out = t.new_empty((world() * t.shape[0],) + tuple(t.shape[1:]))
    _all_gather_into(out, t)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; no gradient."""
    if active():
        dist.all_reduce(t)
        counts["all_reduce"] += 1
    return t


# torch.distributed.nn.functional's all_gather computes the same gradient,
# but torch 2.13 deprecates it with a FutureWarning on every call (the
# replacement, _functional_collectives, is private)
class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.rows = t.shape[0]
        return all_gather_rows(t)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the whole gathered tensor, so this rank's
        # rows take the sum of all ranks' gradients
        g = all_reduce_sum(g.clone(memory_format=torch.contiguous_format))
        r = rank()
        return g[r * ctx.rows:(r + 1) * ctx.rows]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank row block, with a gradient."""
    return _GatherRows.apply(t) if active() else t


def reduce_scatter_rows(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t`` (B, ...), of which this rank keeps
    its block of B/world rows."""
    if not active():
        return t
    out = t.new_empty((t.shape[0] // world(),) + tuple(t.shape[1:]))
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, t.contiguous())
    counts["reduce_scatter"] += 1
    return out


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Each parameter's ``.grad`` replaced by its mean over the ranks, in
    one all-reduce of the gradients laid end to end. A parameter without a
    gradient stays without one (every rank runs the same graph, so the
    same parameters have one on every rank)."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    flat /= world()
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


def pad_to_world(idx: np.ndarray) -> np.ndarray:
    """``idx`` padded with its first entry (row 0 where it is empty) to a
    multiple of the world size; the caller keeps the first len(idx)
    results."""
    pad = (-len(idx)) % world()
    if not pad:
        return idx
    fill = idx[0] if len(idx) else 0
    return np.concatenate([idx, np.full(pad, fill, idx.dtype)])


def zero_counts() -> None:
    for k in counts:
        counts[k] = 0
