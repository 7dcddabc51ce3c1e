"""Host-to-device transfer of streamed batches (the JAX learner's
``_sharded_stream``).

A streamed batch's uint8 pixels (``obs``, ``next_obs``, ``pos_obs``,
``neg_obs``) come from the loader in pinned host memory (data/loader.py,
``pin_memory``) and are copied to the device with ``non_blocking=True``;
the rest of the batch stays on the host (the step uploads the metadata
it reads). The pixels stay uint8 on the device: the step normalizes them
with the gather kernel (training/train_step.py), and the hybrid store
adopts rows from them (data/hybrid.py).

Without ``overlap`` each copy is queued on the compute stream, behind the
step before it. With ``overlap`` (``--stream-overlap``) batch k + 1's copy
is queued before step k is dispatched, on a copy stream of its own; the
compute stream waits on an event recorded after the copy, and each copied
tensor is recorded on the compute stream, so the caching allocator does
not hand its memory to a later copy while a step still reads it. The
pinned source of a copy is never written again: each batch has its own,
and PyTorch's caching host allocator reuses it only after its copy is done.
In a process group the pixels are this rank's rows of the batch
(data/loader.py); the hybrid store's adoption all-gathers them from every
rank (data/hybrid.py), on the compute stream after the event wait, as
every other read of the batch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator

import torch

from srl_zoo_tpu_torch.data.loader import IMAGE_KEYS


def _start_copy(batch: Dict, device: torch.device, stream):
    """(batch with its pixels on ``device``, event after their copy or
    None): the copies queued on ``stream`` (None: the current stream)."""
    out = dict(batch)
    if device.type != "cuda":
        for k in IMAGE_KEYS:
            if k in out:
                out[k] = torch.as_tensor(out[k]).to(device)
        return out, None
    with torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext():
        for k in IMAGE_KEYS:
            if k in out:
                src = torch.as_tensor(out[k])
                if not src.is_pinned():
                    src = src.pin_memory()
                out[k] = src.to(device, non_blocking=True)
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
    return out, event


def _ready(item):
    """The batch of ``_start_copy``, usable on the current stream."""
    batch, event = item
    if event is not None:
        compute = torch.cuda.current_stream()
        compute.wait_event(event)
        for k in IMAGE_KEYS:
            if k in batch:
                batch[k].record_stream(compute)
    return batch


def stream_batches(loader: Iterable[Dict], device: torch.device,
                   overlap: bool = False) -> Iterator[Dict]:
    """The loader's batches with their pixels on ``device``."""
    stream = torch.cuda.Stream(device) \
        if overlap and device.type == "cuda" else None
    if stream is None:
        for batch in loader:
            yield _ready(_start_copy(batch, device, None))
        return
    nxt = None
    for batch in loader:
        cur, nxt = nxt, _start_copy(batch, device, stream)
        if cur is not None:
            yield _ready(cur)
    if nxt is not None:
        yield _ready(nxt)
