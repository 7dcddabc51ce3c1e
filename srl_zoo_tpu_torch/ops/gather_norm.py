"""Gather uint8 frames by index from a resident store, then normalize.

Kernel: ``csrc/gather_norm.cu``, which replaces the TPU kernel
``srl_zoo_tpu/ops/gather_norm.py`` ``_gather_norm_pallas`` (``_kernel``).
It is bound by bytes on the H100 (one uint8 read and one float32 write per
element); the source note says how the design meets that.

    out[b] = normalize(frames[idx[b]])     (N, H, W, C) u8 -> (B, H, W, C) f32

The export and training paths gather index batches from the resident
store (a hybrid store by slot); encoding and the streamed training and
export batches pass the uploaded uint8 batch as the store with the
identity index. Both normalize modes are one per-channel affine map, so
neither leaves the kernel. An index outside [0, N) raises IndexError
(JAX's ``take`` would fill the row silently).

:func:`gather_normalize` takes its index on the host (numpy or a CPU
tensor): it is range-checked there, before any launch, and goes up
through pinned memory without a synchronise, so the host can queue the
next work while the device gathers. A CUDA index is taken too, but it is
the slow form: it is read back to the host first, which waits for the
device, and then takes the same path. :func:`gather_normalize_device` is
the device-index form of a captured step (training/epoch.py): its index
already lies on the store's device, range-checked on the host when the
epoch's indices were stacked (``check_host_index``), and it neither reads
the index back nor uploads it, so it runs inside a CUDA graph capture.

The kernel has a vector path, taken when a frame is a whole number of
4-byte groups and the store starts 4-byte aligned (the main paths' 224 x
224 x 3 frames), and a scalar path for any other frame size or a store
slice at an odd offset. The wrappers count their launches (``launches``)
and, beside them, the vector-path launches (``vector_launches``) on
``gather_normalize``, a launch captured into a CUDA graph once for each
replay (ops/_build.py ``count``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from srl_zoo_tpu_torch.ops import _build
from srl_zoo_tpu_torch.ops.preproc import affine_params, normalize_images
from srl_zoo_tpu_torch.utils.device import upload

THREADS = 256  # threads of a block of the kernel
# the grid's aim: about two blocks per SM, each thread striding through
# many 4-byte groups. On the H100 that beat a full wave of resident blocks
# (8 per SM) at both main-path batches: K2 at 32 rows 0.008 against 0.015
# ms, at 256 rows 0.076 against 0.080 (PERF.md).
BLOCKS_PER_SM = 2


def gather_normalize_plain(frames: torch.Tensor, idx: torch.Tensor,
                           mode: str = "tf") -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return normalize_images(frames.index_select(0, idx), mode)


def check_host_index(idx, n: int) -> np.ndarray:
    """A host index (numpy or a CPU tensor of integers, 1-d) as contiguous
    int64; raises IndexError if an entry is outside [0, n)."""
    a = idx.numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    if a.ndim != 1 or not (a.size == 0 or np.issubdtype(a.dtype,
                                                         np.integer)):
        raise ValueError(f"gather_normalize: expected a 1-d integer index, "
                         f"got {a.dtype} {a.shape}")
    a = np.ascontiguousarray(a, np.int64)
    if a.size and (a.min() < 0 or a.max() >= n):
        raise IndexError(f"gather_normalize: an index is outside [0, {n})")
    return a


def blocks_per_row(rows: int, units: int, sms: int) -> int:
    """grid.y of the kernel: blocks per row such that all rows' blocks come
    to about ``sms`` x BLOCKS_PER_SM (at least one per row), and no block
    is left without a slice of ``units`` (4-byte groups or bytes)."""
    aim = sms * BLOCKS_PER_SM
    return max(1, min(aim // rows, -(-units // THREADS), 65535))


@functools.lru_cache(maxsize=16)
def _params(mode: str, c: int):
    """(scale, offset) of a mode as ctypes float pointers, with the arrays
    they point into (kept alive with them)."""
    scale, offset = affine_params(mode, c)
    fp = ctypes.POINTER(ctypes.c_float)
    return scale.ctypes.data_as(fp), offset.ctypes.data_as(fp), scale, offset


def gather_normalize(frames: torch.Tensor, idx,
                     mode: str = "tf") -> torch.Tensor:
    """frames (N, H, W, C) uint8, idx (B,) integers -> (B, H, W, C) float32.

    ``idx`` is a host index (numpy or a CPU tensor) or a tensor on the
    store's device. A CUDA store launches the kernel; a CPU store takes
    :func:`gather_normalize_plain`; any other device raises."""
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_normalize: no kernel for device "
                         f"{frames.device}")
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        if frames.device != idx.device:
            raise ValueError(f"gather_normalize: frames on {frames.device}, "
                             f"idx on {idx.device}")
        idx = idx.cpu()  # waits for the device: the slow form
    idx = check_host_index(idx, frames.shape[0])
    if frames.device.type == "cpu":
        return gather_normalize_plain(frames, torch.from_numpy(idx), mode)
    return _launch(frames, upload(idx, frames.device), mode)


def gather_normalize_device(frames: torch.Tensor, idx: torch.Tensor,
                            mode: str = "tf") -> torch.Tensor:
    """frames (N, H, W, C) uint8, idx (B,) int64 on the frames' device ->
    (B, H, W, C) float32, with no host work on the index: the caller has
    range-checked it (``check_host_index``) before it went up. A CUDA
    store launches the kernel; a CPU store takes
    :func:`gather_normalize_plain`; any other device raises."""
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_normalize: no kernel for device "
                         f"{frames.device}")
    if idx.device != frames.device or idx.dtype != torch.int64 or \
            idx.dim() != 1:
        raise ValueError(f"gather_normalize_device: expected a 1-d int64 "
                         f"index on {frames.device}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if frames.device.type == "cpu":
        return gather_normalize_plain(frames, idx, mode)
    return _launch(frames, idx.contiguous(), mode)


def _launch(frames: torch.Tensor, idx: torch.Tensor,
            mode: str) -> torch.Tensor:
    """The kernel on a CUDA store from an int64 device index whose entries
    are in range; counted on ``gather_normalize``."""
    if frames.dtype != torch.uint8 or frames.dim() != 4 or \
            not frames.is_contiguous():
        raise ValueError(f"gather_normalize: expected a contiguous uint8 "
                         f"(N, H, W, C) store, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    n, h, w, c = frames.shape
    f = h * w * c
    if f >= 2 ** 31:
        raise ValueError(f"gather_normalize: frames of {f} bytes (the "
                         "kernel takes fewer than 2^31)")
    b = idx.shape[0]
    out = torch.empty((b, h, w, c), dtype=torch.float32,
                      device=frames.device)
    if out.numel() == 0:
        return out
    scale, offset, _, _ = _params(mode, c)
    vector = f % 4 == 0 and frames.data_ptr() % 4 == 0
    per_row = blocks_per_row(b, f // 4 if vector else f,
                             _build.sm_count(frames.get_device()))
    code = _build.launch(_build.entry("gather_norm"), frames,
                         frames.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         n, b, f, c, scale, offset, int(vector), per_row)
    _build.check(code, "gather_normalize")
    _build.count(gather_normalize, launches=1, vector_launches=vector)
    return out


gather_normalize.launches = 0
gather_normalize.vector_launches = 0
