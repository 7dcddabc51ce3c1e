"""Which device an entry point runs on, and its float32 precision.

Entry points run on CUDA unless the caller asks for the CPU (as the tests
do). A missing GPU is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device that is absent raises. A CUDA
    device comes back with its index, so it compares equal to the device
    of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: this package runs on an "
                "NVIDIA GPU; pass device='cpu' explicitly to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def use_strict_float32() -> None:
    """Run float32 convolutions and products in full float32, and reduce
    bfloat16 products in float32.

    cuDNN convolutions default to TF32 (about three decimal digits); the
    JAX reference computes float32 configs in float32. cuBLAS may reduce
    the partial sums of a split-K bfloat16 product in bfloat16
    (``allow_bf16_reduced_precision_reduction``, on by default); XLA
    accumulates a bfloat16 product in float32 and rounds once, so the
    switch is turned off for the ``--dtype bfloat16`` configs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def upload(array, device: torch.device,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a tensor on ``device``.

    To a CUDA device it goes through pinned memory with a non-blocking
    copy on the current stream, so the host does not wait for the device:
    a copy from pageable memory ends in a stream synchronise. PyTorch's
    caching host allocator keeps the pinned block until the copy is done.
    On the CPU the tensor may share the array's memory."""
    t = array if isinstance(array, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
