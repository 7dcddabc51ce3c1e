"""nccl_share.dp: percent of the traced epoch's wall time in which one of
NCCL's kernels ran on rank 0's device (the process group's collectives,
each kernel's wait for the other ranks included), in the data-parallel
cells. Moves ``train_images_per_s``."""

KERNEL = "nccl"


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not getattr(r, "traced_s", 0.0):
        return None
    busy = tr.kernel_busy_s(KERNEL)
    return 100.0 * busy / r.traced_s if busy else None
