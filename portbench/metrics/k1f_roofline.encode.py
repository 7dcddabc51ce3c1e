"""k1f_roofline.encode: the fused relu + pool forward (csrc/fused_pool.cu)
in the profiled encode calls: the bound of each launch (inference writes
no argmax plane) over the kernel's device time; percent."""

from portbench.harness import flops

KERNEL = "relu_max_pool_fwd"


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not r.traced_call_s:
        return None
    bounds = len(r.traced_call_s) * flops.pool_launch_bounds(
        r.arch, r.config, r.batch, 1, plane=False)
    return flops.roofline_share(tr.kernel_seconds(KERNEL), bounds)
