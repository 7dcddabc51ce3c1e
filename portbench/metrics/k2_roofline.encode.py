"""k2_roofline.encode: the gather + normalize (csrc/gather_norm.cu) in the
profiled encode calls, one launch a call over the uploaded uint8 batch:
its bound (uint8 read, float32 written) over the kernel's device time;
percent."""

from portbench.harness import flops

KERNEL = "gather_norm_kernel"


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not r.traced_call_s:
        return None
    c = r.config
    frame = c["img_height"] * c["img_width"] * c["channels"]
    bounds = [flops.bound_s(flops.k2_bytes(r.batch, frame))] * \
        len(r.traced_call_s)
    return flops.roofline_share(tr.kernel_seconds(KERNEL), bounds)
