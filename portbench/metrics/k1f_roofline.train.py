"""k1f_roofline.train: percent of the fused relu + pool forward's
(csrc/fused_pool.cu) bound over its device time in the traced epoch:
each launch the epoch needed, the train steps' writing the argmax plane,
the eval steps' not, in the resident cells, whose phases the epoch
runner replays. Moves ``train_images_per_s``."""

from portbench.harness import flops

KERNEL = "relu_max_pool_fwd"


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None:
        return None
    passes = r.arch.ENCODER_PASSES
    bounds = r.steps["train"] * flops.pool_launch_bounds(
        r.arch, r.config, r.batch, passes, plane=True) + \
        r.steps["eval"] * flops.pool_launch_bounds(
            r.arch, r.config, r.batch, passes, plane=False)
    return flops.roofline_share(tr.kernel_seconds(KERNEL), bounds)
