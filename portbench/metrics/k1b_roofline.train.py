"""k1b_roofline.train: percent of the pool backward's
(csrc/fused_pool_bwd.cu) bound over its device time in the traced epoch:
each launch the train steps needed, in the resident cells, whose phases
the epoch runner replays. Moves ``train_images_per_s``."""

from portbench.harness import flops

KERNEL = "relu_max_pool_bwd"


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None:
        return None
    bounds = r.steps["train"] * flops.pool_launch_bounds(
        r.arch, r.config, r.batch, r.arch.ENCODER_PASSES, plane=True,
        backward=True)
    return flops.roofline_share(tr.kernel_seconds(KERNEL), bounds)
