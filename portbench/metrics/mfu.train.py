"""mfu.train: percent of the chip's peak for the configuration's compute
dtype: the model FLOPs of every step of the traced epoch (train steps
forward and backward, eval steps forward; harness/flops.py) over the
epoch's wall time, in the resident cells, whose phases the epoch runner
replays. Moves ``train_images_per_s``."""

from portbench.harness import flops, peaks


def read(r):
    if not getattr(r, "traced_s", 0.0):
        return None
    work = r.batch * (r.steps["train"] * flops.sample_flops(
        r.arch, r.config, True) + r.steps["eval"] * flops.sample_flops(
        r.arch, r.config, False))
    return 100.0 * work / (r.traced_s * peaks.flops_peak(
        r.config["compute_dtype"]))
