"""idle.train: percent of the traced epoch's wall time in which no
operation ran on the device (one minus the union of the trace's device
intervals over the wall time), in the resident cells, whose phases the
epoch runner replays. Moves ``train_images_per_s``."""

def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not r.traced_s:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s() / r.traced_s)
