"""collectives_per_step.dp: the collectives that the port issued through
its process group over the window's whole epochs (parallel/mesh.py
``counts``: all-reduces, all-gathers, reduce-scatters; validation's
included) per train step of the window, read on rank 0 of the
data-parallel cells (every rank issues the same). Moves
``train_images_per_s``."""

PREFIX = "collective."


def read(r):
    c = getattr(r, "counts", None)
    if not c or not any(k.startswith(PREFIX) for k in c):
        return None
    steps = r.steps["train"] * len(r.epoch_s)
    if not steps:
        return None
    return sum(n for k, n in c.items() if k.startswith(PREFIX)) / steps
