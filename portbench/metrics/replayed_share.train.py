"""replayed_share.train: percent of the window's steps (train and eval) run
as replays of a captured CUDA graph (the epoch runner's ``counts()``),
against those run eagerly by the runner or by the learner's per-step
loop (``loop_steps``), in the resident cells, whose phases the epoch
runner replays. Moves ``train_images_per_s``."""

def read(r):
    c = getattr(r, "counts", None)
    if not c:
        return None
    steps = c["replays"] + c["eager_steps"] + c["loop_steps"]
    return 100.0 * c["replays"] / steps if steps else None
