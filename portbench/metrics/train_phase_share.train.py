"""train_phase_share.train: percent of the window's wall time that the
train phases took, the rest being validation, stacking, metrics and
checkpoint submits (the learner's ``time_phases`` log: a device
synchronise at each phase's ends), in the resident cells, whose phases
the epoch runner replays. Moves ``train_images_per_s``."""

def read(r):
    train_s = sum(p["s"] for p in getattr(r, "phase_log", [])
                  if p["what"].startswith("train"))
    if not train_s or not r.epoch_s:
        return None
    return 100.0 * train_s / sum(r.epoch_s)
