"""checkpoint_submit_ms.train: host milliseconds of the traced epoch that
the learner's thread spent submitting checkpoints (the port's span
``srl.checkpoint.submit``: the snapshot's clones queued and the job
handed to the writer thread), from the spans in the trace
(srl_zoo_tpu_torch/utils/spans.py), in the resident cells. Moves
``train_images_per_s``."""

NAME = "srl.checkpoint.submit"


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None:
        return None
    found = [e - s for s, e, n in tr.host if n == NAME]
    return sum(found) / 1e6 if found else None
