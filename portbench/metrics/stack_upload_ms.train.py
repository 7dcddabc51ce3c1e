"""stack_upload_ms.train: host milliseconds of the traced epoch spent
stacking its cached phases' index batches (the port's span
``srl.learn.stack``) and loading them into the epoch runner's buffers
(``srl.runner.load``: pinning and queueing the copies), from the spans in
the trace (srl_zoo_tpu_torch/utils/spans.py), in the resident cells.
Moves ``train_images_per_s``."""

NAMES = ("srl.learn.stack", "srl.runner.load")


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None:
        return None
    found = [e - s for s, e, n in tr.host if n in NAMES]
    return sum(found) / 1e6 if found else None
