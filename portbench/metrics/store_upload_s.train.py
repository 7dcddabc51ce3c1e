"""store_upload_s.train: seconds the run spent uploading the frame store
to the device (the port's span ``srl.store.upload``:
data/device_cache.py ``build_cache``, the chunked upload from host
memory), read from the port's span registry after the run
(srl_zoo_tpu_torch/utils/spans.py ``totals``), in the resident cells.
Moves ``setup_s``."""

NAME = "srl.store.upload"


def read(r):
    if getattr(r, "epoch_s", None) is None:
        return None
    try:
        from srl_zoo_tpu_torch.utils import spans
    except ImportError:  # a port without spans
        return None
    found = spans.totals().get(NAME)
    return found[1] if found else None
