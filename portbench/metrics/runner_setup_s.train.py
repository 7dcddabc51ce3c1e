"""runner_setup_s.train: seconds the run spent readying the epoch
runner's graphs: the eager warm-up steps before a capture (the port's
span ``srl.runner.warm``) and the captures (``srl.runner.capture``),
read from the port's span registry after the run
(srl_zoo_tpu_torch/utils/spans.py ``totals``), in the resident cells.
Moves ``setup_s``."""

NAMES = ("srl.runner.warm", "srl.runner.capture")


def read(r):
    if getattr(r, "epoch_s", None) is None:
        return None
    try:
        from srl_zoo_tpu_torch.utils import spans
    except ImportError:  # a port without spans
        return None
    totals = spans.totals()
    found = [totals[n][1] for n in NAMES if n in totals]
    return sum(found) if found else None
