"""idle_between_phases.train: percent of the traced epoch's wall time in
which the device idled while the host did the learner's work between the
phases' replays: each idle gap of at least ``SHORT_GAP_NS`` between two
device operations whose middle lies in one of the port's ``srl.`` spans
(srl_zoo_tpu_torch/utils/spans.py) and in no ``srl.runner.replay`` span
(stacking, loading, the metrics' read-back, validation's set-up,
checkpoint submits), in the resident cells. Moves
``train_images_per_s``."""

import bisect

from portbench.harness.trace import SHORT_GAP_NS, _union

REPLAY = "srl.runner.replay"


def _within(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < spans[i][1]


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not getattr(r, "traced_s", 0.0):
        return None
    srl = _union([h for h in tr.host if h[2].startswith("srl.")])
    if not srl:
        return None
    replay = _union([h for h in tr.host if h[2] == REPLAY])
    srl_starts = [s for s, _ in srl]
    replay_starts = [s for s, _ in replay]
    busy = _union(tr.device)
    idle_ns = 0
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        gap = nxt - end
        mid = end + gap // 2
        if gap >= SHORT_GAP_NS and _within(srl, srl_starts, mid) \
                and not _within(replay, replay_starts, mid):
            idle_ns += gap
    return 100.0 * idle_ns / 1e9 / r.traced_s
