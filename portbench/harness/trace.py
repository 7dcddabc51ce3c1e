"""The reduction of a ``torch.profiler`` trace to what the metrics read:
the device's operations (kernels, copies, memsets) as intervals, its busy
time (their union), the kernels' times by name, and the idle gaps between
device work named by what the launching host thread was doing.

The profiler's ranges that show on the device as spans (user
annotations, ``Optimizer.*``, ``ProfilerStep*``) cover idle time and
their kernels are listed on their own, so they are left out of the busy
time, as the port's ``chip_smoke.py`` ``_device_busy_ms`` leaves them
out (this module holds a copy of that rule, not an import).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# gaps shorter than this are launch spacing inside a burst of work; they
# are summed under one name instead of being named one by one
SHORT_GAP_NS = 20_000
TOP = 10


@dataclass
class Trace:
    """Device intervals (start_ns, end_ns, name), sorted by start, and
    the launching thread's host events (start_ns, end_ns, name)."""
    device: List[Tuple[int, int, str]] = field(default_factory=list)
    host: List[Tuple[int, int, str]] = field(default_factory=list)

    def kernel_seconds(self, substring: str) -> List[float]:
        """The device time of each traced launch of the kernels whose
        name holds ``substring``."""
        return [(e - s) / 1e9 for s, e, n in self.device if substring in n]

    def kernel_busy_s(self, substring: str) -> float:
        """Seconds in which some operation whose name holds
        ``substring`` ran on the device (the union of their intervals)."""
        return sum(e - s for s, e in _union(
            [d for d in self.device if substring in d[2]])) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in _union(self.device)) / 1e9

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the longest
        idle gaps summed by what the host was doing, ``TOP`` of each,
        in seconds."""
        ops: Dict[str, float] = defaultdict(float)
        for s, e, n in self.device:
            ops[n[:160]] += (e - s) / 1e9
        gaps: Dict[str, float] = defaultdict(float)
        spans = _union(self.device)
        starts = [h[0] for h in self.host]
        for (_, end), (nxt, _) in zip(spans, spans[1:]):
            gap = nxt - end
            if gap < SHORT_GAP_NS:
                gaps["gaps under 20 us (launch spacing)"] += gap / 1e9
            else:
                gaps[self._doing(end + gap // 2, starts)] += gap / 1e9
        return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}

    def _doing(self, t: int, starts: List[int]) -> str:
        """The innermost host event of the launching thread around ``t``
        (the latest-starting one that contains it); a gap is named by
        what the host was doing at its middle."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 400, -1), -1):
            s, e, n = self.host[j]
            if e > t:
                return f"host in {n[:120]}"
        return "host outside any traced op"


def _top(d: Dict[str, float]) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:TOP]]


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_span(name: str, activity: str, annotation: bool) -> bool:
    return annotation or "annotation" in activity or \
        name.startswith(("Optimizer.", "ProfilerStep"))


def collect(prof) -> Trace:
    """The Trace of a stopped profiler."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], defaultdict(list)
    launches: Dict[int, int] = defaultdict(int)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        # not every torch has these two
        activity = str(getattr(ev, "activity_type", str)())
        annotation = bool(getattr(ev, "is_user_annotation", bool)())
        if ev.device_type() == cuda:
            if not _is_span(name, activity, annotation):
                device.append((s, e, name))
            continue
        tid = ev.start_thread_id()
        host[tid].append((s, e, name))
        if name.startswith("cuda"):
            launches[tid] += 1
    device.sort()
    main: Optional[int] = max(launches, key=launches.get) if launches \
        else None
    return Trace(device=device, host=sorted(host.get(main, [])))
