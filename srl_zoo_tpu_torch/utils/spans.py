"""Named host spans of the port: where the host's time goes in an epoch, in
set-up and in an encode call.

    with span("srl.learn.stack"):
        ...

A span always adds its count and its host nanoseconds
(``time.perf_counter_ns``) to one registry of the process, which
``totals()`` reads and ``delta()`` reads against an earlier ``totals()``
(the learner writes each epoch's delta to ``<log>/spans.jsonl``). Only
while a ``torch.profiler`` records on the calling thread does it also
enter ``torch.profiler.record_function``, so that the span lands in the
trace on the clock of the device's activity (the range costs ~10 us a
span; without a profiler a span costs its check, two clock reads and
its registry entry, about a microsecond). The profiler is the only
switch: an operator's ``--profile`` trace and a benchmark's traced run
show the spans, and ``utils/profiling.py`` sums them.

Names are fixed dotted strings starting with ``srl.``. No span runs
inside a body that ``torch.cuda.graph`` captures: spans wrap captures and
replay loops, never the step bodies.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_now = time.perf_counter_ns
_NONE = (0, 0)
# one registry ({name: (count, nanoseconds)}) a thread that ended a span:
# its owner alone writes it, each entry replaced whole, so a reader that
# copies it sees whole entries and no update is lost without a lock
_local = threading.local()
_registries: List[Dict[str, Tuple[int, int]]] = []
_lock = threading.Lock()  # guards the list of registries


def _registry() -> Dict[str, Tuple[int, int]]:
    """The calling thread's registry, made at its first span."""
    reg: Dict[str, Tuple[int, int]] = {}
    _local.reg = reg
    with _lock:
        _registries.append(reg)
    return reg


class span:
    """A context manager that times its block into the registry under
    ``name`` (and into a running profiler's trace); ``seconds`` holds the
    block's host seconds once it has ended."""

    __slots__ = ("name", "ns", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self._rf = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._t0 = _now()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        ns = self.ns = _now() - self._t0
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        try:
            reg = _local.reg
        except AttributeError:
            reg = _registry()
        count, total = reg.get(self.name, _NONE)
        reg[self.name] = (count + 1, total + ns)
        return False

    @property
    def seconds(self) -> float:
        return self.ns / 1e9


def totals() -> Dict[str, Tuple[int, float]]:
    """{name: (count, seconds)} of every span the process has ended, on
    every thread."""
    with _lock:
        regs = list(_registries)
    out: Dict[str, list] = {}
    for reg in regs:
        for k, (c, ns) in list(reg.items()):
            t = out.setdefault(k, [0, 0])
            t[0] += c
            t[1] += ns
    return {k: (c, ns / 1e9) for k, (c, ns) in out.items()}


def delta(since: Dict[str, Tuple[int, float]]
          ) -> Dict[str, Tuple[int, float]]:
    """{name: (count, seconds)} of the spans ended after ``since`` (an
    earlier ``totals()``)."""
    out = {}
    for k, (c, s) in totals().items():
        c0, s0 = since.get(k, (0, 0.0))
        if c > c0:
            out[k] = (c - c0, s - s0)
    return out


def reset() -> None:
    """Forget every span (for tests, while no other thread ends one)."""
    with _lock:
        for reg in _registries:
            reg.clear()
