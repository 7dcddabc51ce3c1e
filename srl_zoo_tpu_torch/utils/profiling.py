"""Summarize a ``--profile`` trace without a trace viewer (port of
``srl_zoo_tpu/utils/profiling.py``).

``--profile`` (train.py) writes a ``torch.profiler`` trace of the first
epoch's training into ``<log>/profile`` as Chrome trace JSON. This module
reads the newest one and sums its time by kernel or op name into a top-N
table: the device's kernel, copy and memset time where the trace has
CUDA activity, else (a CPU-only run) each operator's CPU self time, its
time less that of the operators it called. The header says which it
summed. The FLOPs column shows the trace's FLOP counts where its events
carry them (``args.flops``) and ``n/a`` elsewhere. Beside it, a second
table sums the host time of the port's ``srl.`` spans (utils/spans.py):
where the host's time went in the profiled epoch (stacking, the runner's
load, warm-up, capture and replays, metrics, validation, checkpoints).

    python -m srl_zoo_tpu_torch.utils.profiling --log-folder logs/<run> \\
        [--top N]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DEVICE_TIME = "device time"
CPU_SELF_TIME = "CPU self time"
SPAN_TIME = "of longest span"


class Row(NamedTuple):
    name: str
    pct: float            # of the summed time
    ms: float
    calls: int
    flops: Optional[float]  # None where the trace carries no FLOP count


def _cpu_self_times(events) -> List[Tuple[dict, float]]:
    """(event, self time in us) of each CPU operator: its duration less
    its direct children's, the children being the operators nested inside
    it on the same thread."""
    by_thread = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[list] = []  # [event, end, children's time]
        done = []
        for e in evs:
            while stack and stack[-1][1] <= e["ts"]:
                done.append(stack.pop())
            if stack:
                stack[-1][2] += e["dur"]
            stack.append([e, e["ts"] + e["dur"], 0.0])
        done.extend(stack)
        out.extend((e, max(e["dur"] - kids, 0.0)) for e, _, kids in done)
    return out


def summarize_trace(trace_path: str, top: int = 12,
                    basis: Optional[str] = None) -> Tuple[str, List[Row]]:
    """(what was summed: ``DEVICE_TIME`` or ``CPU_SELF_TIME``, the ``top``
    rows by time, largest first). ``basis`` ``CPU_SELF_TIME`` sums the
    host's operators even where the trace has device time."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if device and basis != CPU_SELF_TIME:
        basis, timed = DEVICE_TIME, [(e, float(e["dur"])) for e in device]
    else:
        basis = CPU_SELF_TIME
        timed = _cpu_self_times([e for e in events
                                 if e.get("cat") == "cpu_op"])
    total = sum(t for _, t in timed) or 1.0
    us, calls = defaultdict(float), defaultdict(int)
    flops = {}
    for e, t in timed:
        name = e.get("name", "?")
        us[name] += t
        calls[name] += 1
        f = (e.get("args") or {}).get("flops")
        if f is not None:
            flops[name] = flops.get(name, 0.0) + float(f)
    rows = [Row(n, 100.0 * t / total, t / 1e3, calls[n], flops.get(n))
            for n, t in us.items()]
    rows.sort(key=lambda r: -r.ms)
    return basis, rows[:top]


def span_times(trace_path: str) -> List[Row]:
    """Host time of each ``srl.`` span of the trace (its ``user_annotation``
    events), largest first; ``pct`` of the longest span's time."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("srl.")]
    us, calls = defaultdict(float), defaultdict(int)
    for e in events:
        us[e["name"]] += float(e["dur"])
        calls[e["name"]] += 1
    longest = max(us.values(), default=0.0) or 1.0
    rows = [Row(n, 100.0 * t / longest, t / 1e3, calls[n], None)
            for n, t in us.items()]
    rows.sort(key=lambda r: -r.ms)
    return rows


def newest_trace(profile_dir: str) -> str:
    """The newest trace under ``profile_dir``."""
    paths = sorted(glob.glob(os.path.join(profile_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"No torch.profiler traces under "
                                f"{profile_dir}: run training with "
                                "--profile first")
    return paths[-1]


def summarize_profile_dir(profile_dir: str, top: int = 12,
                          basis: Optional[str] = None
                          ) -> Tuple[str, List[Row]]:
    """``summarize_trace`` of the newest trace under ``profile_dir``."""
    return summarize_trace(newest_trace(profile_dir), top=top, basis=basis)


def format_table(basis: str, rows: List[Row]) -> str:
    lines = [f"{'% ' + basis:>18}  {'ms':>10}  {'calls':>7}  "
             f"{'GFLOPs':>9}  name"]
    for r in rows:
        fl = "n/a" if r.flops is None else f"{r.flops / 1e9:.3f}"
        lines.append(f"{r.pct:17.1f}%  {r.ms:10.3f}  {r.calls:7d}  "
                     f"{fl:>9}  {r.name[:100]}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="Summarize a --profile trace")
    p.add_argument("--log-folder", type=str, required=True)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    path = newest_trace(os.path.join(args.log_folder, "profile"))
    basis, rows = summarize_trace(path, top=args.top)
    print(format_table(basis, rows))
    spans = span_times(path)
    if spans:
        print()
        print(format_table(SPAN_TIME, spans))
    return rows


if __name__ == "__main__":
    main()
