"""The numbers that decide ``correct``, each held to a limit from the
configuration's file (``limits``), and how they are printed.

Training (set-up's validation pass and first three train steps, driven
through the window's own store, feed and call, against the plain
reference from the same weights and frames):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as Adam got it (its first
  moment after one step over 1 - b1), by the worst leaf: the gap between
  the two norms of a leaf over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``change_gap``: the parameters' change over the three steps, by the
  worst leaf, measured the same way. Leaves whose reference gradient is
  under a thousandth of the median leaf's (a bias under BatchNorm) move
  under Adam by round-off alone and are left out, by that rule and not
  by name;
* ``eval_gap``: the largest relative gap of a validation step's loss in
  eval mode (the running statistics), over the whole validation split,
  at the weights the benchmark made.

Encoding: ``state_gap``, the largest relative L2 gap of one returned
state row against the reference's, over a sample of the window's calls.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

ZERO_GRAD_SHARE = 1e-3


def _median(values: List[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                      + s[len(s) // 2])


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: List[str]) -> float:
    ref_n = {k: float(ref[k].double().norm()) for k in names}
    floor = _median(list(ref_n.values()))
    return max(abs(float(prog[k].double().norm()) - ref_n[k])
               / max(ref_n[k], floor, 1e-30) for k in names)


def loss_gaps(prog: List[float], ref: List[float]) -> List[float]:
    """Each step's relative loss gap (one infinite gap where the two
    sides ran different numbers of steps)."""
    if len(prog) != len(ref) or not ref:
        return [float("inf")]
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref)]


def train_numbers(prog: Dict, ref: Dict, initial: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """The three training numbers of the program's and the reference's
    readings (each: ``losses``, ``grads`` of step 1, ``params`` after the
    last step); ``initial`` holds the weights both started from."""
    names = list(ref["grads"])
    gaps = loss_gaps(prog["losses"], ref["losses"])
    grad_gap = _leaf_gap(prog["grads"], ref["grads"], names)
    gnorm = {k: float(ref["grads"][k].double().norm()) for k in names}
    floor = ZERO_GRAD_SHARE * _median(list(gnorm.values()))
    moved = [k for k in names if gnorm[k] >= floor]
    change_p = {k: prog["params"][k].double() - initial[k].double()
                for k in moved}
    change_r = {k: ref["params"][k].double() - initial[k].double()
                for k in moved}
    change_gap = _leaf_gap(change_p, change_r, moved)
    change_median = _median([
        abs(float(change_p[k].norm()) - float(change_r[k].norm()))
        / max(float(change_r[k].norm()), 1e-30) for k in moved])
    return {"loss_gap": max(gaps), "loss_gap_1": gaps[0],
            "grad_gap": grad_gap, "change_gap": change_gap,
            "change_gap_median": change_median}


def state_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative L2 gap of a state row."""
    prog, ref = prog.double(), ref.double()
    if prog.shape != ref.shape:
        return float("inf")
    gap = (prog - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    return float(gap.max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number that has a limit, beside it; a number that is not
    finite fails, and so does a limit without its number."""
    return {k: {"value": numbers.get(k, float("nan")), "limit": v}
            for k, v in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())


def print_checks(checks: Dict[str, Dict[str, float]]) -> None:
    """Each number beside its limit, as the last lines on stderr."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
