"""The comparison that decides ``correct``: the program's first steps
against the reference's, from the same weights and batches.

Three numbers, each against its limit in ``limits/<workload>.json``:

* ``loss_gap``: the largest |loss − reference loss| / |reference loss|
  over the steps followed;
* ``grad_gap``: the worst leaf's |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the median
  leaf's ‖g_ref‖), g the first step's gradient as the optimizer got it;
* ``change_gap``: the same of each leaf's change ‖p − p0‖ after the steps
  followed, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NAMES = ("loss_gap", "grad_gap", "change_gap")
# a leaf counts in the change where its reference gradient is at least
# this share of the median leaf's
MOVING = 1e-3


def _worst(got: Dict[str, float], want: Dict[str, float],
           leaves: List[str]) -> Tuple[float, str]:
    floor = statistics.median(want[k] for k in leaves)
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def numbers(got: Dict, want: Dict) -> Dict:
    """``got`` and ``want``: each {"losses", "grad_norms", "change_norms"};
    ``want`` is the reference's."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(got["losses"], want["losses"])]
    if len(got["losses"]) != len(want["losses"]):
        losses.append(math.inf)
    leaves = sorted(want["grad_norms"])
    grad, grad_at = _worst(got["grad_norms"], want["grad_norms"], leaves)
    floor = statistics.median(want["grad_norms"][k] for k in leaves)
    moving = [k for k in leaves if want["grad_norms"][k] >= MOVING * floor]
    change, change_at = _worst(got["change_norms"], want["change_norms"],
                               moving)
    return {"loss_gap": max(losses), "grad_gap": grad,
            "change_gap": change, "grad_leaf": grad_at,
            "change_leaf": change_at,
            "left_out": sorted(set(leaves) - set(moving))}


def judge(nums: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): correct where every number
    is finite and at most its limit."""
    shown = {}
    ok = True
    for name in NAMES:
        value, limit = nums[name], limits[name]["limit"]
        ok = ok and math.isfinite(value) and value <= limit
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
