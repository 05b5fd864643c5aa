"""The comparison that decides `correct`: the program's first steps against the reference's.

Three numbers; those that `limits/<cell>.json` names are compared, each against
its limit there (a number with no reading of the control or of a fault far
enough above its sound readings is not compared: PERF.md §2):

- `loss_gap`: the largest |program - reference| / |reference| over the steps'
  losses;
- `grad1_gap`: over the leaves, the largest |program norm - reference norm| of
  the first gradient as the optimizer gets it (clipped), over the larger of
  the reference's norm of that leaf and of the median leaf;
- `change_gap`: the same for each leaf's change over the steps, leaving out a
  leaf whose first gradient in the reference is under a thousandth of the
  median leaf's (it moves by round-off alone).

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad1_gap", "change_gap")
ROUNDOFF_SHARE = 1e-3


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], leaves) -> dict[str, float]:
    floor = statistics.median(ref[n] for n in ref)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in leaves}


def gaps(prog, ref) -> dict[str, float]:
    """prog, ref: reference.train.Numbers (the program's read from its state)."""
    if len(prog.losses) != len(ref.losses):
        raise ValueError(f"{len(prog.losses)} program losses against {len(ref.losses)}")
    floor = statistics.median(ref.grad1.values())
    moved = [n for n, g in ref.grad1.items() if g >= ROUNDOFF_SHARE * floor]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)),
        "grad1_gap": max(leaf_gaps(prog.grad1, ref.grad1, ref.grad1).values()),
        "change_gap": max(leaf_gaps(prog.change, ref.change, moved).values()),
    }


def verdict(found: dict[str, float], limits: dict[str, float]) -> bool:
    return all(math.isfinite(found[n]) and found[n] <= limits[n] for n in limits)


def checks(found: dict[str, float], limits: dict[str, float]) -> dict:
    """{name: {"value", "limit"}} of the compared numbers, for the result line."""
    return {n: {"value": found[n], "limit": limits[n]} for n in limits}
