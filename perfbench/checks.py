"""The numbers that decide ``correct``, each beside its limit.

A training cell compares the program's first three steps with the
reference's (`reference.first_steps`): each step's loss, the first
gradient's norm by leaf as the optimizer got it, the first step's row of
gradient mean norms, the running statistics' change after the first step
by leaf (batch norm only), and the parameters' change after three steps by
leaf, the worst leaf's (``change``) and the median leaf's
(``change_median``).  A leaf-wise number is the worst leaf's gap between the two norms,
over the larger of the reference's norm of that leaf and of the median
leaf.  The parameters' change leaves out the leaves whose reference
gradient is under a thousandth of the median leaf's: they move by
round-off alone (a bias under batch norm).

A serving cell compares every answer of the window with the reference's
probabilities: the widest gap of a served probability.

The limits are the cell's (``cells/<cell>.json``, ``"limits"``); a
number without a limit there is printed and not judged.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict

# Leaves whose reference gradient is under this share of the median
# leaf's move by round-off under Adam and are left out of the change.
STILL_LEAF = 1e-3


def _gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor, 1e-30)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap; a leaf missing on the program's side reads
    infinity."""
    names = [n for n in want if keep is None or keep(n)]
    if not names:
        return {}
    floor = statistics.median(abs(want[n]) for n in names)
    return {n: _gap(got.get(n, math.inf), want[n], floor) for n in names}


def leafwise(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(got, want, keep).values(), default=0.0)


def worst_leaves(got: Dict[str, float], want: Dict[str, float], keep=None, n: int = 3) -> list:
    """The ``n`` leaves with the widest gaps, with their gaps."""
    gaps = leaf_gaps(got, want, keep)
    return sorted(gaps.items(), key=lambda kv: kv[1], reverse=True)[:n]


def training_numbers(program: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of a training cell (see the module docstring)."""
    out = {f"loss{t + 1}": _gap(p, r, 0.0) for t, (p, r) in
           enumerate(zip(program["loss"], ref["loss"]))}
    if len(program["loss"]) != len(ref["loss"]):
        out["loss_steps"] = math.inf
    out["grad"] = leafwise(program["grad"], ref["grad"])
    rows = dict(enumerate(ref["row"]))
    out["gnorm_row"] = leafwise(dict(enumerate(program["row"])), rows)
    if len(program["row"]) != len(ref["row"]):
        out["gnorm_row"] = math.inf
    if ref.get("bn"):
        out["bn_state"] = leafwise(program.get("bn", {}), ref["bn"])
    gaps = leaf_gaps(program["change"], ref["change"], keep=moving(ref))
    out["change"] = max(gaps.values(), default=0.0)
    out["change_median"] = statistics.median(gaps.values()) if gaps else 0.0
    return out


def moving(ref: dict):
    """The leaves that the reference's first gradient moves: those at or
    over `STILL_LEAF` of the median leaf's."""
    grad_median = statistics.median(ref["grad"].values())
    return lambda n: ref["grad"][n] >= STILL_LEAF * grad_median


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number at or under its limit (a NaN fails)."""
    return all(numbers.get(name, math.inf) <= limit for name, limit in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for the result line, the limited numbers
    first; also printed as the last lines of standard error."""
    out = {n: {"value": numbers.get(n, math.inf), "limit": limit} for n, limit in limits.items()}
    out.update({n: {"value": v, "limit": None} for n, v in numbers.items() if n not in limits})
    for name, item in out.items():
        print(f"check {name}: {item['value']!r} (limit {item['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return out
