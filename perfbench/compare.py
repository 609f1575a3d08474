"""The comparison that decides ``correct``.

Readings of a training run: ``loss`` (each checked step's loss, the
mean over the data-parallel ranks), ``grad`` (each leaf's norm of the
first step's gradient: the program's worked out from its optimizer's
state after that step, ``exp_avg / (1 - beta1)``) and ``change`` (each
leaf's norm of its change over the checked steps, read against the
weights made again from the seed). A leaf's gap is ``|norm - ref
norm|`` over the larger of that leaf's reference norm and the median
leaf's. The program's readings are held against the reference's by:

* ``loss_gap``: the first step's ``|loss - ref| / |ref|``. The later
  steps' gaps are reported, not compared: Adam's first steps move each
  element by about the learning rate whatever its gradient's size, so a
  rounding that flips a small gradient's sign moves the next losses by
  as much in the reference's float32 as in a lower precision;
* ``grad_gap``: the worst leaf's gap of the first gradient;
* ``grad_mean_gap``: the mean of the leaves' gaps of it. The worst
  leaf is the MoE router's on most seeds: its top-2 choice flips for
  tokens whose second and third experts nearly tie, so its gap, and
  with it the worst leaf's, swings by whole tokens from seed to seed,
  and a precision a step lower reads inside that swing; over every
  leaf it reads apart;
* ``change_gap``: the worst leaf's gap of the change, over the leaves
  whose reference gradient is at least a thousandth of the median
  leaf's (a leaf with a gradient nought to rounding moves under Adam by
  round-off alone);

and, where ranks train together, ``ranks_differ``: the (rank, leaf)
pairs whose parameters differ from rank 0's after the window (exact,
limit 0). A number over its limit, or a reading that is missing, makes
the run not correct.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

GRAD_FLOOR = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's ``|norm - ref norm|`` over the larger of its reference
    norm and the median leaf's (inf for a leaf the program lacks)."""
    if not leaves:
        return {}
    med = statistics.median(ref[n] for n in leaves)
    out = {}
    for n in leaves:
        p = prog.get(n)
        base = max(ref[n], med)
        if p is None:
            out[n] = float("inf")
        else:
            out[n] = abs(p - ref[n]) / base if base > 0 else abs(p - ref[n])
    return out


def moved(ref: Dict[str, object]) -> List[str]:
    """The leaves whose first reference gradient is at least
    :data:`GRAD_FLOOR` of the median leaf's."""
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in leaves)
    return [n for n in leaves if ref["grad"][n] >= GRAD_FLOOR * med]


def loss_gaps(prog: Dict[str, object], ref: Dict[str, object]) -> List[float]:
    lp, lr = prog["loss"], ref["loss"]
    if len(lp) != len(lr):
        return [float("inf")]
    return [abs(a - b) / abs(b) for a, b in zip(lp, lr)]


def gaps(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    """The numbers compared, from the program's and the reference's
    readings."""
    grad = leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"]))
    change = leaf_gaps(prog["change"], ref["change"], moved(ref))
    return {"loss_gap": loss_gaps(prog, ref)[0],
            "grad_gap": max(grad.values(), default=0.0),
            "grad_mean_gap": statistics.mean(grad.values()),
            "change_gap": max(change.values(), default=0.0)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, Optional[float]]]]:
    """``(correct, checks)``: every number at or under its limit; each
    check ``{"value": number, "limit": limit}``. A number with no limit
    fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks
