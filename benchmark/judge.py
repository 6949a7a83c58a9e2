"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each held to a limit of its own (the cell's
``limits``).

Norm gaps are taken leaf by leaf, as the gap between the program's norm
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf; a leaf whose reference first gradient is under a
thousandth of the median leaf's is left out of the gradient and change
gaps (it moves under Adam by round-off alone).
"""

from __future__ import annotations

import math
import statistics

import torch

NEGLIGIBLE = 1e-3


def kept_leaves(ref_grads: dict) -> set:
    median = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v >= NEGLIGIBLE * median}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: gap} of two {leaf: norm} maps over ``keep``; a leaf missing
    on the program's side reads its norm 0."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return {}
    median = statistics.median(ref[k] for k in names)
    gaps = {}
    for k in names:
        p = prog.get(k, 0.0)
        gaps[k] = (abs(p - ref[k]) / max(ref[k], median, 1e-30)
                   if math.isfinite(p) else math.inf)
    return gaps


def worst_leaf(gaps: dict):
    """(worst gap, its leaf)."""
    if not gaps:
        return 0.0, None
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median_leaf(gaps: dict) -> float:
    """The median leaf's gap: steady where a few small leaves of a path
    that cancels (the pose net's photometric gradient on noise frames)
    swing from seed to seed."""
    return statistics.median(gaps.values()) if gaps else 0.0


def rel_gap(a: float, b: float) -> float:
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    if a.shape != b.shape or not torch.isfinite(a).all():
        return math.inf
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def segment_disagreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels on which two id maps disagree once each id of one
    is matched to the id of the other it overlaps most, the worse of the
    two directions (ids may be numbered differently)."""
    a, b = a.reshape(-1).long(), b.reshape(-1).long()
    a = torch.unique(a, return_inverse=True)[1]
    b = torch.unique(b, return_inverse=True)[1]
    n = a.numel()
    agree = []
    for x, y in ((a, b), (b, a)):
        pairs = x * (int(y.max()) + 1) + y
        ids, counts = torch.unique(pairs, return_counts=True)
        best = torch.zeros(int(x.max()) + 1, dtype=counts.dtype)
        best.scatter_reduce_(0, ids // (int(y.max()) + 1), counts, "amax")
        agree.append(int(best.sum()))
    return 1.0 - min(agree) / n


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number with a limit
    must be finite and at most its limit; a number without one is
    printed but decides nothing."""
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not (math.isfinite(value)
                                      and value <= limit):
            correct = False
    missing = [name for name in limits if name not in numbers]
    if missing:
        correct = False
        for name in missing:
            checks[name] = {"value": None, "limit": limits[name]}
    return correct, checks
