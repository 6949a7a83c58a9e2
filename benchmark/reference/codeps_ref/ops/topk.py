"""Exact k-th largest value and top-k mean of a flat array.

Counterpart of ``codeps_tpu/ops/topk.py``. The JAX package radix-selects
over bit patterns because a sort is slow on a TPU; here only the value
matters, and ``torch.topk`` gives it exactly. The JAX version orders the
sign-masked bit patterns, i.e. by ``|x|``; its inputs are non-negative,
so taking ``abs`` only folds ``-0.0`` into ``+0.0`` as it does.
"""

from __future__ import annotations

import torch


def kth_largest(values: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest (1-based) entry along the last axis of a non-negative
    float tensor: () for a 1-D input, (B,) for a (B, N) one."""
    if not 1 <= k <= values.shape[-1]:
        raise ValueError(f"k={k} outside [1, {values.shape[-1]}]")
    return torch.topk(values.abs(), k, dim=-1, sorted=True).values[..., -1]


def top_k_mean(flat: torch.Tensor, k: int) -> torch.Tensor:
    """float32 (float64 for float64 entries) mean of the k largest entries
    of a non-negative 1-D tensor,
    by the JAX package's threshold rule (``topk.py:80-107``): with t the
    k-th largest, ``(sum(v > t) + (k - count(v > t)) * t) / k``.

    The value is the mean of the same multiset ``torch.topk`` would
    select. The gradient is 1/k on every entry above t, and the tie mass
    ``(k - count(v > t)) / k`` is spread evenly over the entries equal to
    t (``torch.topk`` would pick an arbitrary subset of the ties).
    """
    x32 = flat.to(torch.promote_types(flat.dtype, torch.float32))
    mag = x32.detach().abs()
    t = kth_largest(mag, k)
    gt = mag > t
    eq = mag == t
    # the counts in float32 are exact up to 2**24 entries above or at t
    sum_gt, count_gt, sum_eq, count_eq = torch.stack([
        torch.where(gt, x32, 0.0).sum(), gt.sum(),
        torch.where(eq, x32, 0.0).sum(), eq.sum()]).unbind()
    n_tie = k - count_gt
    # The value uses the exact t; its gradient rides the mean of the ties.
    t_mean = sum_eq / count_eq.clamp(min=1)
    t_val = (t - t_mean).detach() + t_mean
    return (sum_gt + n_tie * t_val) / float(k)
