"""Exact k-th largest value and top-k mean of a flat array.

Counterpart of ``codeps_tpu/ops/topk.py``. The JAX package radix-selects
over bit patterns because a sort is slow on a TPU; here only the value
matters, and ``torch.topk`` gives it exactly. The JAX version orders the
sign-masked bit patterns, i.e. by ``|x|``; its inputs are non-negative,
so taking ``abs`` only folds ``-0.0`` into ``+0.0`` as it does.

Inside a process group of several ranks (``parallel/dist.py``)
``top_k_mean`` takes the k largest over the union of every rank's
entries, as the JAX package's sharded step does over the flattened global
batch (``codeps_tpu/losses/semantic.py:118-126``). There the k-th largest
comes from the JAX package's own order: a bisection over the bit
patterns, one count summed over the ranks a bit and nothing gathered.
"""

from __future__ import annotations

import torch

from codeps_torch import parallel


def kth_largest(values: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest (1-based) entry along the last axis of a non-negative
    float tensor: () for a 1-D input, (B,) for a (B, N) one."""
    if not 1 <= k <= values.shape[-1]:
        raise ValueError(f"k={k} outside [1, {values.shape[-1]}]")
    return torch.topk(values.abs(), k, dim=-1, sorted=True).values[..., -1]


def global_kth_largest(mag: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest (1-based) float32 (or float64) value of the union of
    every rank's non-negative 1-D ``mag``, found bit by bit from the top:
    the bit patterns of non-negative floats order as their values, and t
    keeps a bit when at least k entries of all ranks lie at or above it.
    31 (63) all-reduces of one count, which stay on the device."""
    ints = torch.int64 if mag.dtype == torch.float64 else torch.int32
    bits = mag.contiguous().view(ints)
    t = torch.zeros((), dtype=ints, device=mag.device)
    for bit in range(bits.element_size() * 8 - 2, -1, -1):
        candidate = t | (1 << bit)
        above = parallel.all_reduce((bits >= candidate).sum())
        t = torch.where(above >= k, candidate, t)
    return t.view(mag.dtype)


def top_k_mean(flat: torch.Tensor, k: int) -> torch.Tensor:
    """float32 (float64 for float64 entries) mean of the k largest entries
    of a non-negative 1-D tensor,
    by the JAX package's threshold rule (``topk.py:80-107``): with t the
    k-th largest, ``(sum(v > t) + (k - count(v > t)) * t) / k``.

    The value is the mean of the same multiset ``torch.topk`` would
    select. The gradient is 1/k on every entry above t, and the tie mass
    ``(k - count(v > t)) / k`` is spread evenly over the entries equal to
    t (``torch.topk`` would pick an arbitrary subset of the ties).

    Inside a process group of several ranks ``flat`` is this rank's
    share and k counts over all of them: t is ``global_kth_largest``, and
    the sums and counts above and at t are summed over the ranks, so every
    rank gets the global value; the gradient reaches each rank's entries
    through the summed sums (``parallel/dist.py`` on its scale).
    """
    x32 = flat.to(torch.promote_types(flat.dtype, torch.float32))
    mag = x32.detach().abs()
    if parallel.group_size() > 1:
        t = global_kth_largest(mag, k)
    else:
        t = kth_largest(mag, k)
    gt = mag > t
    eq = mag == t
    # the counts in float32 are exact up to 2**24 entries above or at t
    sum_gt, count_gt, sum_eq, count_eq = parallel.all_reduce(torch.stack([
        torch.where(gt, x32, 0.0).sum(), gt.sum(),
        torch.where(eq, x32, 0.0).sum(), eq.sum()])).unbind()
    n_tie = k - count_gt
    # The value uses the exact t; its gradient rides the mean of the ties.
    t_mean = sum_eq / count_eq.clamp(min=1)
    t_val = (t - t_mean).detach() + t_mean
    return (sum_gt + n_tie * t_val) / float(k)
