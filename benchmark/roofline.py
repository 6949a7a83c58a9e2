"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W limit) and the bound of the grouping kernel.

``grouping_bound_batch`` is copied from ``chip_smoke.py``: offsets read
and ids written once (12 bytes a pixel), centers and flags read once
(9 bytes a slot), 5 FP32 operations per (pixel, valid center).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TOP_K = 200


def grouping_bound_batch(batch, height, width, valid_per_image,
                         slots=TOP_K):
    """(bound seconds, "bytes" or "operations") of grouping a (batch,
    height, width) offset map against ``slots`` centers an image with
    ``valid_per_image`` valid ones."""
    moved = batch * (height * width * (8 + 4) + slots * (8 + 1))
    ops = 5 * height * width * sum(valid_per_image)
    bytes_s = moved / HBM_BYTES_PER_S
    ops_s = ops / FP32_OPS_PER_S
    return max(bytes_s, ops_s), ("operations" if ops_s > bytes_s
                                 else "bytes")


def mfu_pct(flops_per_unit: float, units_per_s: float) -> float:
    """The share of the bfloat16 dense peak that ``flops_per_unit`` at
    ``units_per_s`` is, in percent."""
    return 100.0 * flops_per_unit * units_per_s / BF16_FLOPS_PER_S


def count_flops(fn):
    """(result of ``fn()``, its FLOPs as ``torch.utils.flop_counter``
    counts them: matrix products and convolutions, forward and
    backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, counter.get_total_flops()
