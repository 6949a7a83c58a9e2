"""Depth evaluation metrics (Monodepth2 protocol).

Counterpart of ``codeps_tpu/evaluation/depth_metrics.py`` (the
reference's DepthEvaluator): void GT (0) masked out, optional GT-median
scaling, clamping to the evaluation range, then abs_rel, sq_rel, rmse,
rmse_log and a1-a3 averaged over the frames that have GT. Medians are the
lower middle value, as ``torch.median`` gives, taken from a sort of the
masked values so that nothing waits for the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

METRIC_KEYS = ("d_a1", "d_a2", "d_a3", "d_rmse", "d_rmse_log", "d_abs_rel",
               "d_sq_rel")


def _masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of ``values[mask]`` along the last axis; masked-out
    entries sort last as +inf."""
    big = torch.where(mask, values, torch.inf)
    idx = torch.clamp((mask.sum(dim=-1, keepdim=True) - 1) // 2, min=0)
    return torch.gather(torch.sort(big, dim=-1).values, -1, idx)[..., 0]


def _flat(depth: torch.Tensor) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 1) -> (B, H*W)."""
    return depth.reshape(depth.shape[0], -1)


def compute_depth_metrics(depth_gt: torch.Tensor, depth_pred: torch.Tensor,
                          use_gt_scale: bool = True,
                          depth_ranges: Tuple[float, float] = (0.1, 80.0)
                          ) -> Dict[str, torch.Tensor]:
    """Scalar stats (keys ``METRIC_KEYS``) averaged over the frames with
    GT; NaN when no frame has any.

    Args:
      depth_gt: (B, H, W) or (B, H, W, 1), 0 marks void.
      depth_pred: (B, H, W, 1) or the same as ``depth_gt``.
    """
    min_depth, max_depth = depth_ranges
    gt_flat, pred_flat = _flat(depth_gt), _flat(depth_pred)
    mask = gt_flat > 0
    count = mask.sum(dim=1).clamp(min=1)
    if use_gt_scale:
        ratio = _masked_median(gt_flat, mask) / _masked_median(pred_flat,
                                                               mask)
        pred_flat = pred_flat * ratio[:, None]
    gt = torch.clamp(gt_flat, min_depth, max_depth)
    pred = torch.clamp(pred_flat, min_depth, max_depth)

    def masked_mean(x):
        return torch.where(mask, x, 0.0).sum(dim=1) / count

    thresh = torch.maximum(gt / pred, pred / gt)
    stats = {
        "a1": masked_mean((thresh < 1.25).float()),
        "a2": masked_mean((thresh < 1.25 ** 2).float()),
        "a3": masked_mean((thresh < 1.25 ** 3).float()),
        "rmse": torch.sqrt(masked_mean((gt - pred) ** 2)),
        "rmse_log": torch.sqrt(masked_mean(
            (torch.log(gt) - torch.log(pred)) ** 2)),
        "abs_rel": masked_mean(torch.abs(gt - pred) / gt),
        "sq_rel": masked_mean((gt - pred) ** 2 / gt),
    }
    valid_frame = mask.sum(dim=1) > 0
    n_valid = valid_frame.sum().clamp(min=1)
    return {f"d_{key}": torch.where(
        valid_frame.any(),
        torch.where(valid_frame, value, 0.0).sum() / n_valid,
        torch.nan) for key, value in stats.items()}
