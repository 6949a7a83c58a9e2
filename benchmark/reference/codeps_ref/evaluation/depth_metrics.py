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

    stats = _depth_stats(gt, pred, masked_mean)
    valid_frame = mask.sum(dim=1) > 0
    sums = torch.stack(
        [torch.where(valid_frame, value, 0.0).sum()
         for value in stats.values()] + [valid_frame.sum()])
    n_valid = sums[-1]
    means = sums[:-1] / n_valid.clamp(min=1)
    return {f"d_{key}": torch.where(n_valid > 0, mean, torch.nan)
            for key, mean in zip(stats, means)}


def _depth_stats(gt, pred, masked_mean) -> Dict[str, torch.Tensor]:
    """The seven Monodepth2 statistics over the masked pixels."""
    thresh = torch.maximum(gt / pred, pred / gt)
    return {
        "a1": masked_mean((thresh < 1.25).float()),
        "a2": masked_mean((thresh < 1.25 ** 2).float()),
        "a3": masked_mean((thresh < 1.25 ** 3).float()),
        "rmse": torch.sqrt(masked_mean((gt - pred) ** 2)),
        "rmse_log": torch.sqrt(masked_mean(
            (torch.log(gt) - torch.log(pred)) ** 2)),
        "abs_rel": masked_mean(torch.abs(gt - pred) / gt),
        "sq_rel": masked_mean((gt - pred) ** 2 / gt),
    }


def compute_depth_metrics_per_class(depth_gt: torch.Tensor,
                                    depth_pred: torch.Tensor,
                                    semantic_gt: torch.Tensor,
                                    num_classes: int,
                                    use_gt_scale: bool = True,
                                    depth_ranges: Tuple[float, float]
                                    = (0.1, 80.0)
                                    ) -> Dict[str, torch.Tensor]:
    """Stats of each semantic class's pixels with GT, pooled over the
    batch: keys ``d_<metric>_c<class>``, NaN for a class absent from the
    batch (``depth_metrics.py:122-169`` of the JAX package). All classes
    are computed at once, one row per class, so nothing waits for the
    device."""
    min_depth, max_depth = depth_ranges
    gt_flat = depth_gt.reshape(-1)
    pred_flat = depth_pred.reshape(-1)
    classes = torch.arange(num_classes, device=gt_flat.device)
    mask = (semantic_gt.reshape(1, -1) == classes[:, None]) \
        & (gt_flat > 0)[None]                          # (C, N)
    count = mask.sum(dim=1)
    pred_c = pred_flat[None].expand(num_classes, -1)
    if use_gt_scale:
        ratio = (_masked_median(gt_flat[None].expand(num_classes, -1), mask)
                 / _masked_median(pred_c, mask))
        pred_c = pred_c * ratio[:, None]
    gt_c = torch.clamp(gt_flat, min_depth, max_depth)[None]
    pred_c = torch.clamp(pred_c, min_depth, max_depth)
    safe = count.clamp(min=1)

    def masked_mean(x):
        return torch.where(mask, x, 0.0).sum(dim=1) / safe

    stats = _depth_stats(gt_c, pred_c, masked_mean)
    empty = count == 0
    return {f"d_{key}_c{cls}": value[cls]
            for key, value in ((k, torch.where(empty, torch.nan, v))
                               for k, v in stats.items())
            for cls in range(num_classes)}
