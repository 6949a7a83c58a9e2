"""Edge-aware disparity smoothness.

Counterpart of ``codeps_tpu/losses/smoothness.py:17
edge_aware_smoothness_loss`` (the reference's EdgeAwareSmoothnessLoss),
NCHW.
"""

from __future__ import annotations

import torch


def edge_aware_smoothness_loss(target_image: torch.Tensor,
                               disparity: torch.Tensor,
                               per_sample: bool = False) -> torch.Tensor:
    """Mean-normalized disparity gradients weighted by ``exp(-|dI|)``.

    Args:
      target_image: (B, 3, H, W).
      disparity: (B, 1, H, W).
      per_sample: return the (B,) per-sample losses instead of their mean.
    """
    mean_disp = disparity.mean(dim=(2, 3), keepdim=True)
    norm_disp = disparity / (mean_disp + 1e-7)
    grad_disp_x = torch.abs(norm_disp[..., :-1] - norm_disp[..., 1:])
    grad_disp_y = torch.abs(norm_disp[..., :-1, :] - norm_disp[..., 1:, :])
    grad_img_x = torch.mean(
        torch.abs(target_image[..., :-1] - target_image[..., 1:]),
        dim=1, keepdim=True)
    grad_img_y = torch.mean(
        torch.abs(target_image[..., :-1, :] - target_image[..., 1:, :]),
        dim=1, keepdim=True)
    loss_x = grad_disp_x * torch.exp(-grad_img_x)
    loss_y = grad_disp_y * torch.exp(-grad_img_y)
    if per_sample:
        return loss_x.mean(dim=(1, 2, 3)) + loss_y.mean(dim=(1, 2, 3))
    return loss_x.mean() + loss_y.mean()
