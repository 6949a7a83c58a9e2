"""Disparity smoothness and the scene-flow regularizers.

Counterpart of ``codeps_tpu/losses/smoothness.py`` (the reference's
EdgeAwareSmoothnessLoss, FlowSmoothnessLoss and FlowSparsityLoss), NCHW.
"""

from __future__ import annotations

from typing import Sequence

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


def _flow_smoothness_single(flow_map: torch.Tensor,
                            wrap_around: bool = True) -> torch.Tensor:
    grad_x = flow_map - torch.roll(flow_map, shifts=1, dims=3)
    grad_y = flow_map - torch.roll(flow_map, shifts=1, dims=2)
    if not wrap_around:
        grad_x = grad_x[:, :, 1:, 1:]
        grad_y = grad_y[:, :, 1:, 1:]
    return torch.sqrt(grad_x * grad_x + grad_y * grad_y + 1e-7).mean()


def flow_smoothness_loss(flow_maps: Sequence[torch.Tensor],
                         wrap_around: bool = True) -> torch.Tensor:
    """Roll-based total variation of (B, 3, H, W) object-motion maps,
    averaged over the maps; without ``wrap_around`` the first row and
    column, whose differences wrap, are left out."""
    losses = [_flow_smoothness_single(f, wrap_around) for f in flow_maps]
    return sum(losses) / len(losses)


def _flow_sparsity_single(flow_map: torch.Tensor) -> torch.Tensor:
    abs_map = torch.abs(flow_map)
    spatial_mean = abs_map.mean(dim=(2, 3), keepdim=True).detach()
    return torch.mean(2.0 * spatial_mean
                      * torch.sqrt(abs_map / (spatial_mean + 1e-7) + 1.0))


def flow_sparsity_loss(flow_maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Group-sparsity prior on (B, 3, H, W) object-motion maps, with the
    spatial mean of each channel as a constant, averaged over the maps."""
    losses = [_flow_sparsity_single(f) for f in flow_maps]
    return sum(losses) / len(losses)
