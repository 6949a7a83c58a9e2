"""Photometric (view-reconstruction) losses.

Counterpart of ``codeps_tpu/losses/photometric.py:31-244`` (the
reference's SSIMLoss and ReconstructionLoss, with its semantic-mask
variant), NCHW. As there, the image-space math (pyramids, warp payload,
SSIM and L1) runs in the ``dtype`` the caller passes, the compute dtype
of the config; geometry, the automask's minimum with its noise, and the
means stay float32.

The automask's identity tie-break noise (Monodepth2, 1e-5 normals) is
drawn from a ``torch.Generator``, or taken from an injected ``noise``
callable that returns a tensor of the shape it is asked for.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.codeps_ref.geometry.camera import scale_intrinsics_to_size
from benchmark.reference.codeps_ref.geometry.warp import warp_image
from benchmark.reference.codeps_ref.models.precision import loss_dtype, widened
from benchmark.reference.codeps_ref.ops.resize import resize_bilinear_nchw

_SSIM_C1 = 0.01 ** 2
_SSIM_C2 = 0.03 ** 2

NoiseFn = Callable[[tuple], torch.Tensor]


def _avg_pool_3x3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool after a 1-pixel reflection pad."""
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, 1)


def ssim_target_stats(target_img: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The target-side SSIM pools ``(mu_y, pool(y*y))``, shared by the four
    photometric errors of one scale."""
    return (_avg_pool_3x3_reflect(target_img),
            _avg_pool_3x3_reflect(target_img * target_img))


def ssim(src_img: torch.Tensor, target_img: torch.Tensor,
         target_stats: tuple[torch.Tensor, torch.Tensor] | None = None
         ) -> torch.Tensor:
    """SSIM dissimilarity ``clamp((1 - SSIM) / 2, 0, 1)`` per pixel and
    channel."""
    mu_x = _avg_pool_3x3_reflect(src_img)
    if target_stats is None:
        target_stats = ssim_target_stats(target_img)
    mu_y, pool_y2 = target_stats
    sigma_x = _avg_pool_3x3_reflect(src_img * src_img) - mu_x * mu_x
    sigma_y = pool_y2 - mu_y * mu_y
    sigma_xy = _avg_pool_3x3_reflect(src_img * target_img) - mu_x * mu_y
    ssim_n = (2.0 * mu_x * mu_y + _SSIM_C1) * (2.0 * sigma_xy + _SSIM_C2)
    ssim_d = ((mu_x * mu_x + mu_y * mu_y + _SSIM_C1)
              * (sigma_x + sigma_y + _SSIM_C2))
    return torch.clamp((1.0 - ssim_n / ssim_d) / 2.0, 0.0, 1.0)


def photometric_error(pred_img: torch.Tensor, target_img: torch.Tensor,
                      alpha: float = 0.85,
                      target_stats: tuple[torch.Tensor, torch.Tensor]
                      | None = None) -> torch.Tensor:
    """``alpha * SSIM + (1 - alpha) * L1``, channel-averaged: (B, 1, H, W)."""
    l1 = torch.mean(torch.abs(pred_img - target_img), dim=1, keepdim=True)
    ssim_term = torch.mean(ssim(pred_img, target_img, target_stats), dim=1,
                           keepdim=True)
    return alpha * ssim_term + (1.0 - alpha) * l1


def reconstruction_loss(intrinsics: torch.Tensor,
                        images: Sequence[torch.Tensor],
                        depth_map: torch.Tensor,
                        poses: Sequence[torch.Tensor],
                        object_motion_maps: Sequence[torch.Tensor]
                        | None = None,
                        num_scales: int = 5,
                        alpha: float = 0.85,
                        identity_noise_scale: float = 1e-5,
                        per_sample: bool = False,
                        generator: torch.Generator | None = None,
                        noise: NoiseFn | None = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Multi-scale photometric loss with Monodepth2 auto-masking.

    The full-resolution depth is downscaled to each pyramid level. Per
    scale s the per-pixel loss is the minimum over the two warped
    neighbors' errors and the two identity errors plus noise, its mean is
    weighted by 1 / 2**s, and the sum is divided by ``num_scales``.

    Args:
      intrinsics: (B, 4) at the input resolution.
      images: the triplet [t, t-1, t+1], each (B, 3, H, W).
      depth_map: (B, 1, H, W) depth of frame t.
      poses: [T(t->t-1), T(t->t+1)], each (B, 4, 4).
      object_motion_maps: optional pair of (B, 3, H, W) scene-flow maps,
        whole in a row split.
      per_sample: return the (B,) per-sample losses instead of their mean.
      generator: source of the identity noise when ``noise`` is None.
      noise: callable ``shape -> tensor`` giving the (B, 2, h, w) identity
        noise of each scale in turn, in place of the generator.
      dtype: element type of the image-space math (float64 for float64
        images). The warp samples in
        float32 (its taps are the image's values) and its result comes
        back to ``dtype``; the errors go to float32 before the automask,
        whose 1e-5 noise bfloat16 could not resolve.

    Returns:
      scalar float32 loss, or (B,) with ``per_sample``.
    """
    batch, _, height, width = images[0].shape
    dtype = loss_dtype(dtype, images[0])
    target = images[0].to(dtype)
    total = torch.zeros((batch,) if per_sample else (),
                        device=images[0].device)
    for s in range(num_scales):
        size = (height // 2 ** s, width // 2 ** s)
        intr_s = scale_intrinsics_to_size(intrinsics, (height, width), size)
        target_s = resize_bilinear_nchw(target, size)
        depth_s = resize_bilinear_nchw(depth_map, size)
        tstats = ssim_target_stats(target_s)

        recon_losses, frames_s = [], []
        for i, frame in enumerate(images[1:]):
            frame_s = resize_bilinear_nchw(frame.to(dtype), size)
            frames_s.append(frame_s)
            motion_s = None
            if object_motion_maps is not None:
                motion_s = resize_bilinear_nchw(object_motion_maps[i], size)
            pred = warp_image(intr_s, widened(frame_s), depth_s, poses[i],
                              object_motion=motion_s)
            recon_losses.append(widened(photometric_error(
                pred.to(dtype), target_s, alpha, tstats)))
        identity = widened(torch.cat([
            photometric_error(f, target_s, alpha, tstats)
            for f in frames_s], dim=1))
        if identity_noise_scale:
            if noise is not None:
                draw = noise(tuple(identity.shape)).to(identity.device)
            else:
                draw = torch.randn(tuple(identity.shape),
                                   generator=generator,
                                   device=identity.device)
            identity = identity + draw * identity_noise_scale
        combined = torch.cat(recon_losses + [identity], dim=1)
        per_pixel = torch.amin(combined, dim=1)
        if per_sample:
            total = total + per_pixel.mean((1, 2)) / 2 ** s
        else:
            total = total + per_pixel.mean() / 2 ** s
    return total / num_scales
