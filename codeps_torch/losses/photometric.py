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

Inside a row split (``parallel/spatial.py``) ``reconstruction_loss``
takes the frames and the motion whole and the depth as this rank's slab
of rows: each scale's images, motion and the gathered depth are resized
whole and
cut to this rank's rows, so those rows equal the one-process rows bit for
bit; the SSIM pools read the neighbouring slabs' rows, the warp samples
the whole neighbour frames, the noise is this rank's rows of the whole
draw, and the loss is this rank's share. Inside ``spatial.images()``
every input is this rank's images, the noise is its images of the draw
at the whole batch's shape, and the loss is its share.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from codeps_torch.geometry.camera import scale_intrinsics_to_size
from codeps_torch.geometry.warp import warp_image
from codeps_torch.models.precision import loss_dtype, widened
from codeps_torch.ops.resize import resize_bilinear_nchw, resize_nearest_nchw
from codeps_torch.parallel import spatial

_SSIM_C1 = 0.01 ** 2
_SSIM_C2 = 0.03 ** 2

NoiseFn = Callable[[tuple], torch.Tensor]


def _avg_pool_3x3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool after a 1-pixel reflection pad."""
    if spatial.active():
        # the rows first, at the level's width
        def pool(rows):
            return F.avg_pool2d(F.pad(rows, (1, 1, 0, 0), mode="reflect"),
                                3, 1)
        ext = spatial.halo_rows(x, 1, 1, "reflect")
        return pool(ext) if x.shape[-2] else spatial.on_empty(pool, ext, 3)
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, 1)


def _rows_at(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """This rank's rows of the whole ``x`` resized to ``size``."""
    with spatial.whole():
        x = resize_bilinear_nchw(x, size)
    return spatial.rows_of(x)


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
    depth_map = spatial.gather_rows(depth_map)
    total = torch.zeros((batch,) if per_sample else (),
                        device=images[0].device)
    for s in range(num_scales):
        size = (height // 2 ** s, width // 2 ** s)
        intr_s = scale_intrinsics_to_size(intrinsics, (height, width), size)
        target_s = _rows_at(target, size)
        depth_s = _rows_at(depth_map, size)
        tstats = ssim_target_stats(target_s)

        recon_losses, frames_s = [], []
        for i, frame in enumerate(images[1:]):
            with spatial.whole():
                frame_s = resize_bilinear_nchw(frame.to(dtype), size)
            frames_s.append(spatial.rows_of(frame_s))
            motion_s = None
            if object_motion_maps is not None:
                motion_s = _rows_at(object_motion_maps[i], size)
            pred = warp_image(intr_s, widened(frame_s), depth_s, poses[i],
                              object_motion=motion_s)
            recon_losses.append(widened(photometric_error(
                pred.to(dtype), target_s, alpha, tstats)))
        identity = widened(torch.cat([
            photometric_error(f, target_s, alpha, tstats)
            for f in frames_s], dim=1))
        if identity_noise_scale:
            if noise is not None:
                draw = spatial.noise_of(noise)(tuple(identity.shape)).to(
                    identity.device)
            else:
                draw = spatial.normal_of(identity.shape, generator,
                                           identity.device)
            identity = identity + draw * identity_noise_scale
        combined = torch.cat(recon_losses + [identity], dim=1)
        per_pixel = torch.amin(combined, dim=1)
        if per_sample:
            total = total + spatial.mean(per_pixel, (1, 2)) / 2 ** s
        else:
            total = total + spatial.mean(per_pixel) / 2 ** s
    return total / num_scales


def _class_map(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) or (B, 1, H, W) labels -> (B, 1, H, W) float32."""
    mask = mask.to(torch.float32)
    return mask[:, None] if mask.ndim == 3 else mask


def reconstruction_loss_semantic(intrinsics: torch.Tensor,
                                 semantic_masks: Sequence[torch.Tensor],
                                 depth_map: torch.Tensor,
                                 poses: Sequence[torch.Tensor],
                                 num_scales: int = 5,
                                 alpha: float = 0.85) -> torch.Tensor:
    """The semantic-mask variant of the reconstruction loss, without the
    automask (``photometric.py:203``; the reference's ``semantic_mask``
    branch): per scale the class maps are resized by nearest, the
    neighbours' warped with nearest sampling, and the photometric error
    taken on the float class maps; scales weighted as in
    ``reconstruction_loss``.

    Args:
      semantic_masks: [t, t-1, t+1] labels, each (B, H, W) or (B, 1, H, W).
      depth_map: (B, 1, H, W) depth of frame t.
      poses: [T(t->t-1), T(t->t+1)], each (B, 4, 4).
    """
    height, width = depth_map.shape[-2:]
    target = _class_map(semantic_masks[0])
    total = torch.zeros((), device=depth_map.device)
    for s in range(num_scales):
        size = (height // 2 ** s, width // 2 ** s)
        intr_s = scale_intrinsics_to_size(intrinsics, (height, width), size)
        target_s = resize_nearest_nchw(target, size)
        depth_s = resize_bilinear_nchw(depth_map, size)
        tstats = ssim_target_stats(target_s)
        losses = []
        for i, frame in enumerate(semantic_masks[1:]):
            frame_s = resize_nearest_nchw(_class_map(frame), size)
            pred = warp_image(intr_s, frame_s, depth_s, poses[i],
                              interp_mode="nearest")
            losses.append(photometric_error(pred, target_s, alpha, tstats))
        total = total + torch.cat(losses, dim=1).mean() / 2 ** s
    return total / num_scales
