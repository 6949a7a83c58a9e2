"""Mixup preparation on the device: the camera-to-camera warp and the
teacher's pseudo-labels.

Counterpart of ``codeps_tpu/tasks/mixup_prep.py``:

  - ``c2c_grid``: the normalized sampling grid of the unit-depth warp;
  - ``c2c_prewarp``: the same reprojection in float64 on the host, turned
    into the taps and weights of ``ops/grid_sample.grid_sample_pair_pre``
    (the runner caches it per camera pair, so the work and its upload
    happen once per stream);
  - ``make_plabel_prep_step``: for a stack of mixup target images, the
    teacher's semantic and instance pseudo-labels (panoptic fusion with
    the grouping kernel) warped into the source frame, in one call whose
    outputs the host composes from.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from codeps_torch.ops.grid_sample import grid_sample_pair_pre, prewarp_host
from codeps_torch.ops.normalize import maybe_normalize
from codeps_torch.ops.panoptic import panoptic_fusion_batch
from codeps_torch.tasks.adapt import teacher_labels


def c2c_grid(intr_src: torch.Tensor, intr_tgt: torch.Tensor,
             src_size: tuple[int, int],
             out_size: tuple[int, int]) -> torch.Tensor:
    """(B, out_h, out_w, 2) float32 grid for ``grid_sample`` over a
    ``src_size`` image of camera ``intr_src`` (B, 4) fx, fy, cx, cy,
    sampled at the lattice of camera ``intr_tgt`` (B, 4)
    (``mixup_prep.py:21``)."""
    out_h, out_w = out_size
    src_h, src_w = src_size
    fx_t, fy_t, cx_t, cy_t = (intr_tgt[:, i, None, None] for i in range(4))
    fx_s, fy_s, cx_s, cy_s = (intr_src[:, i, None, None] for i in range(4))
    u = torch.arange(out_w, dtype=torch.float32,
                     device=intr_src.device)[None, None, :]
    v = torch.arange(out_h, dtype=torch.float32,
                     device=intr_src.device)[None, :, None]
    u2d = (u - cx_t) / fx_t * fx_s + cx_s
    v2d = (v - cy_t) / fy_t * fy_s + cy_s
    shape = (intr_src.shape[0], out_h, out_w)
    return torch.stack([((u2d / (src_w - 1) - 0.5) * 2.0).expand(shape),
                        ((v2d / (src_h - 1) - 0.5) * 2.0).expand(shape)],
                       dim=-1)


def c2c_prewarp(intr_sampled, intr_out, sampled_size: tuple[int, int],
                out_size: tuple[int, int]) -> Dict[str, np.ndarray]:
    """Taps that warp an image of camera ``intr_sampled`` (B, 4) fx, fy,
    cx, cy at ``sampled_size`` (H, W) onto the lattice of camera
    ``intr_out`` (B, 4) at ``out_size``."""
    intr_sampled = np.asarray(intr_sampled, np.float64)
    intr_out = np.asarray(intr_out, np.float64)
    out_h, out_w = out_size
    src_h, src_w = sampled_size
    u = np.arange(out_w, dtype=np.float64)[None, None, :]
    v = np.arange(out_h, dtype=np.float64)[None, :, None]
    fx_o, fy_o = intr_out[:, 0, None, None], intr_out[:, 1, None, None]
    cx_o, cy_o = intr_out[:, 2, None, None], intr_out[:, 3, None, None]
    fx_s, fy_s = (intr_sampled[:, 0, None, None],
                  intr_sampled[:, 1, None, None])
    cx_s, cy_s = (intr_sampled[:, 2, None, None],
                  intr_sampled[:, 3, None, None])
    x = np.broadcast_to((u - cx_o) / fx_o * fx_s + cx_s,
                        (intr_out.shape[0], out_h, out_w))
    y = np.broadcast_to((v - cy_o) / fy_o * fy_s + cy_s,
                        (intr_out.shape[0], out_h, out_w))
    return prewarp_host(x, y, src_h, src_w)


def make_plabel_prep_step(thing_list, num_classes: int, mean, std):
    """The pseudo-label preparation of a frame's mixup stack
    (``mixup_prep.py:95-158``, with the camera warp).

    ``prep(teacher, rgb_tgt (Nm, Ht, Wt, 3), warp) -> (rgb (Nm, H, W, 3)
    normalized float32, semantic (Nm, H, W) int32, instance (Nm, H, W)
    int32)``: the teacher's semantic argmax and instance head, fusion
    without the merge (the grouping kernel over the whole stack), then the
    warp into the source frame at the taps of ``warp`` (``c2c_prewarp`` on
    the device): RGB bilinear with zeros padding, the label pair nearest
    with border padding, and instance zeroed where the nearest pixel falls
    outside the target image. uint8 images are normalized with
    ``mean``/``std``.
    """
    thing_list = tuple(thing_list)
    mean, std = tuple(mean), tuple(std)

    @torch.no_grad()
    def prep(teacher, rgb_tgt, warp):
        rgb_tgt = maybe_normalize(rgb_tgt, mean, std)
        sem_pred, center, offset = teacher_labels(teacher, rgb_tgt,
                                                  with_instance=True)
        _, instance, _ = panoptic_fusion_batch(
            sem_pred, center, offset, thing_list, num_classes=num_classes,
            do_merge=False)
        rgb_w, pair_w = grid_sample_pair_pre(
            rgb_tgt, torch.stack([instance, sem_pred.to(torch.int32)],
                                 dim=-1), warp)
        return (rgb_w, pair_w[..., 1],
                pair_w[..., 0] * warp["nn_inside"].to(torch.int32))

    return prep
