"""Forward helpers over the port's modules.

Counterpart of ``codeps_tpu/tasks/forward.py:18-109``. A module runs in
the mode it is in: the caller puts it in train or eval mode, as the JAX
functions' ``train`` flag does; train-mode BatchNorm leaves its running
statistics alone (``models/resnet.py keep_running_stats``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def apply_encoder(encoder: nn.Module,
                  images: torch.Tensor) -> list[torch.Tensor]:
    """Run an encoder on (B, H, W, C) images; returns its NCHW feature
    pyramid, the layout the heads take."""
    return encoder(images.permute(0, 3, 1, 2).contiguous())


def depth_forward(modules, images: Sequence[torch.Tensor],
                  feats_center: Sequence[torch.Tensor]) -> dict:
    """Depth and pose over a triplet (the reference's DepthAlgo._forward
    without the flow head).

    The pose backbone runs once on the two channel-stacked pairs
    [t-1, t] and [t, t+1] folded into one 2B batch, so its train-mode
    BatchNorm sees both pairs at once, as in the JAX package; the
    backward pair's pose is inverted.

    Args:
      images: [img_t, img_tm1, img_tp1], each (B, 3, H, W).
      feats_center: the depth encoder's pyramid of frame t.

    Returns:
      dict with depth and disparity (B, 1, H, W) of frame t and
      transformations [T(t->t-1), T(t->t+1)], each (B, 4, 4).
    """
    depth_t, disp_t = modules.depth_head(feats_center)
    pair_bwd = torch.cat([images[1], images[0]], dim=1)
    pair_fwd = torch.cat([images[0], images[2]], dim=1)
    pose_feats = modules.backbone_pose_sflow(
        torch.cat([pair_bwd, pair_fwd], dim=0))
    batch = images[0].shape[0]
    t_bwd = modules.pose_head([f[:batch] for f in pose_feats],
                              invert_pose=True)
    t_fwd = modules.pose_head([f[batch:] for f in pose_feats],
                              invert_pose=False)
    return {"depth": depth_t, "disparity": disp_t,
            "transformations": [t_bwd, t_fwd]}
