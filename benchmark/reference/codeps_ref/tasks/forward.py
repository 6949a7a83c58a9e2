"""Forward helpers over the port's modules.

Counterpart of ``codeps_tpu/tasks/forward.py:18-127``. A module runs in
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


def encode_frames(encoder: nn.Module, images: Sequence[torch.Tensor]
                  ) -> list[list[torch.Tensor]]:
    """Encode N frames, each (B, C, H, W), in ONE pass over B*N images,
    ordered frame by frame within each sample, as the JAX package's
    reshape of (B, N, H, W, C) orders them (``forward.py:112``). Returns
    one pyramid per frame.

    In train mode the encoder's BatchNorm takes its statistics over all
    B*N images: the frames are coupled through them, in the forward and
    in the gradient, so they must go through together with autograd on.
    In a row split the frames are this rank's slabs, and the statistics
    are those of every rank's rows of all of them.
    """
    batch, count = images[0].shape[0], len(images)
    flat = torch.stack(list(images), dim=1).flatten(0, 1)
    feats = encoder(flat)
    return [[f.unflatten(0, (batch, count))[:, i] for f in feats]
            for i in range(count)]


def depth_forward(modules, images: Sequence[torch.Tensor],
                  feats_center: Sequence[torch.Tensor],
                  feats_neighbors: Sequence[Sequence[torch.Tensor]]
                  | None = None) -> dict:
    """Depth, pose and, with a flow head, object motion over a triplet
    (the reference's DepthAlgo._forward, ``forward.py:31``).

    The pose backbone runs once on the two channel-stacked pairs
    [t-1, t] and [t, t+1] folded into one 2B batch, so its train-mode
    BatchNorm sees both pairs at once, as in the JAX package; the
    backward pair's pose is inverted. With a flow head each frame enters
    the pose backbone with its depth, detached, as a fourth channel (RGB-D;
    the neighbours' depth from the depth head on ``feats_neighbors``), and
    the flow head runs once per pair: its auto-mask thresholds at the
    mean over the batch it is given, which the 2B fold would change.

    Args:
      images: [img_t, img_tm1, img_tp1], each (B, 3, H, W), whole.
      feats_center: the depth encoder's pyramid of frame t.
      feats_neighbors: the pyramids of [t-1, t+1] (flow head only).

    Returns:
      dict with depth and disparity (B, 1, H, W) of frame t,
      transformations [T(t->t-1), T(t->t+1)], each (B, 4, 4), and
      object_motion_maps [-flow(t-1, t), flow(t, t+1)], each (B, 3, H, W),
      or None without a flow head.
    """
    depth_t, disp_t = modules.depth_head(feats_center)
    use_flow = modules.flow_head is not None
    if use_flow:
        # the depth head has no normalization layer: the neighbours'
        # depth, detached anyway, needs no graph
        with torch.no_grad():
            depths = [depth_t.detach()] + [
                modules.depth_head(f)[0] for f in feats_neighbors]
        images = [torch.cat([img, d], dim=1)
                  for img, d in zip(images, depths)]
    pair_bwd = torch.cat([images[1], images[0]], dim=1)
    pair_fwd = torch.cat([images[0], images[2]], dim=1)
    batch = images[0].shape[0]
    motion = None
    pose_feats = modules.backbone_pose_sflow(
        torch.cat([pair_bwd, pair_fwd], dim=0))
    feats_bwd = [f[:batch] for f in pose_feats]
    feats_fwd = [f[batch:] for f in pose_feats]
    t_bwd = modules.pose_head(feats_bwd, invert_pose=True)
    t_fwd = modules.pose_head(feats_fwd, invert_pose=False)
    if use_flow:
        motion = [-modules.flow_head(feats_bwd),
                  modules.flow_head(feats_fwd)]
    return {"depth": depth_t, "disparity": disp_t,
            "transformations": [t_bwd, t_fwd],
            "object_motion_maps": motion}
