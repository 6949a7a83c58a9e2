"""Model composition: build and initialize the CoDEPS modules.

Counterpart of ``codeps_tpu/models/codeps_net.py:28-178``. Modules are
addressed by the reference's names (``backbone_po_depth``,
``backbone_pose_sflow``, ``depth_head``, ``pose_head``, ``flow_head``,
``semantic_head``, ``instance_head``), so each module's ``state_dict`` is
the one a reference checkpoint stores under that name.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.codeps_ref.device import resolve_device
from benchmark.reference.codeps_ref.models.heads import (DepthHead, FlowHead, InstanceHead,
                                       PoseHead, SemanticHead)
from benchmark.reference.codeps_ref.models.precision import compute_dtype
from benchmark.reference.codeps_ref.models.resnet import ResNetEncoder, make_encoder

MODULE_NAMES = ("backbone_po_depth", "backbone_pose_sflow", "depth_head",
                "pose_head", "flow_head", "semantic_head", "instance_head")


class CodepsModules(nn.Module):
    """The CoDEPS modules; absent ones are None."""

    def __init__(self, backbone_po_depth: ResNetEncoder,
                 backbone_pose_sflow: ResNetEncoder | None,
                 depth_head: DepthHead | None,
                 pose_head: PoseHead | None,
                 flow_head: FlowHead | None,
                 semantic_head: SemanticHead | None,
                 instance_head: InstanceHead | None, num_classes: int):
        super().__init__()
        self.backbone_po_depth = backbone_po_depth
        self.backbone_pose_sflow = backbone_pose_sflow
        self.depth_head = depth_head
        self.pose_head = pose_head
        self.flow_head = flow_head
        self.semantic_head = semantic_head
        self.instance_head = instance_head
        self.num_classes = num_classes

    def module_names(self) -> list[str]:
        return [name for name in MODULE_NAMES
                if getattr(self, name) is not None]


def build_modules(cfg, num_classes: int,
                  device: str | torch.device | None = None) -> CodepsModules:
    """Construct the modules from a config tree on ``device`` (``cuda``
    unless given), in eval mode, with torch's default init; ``init_params``
    gives them seeded weights. With ``make_depth`` the pose backbone and
    the pose head come with the depth head; the pose backbone takes two
    frames stacked on the channel axis, RGB (6 channels), or RGB-D (8)
    when ``make_sflow`` adds the flow head on its pyramid
    (``codeps_tpu/models/codeps_net.py:77-91``). Every module computes in
    ``cfg.tpu.compute_dtype`` (``models/precision.py``)."""
    dev = resolve_device(device)
    with torch.device(dev):
        backbone = ResNetEncoder(cfg.model.po_depth_net.params.nof_layers)
        num_ch_enc = backbone.num_ch_enc
        backbone_pose = depth_head = pose_head = flow_head = None
        if cfg.model.make_depth:
            backbone_pose = make_encoder(
                cfg.model.pose_sflow_net.params.nof_layers,
                num_input_images=2,
                num_channels_input=4 if cfg.model.make_sflow else 3)
            depth_head = DepthHead(num_ch_enc)
            pose_head = PoseHead(backbone_pose.num_ch_enc)
            if cfg.model.make_sflow:
                flow_head = FlowHead(backbone_pose.num_ch_enc)
        semantic_head = None
        if cfg.model.make_semantic:
            semantic_head = SemanticHead(
                num_ch_enc, num_classes,
                use_guda_fusion=cfg.model.semantic_head.use_guda_fusion)
        instance_head = None
        if cfg.model.make_instance:
            instance_head = InstanceHead(
                num_ch_enc,
                use_thing_mask=cfg.model.instance_head.use_thing_mask)
    modules = CodepsModules(backbone, backbone_pose, depth_head, pose_head,
                            flow_head, semantic_head, instance_head,
                            num_classes)
    for name in modules.module_names():
        getattr(modules, name).compute_dtype = compute_dtype(cfg)
    return modules.eval()


# Std of a unit normal truncated to +-2, which variance scaling divides by.
_TRUNC_STD = 0.87962566103423978
