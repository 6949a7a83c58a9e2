"""Task heads (NCHW): depth, pose, scene flow, semantic, instance.

Counterpart of ``codeps_tpu/models/heads.py:148-454``. Where the JAX
package evaluates a layer through a TPU
rewrite (block-phase convs, commuted upsampling), this is the plain form
that rewrite was proven equal to; the adaptation step trains through
these plain forms too:

  - DepthHead's full-resolution tail is upconv_0_0, nearest 2x, a
    zero-padded 3x3 conv + ELU (upconv_0_1), a reflect-padded 3x3
    dispconv_0, a sigmoid and ``disp_to_depth``;
  - every other conv + ELU of the depth and semantic decoders is
    zero-padded, as in the JAX package;
  - SemanticHead with GUDA fusion bilinearly resizes the four decoder
    stages (i = 3..0) to full resolution, concatenates them, and runs one
    zero-padded 3x3 conv plus bias, then a float32 softmax;
  - the instance sub-heads apply their 1x1 conv before the last 2x
    align-corners upsampling, as the JAX package does;
  - the flow head pads every conv by reflection and upsamples bilinearly
    with ``align_corners=True``, unlike the depth decoder.

Each head runs its body in its ``compute_dtype`` (``models/precision.py``)
and returns float32 (float64 for float64 modules, ``precision.widened``),
as the JAX heads cast their full-resolution outputs; the pose head builds
its transform from float32 parameters.

Parameter names follow the reference checkpoints (``upconvs_1.4.0.weight``,
``semconv_guda.weight``, ``net.3.bias`` of the pose head,
``decoder.net.fuse_0.3.weight``, ``center_head.net.conv.bias``,
``translation_layer.0.weight`` of the flow head). The depth head keeps
only ``dispconvs.0``: the coarser disparities feed nothing.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.codeps_ref.geometry.pose import transformation_from_parameters
from benchmark.reference.codeps_ref.models.precision import ComputeDtype, widened
from benchmark.reference.codeps_ref.models.resnet import BatchNorm2d
from benchmark.reference.codeps_ref.ops.resize import (resize_bilinear_nchw,
                                     upsample_nearest_2x_nchw)

_DEC_CHANNELS = (16, 32, 64, 128, 256)


def _conv_elu(in_ch: int, out_ch: int, padding: int = 1) -> nn.Sequential:
    """3x3 conv + ELU (the reference's ``upconvs_j.i``), zero-padded."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, padding=padding),
                         nn.ELU())


def _reflect_pad(x: torch.Tensor) -> torch.Tensor:
    """1-pixel reflection padding of (B, C, H, W), as ``jnp.pad``'s
    ``"reflect"``: an axis of length 1 (a small input's coarsest
    features) repeats its one value, where torch's reflection refuses."""
    height, width = x.shape[-2:]
    if height > 1 and width > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = F.pad(x, (1, 1, 0, 0), mode="reflect" if width > 1 else "replicate")
    return F.pad(x, (0, 0, 1, 1), mode="reflect" if height > 1
                 else "replicate")


def disp_to_depth(disp: torch.Tensor, min_depth: float = 0.1,
                  max_depth: float = 100.0) -> torch.Tensor:
    """Sigmoid disparity -> depth in [min_depth, max_depth]."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


def _decoder_convs(num_ch_enc: Sequence[int], use_skips: bool):
    """The upconvs_0 / upconvs_1 lists shared by the depth and semantic
    decoders, indexed by scale i = 0..4."""
    upconvs_0, upconvs_1 = [], []
    for i in range(5):
        in_0 = num_ch_enc[-1] if i == 4 else _DEC_CHANNELS[i + 1]
        upconvs_0.append(_conv_elu(in_0, _DEC_CHANNELS[i]))
        in_1 = _DEC_CHANNELS[i]
        if use_skips and i > 0:
            in_1 += num_ch_enc[i - 1]
        upconvs_1.append(_conv_elu(in_1, _DEC_CHANNELS[i]))
    return nn.ModuleList(upconvs_0), nn.ModuleList(upconvs_1)


class DepthHead(ComputeDtype, nn.Module):
    """Monodepth2-style decoder with skips; returns (depth, disparity),
    each (B, 1, H, W) float32 at the input image's resolution."""

    def __init__(self, num_ch_enc: Sequence[int], use_skips: bool = True):
        super().__init__()
        self.use_skips = use_skips
        self.upconvs_0, self.upconvs_1 = _decoder_convs(num_ch_enc,
                                                        use_skips)
        self.dispconvs = nn.ModuleList([nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(_DEC_CHANNELS[0], 1, 3))])

    def forward(self, feats: Sequence[torch.Tensor]):
        x = feats[-1]
        with self.autocast(x):
            for i in range(4, -1, -1):
                x = upsample_nearest_2x_nchw(self.upconvs_0[i](x))
                if self.use_skips and i > 0:
                    x = torch.cat([x, feats[i - 1]], dim=1)
                x = self.upconvs_1[i](x)
            x = self.dispconvs[0](x)
        disp = torch.sigmoid(widened(x))
        return disp_to_depth(disp), disp


class SemanticHead(ComputeDtype, nn.Module):
    """Depth-decoder mirror with optional GUDA multi-scale fusion; returns
    softmax probabilities (B, C, H, W) float32 (the reference's CE applies
    log_softmax to these again)."""

    def __init__(self, num_ch_enc: Sequence[int], num_classes: int,
                 use_skips: bool = True, use_guda_fusion: bool = False):
        super().__init__()
        self.use_skips = use_skips
        self.use_guda_fusion = use_guda_fusion
        self.upconvs_0, self.upconvs_1 = _decoder_convs(num_ch_enc,
                                                        use_skips)
        if use_guda_fusion:
            self.semconv_guda = nn.Conv2d(sum(_DEC_CHANNELS[:4]),
                                          num_classes, 3, padding=1)
        else:
            self.semconv = nn.Sequential(
                nn.ReflectionPad2d(1),
                nn.Conv2d(_DEC_CHANNELS[0], num_classes, 3))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = feats[-1]
        stages = []
        with self.autocast(x):
            for i in range(4, -1, -1):
                x = upsample_nearest_2x_nchw(self.upconvs_0[i](x))
                if self.use_skips and i > 0:
                    x = torch.cat([x, feats[i - 1]], dim=1)
                x = self.upconvs_1[i](x)
                if i < 4:
                    stages.append(x)
            if self.use_guda_fusion:
                out_res = tuple(x.shape[-2:])
                fused = torch.cat([resize_bilinear_nchw(f, out_res)
                                   for f in stages], dim=1)
                logits = self.semconv_guda(fused)
            else:
                logits = self.semconv(x)
        return torch.softmax(widened(logits), dim=1)


class PoseHead(ComputeDtype, nn.Module):
    """Squeeze + three convs + spatial mean -> 0.01 x (axis-angle,
    translation) -> (B, 4, 4) SE(3) transform.

    Counterpart of ``codeps_tpu/models/heads.py:201-231``. As in the
    reference (built with ``num_frames_to_predict_for=2``), the last conv
    emits 12 channels and only the first frame's six parameters are used.
    """

    def __init__(self, num_ch_enc: Sequence[int],
                 num_frames_to_predict_for: int = 2):
        super().__init__()
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1)])

    def forward(self, feats: Sequence[torch.Tensor],
                invert_pose: bool = False) -> torch.Tensor:
        x = feats[-1]
        with self.autocast(x):
            for conv in self.net[:-1]:
                x = torch.relu(conv(x))
            x = self.net[-1](x)
        out = 0.01 * widened(x).mean(dim=(2, 3))
        return transformation_from_parameters(out[:, :3], out[:, 3:6],
                                              invert=invert_pose)


class FlowHead(ComputeDtype, nn.Module):
    """Object-motion (masked scene-flow) decoder on the pose net's
    pyramid; returns (B, 3, H, W) float32 motion at the pair's input
    resolution.

    Counterpart of ``codeps_tpu/models/heads.py:234-275``: reflect-padded
    3x3 convs + ELU, bilinear ``align_corners=True`` 2x upsampling, skips,
    ``upconvs_1`` only at scales 1..4, the last conv + ELU to 3 channels
    (``translation_layer``), scaled by 0.001. The auto-mask keeps a pixel
    only where its motion norm is strictly greater than the mean norm
    over the whole batch it is given, so the masks of two pairs depend on
    whether they go through together.
    """

    def __init__(self, num_ch_enc: Sequence[int], auto_mask: bool = True):
        super().__init__()
        self.auto_mask = auto_mask
        upconvs_0, upconvs_1 = [], {}
        for i in range(5):
            in_0 = num_ch_enc[-1] if i == 4 else _DEC_CHANNELS[i + 1]
            upconvs_0.append(_conv_elu(in_0, _DEC_CHANNELS[i], padding=0))
            if i > 0:
                upconvs_1[str(i)] = _conv_elu(
                    _DEC_CHANNELS[i] + num_ch_enc[i - 1], _DEC_CHANNELS[i],
                    padding=0)
        self.upconvs_0 = nn.ModuleList(upconvs_0)
        self.upconvs_1 = nn.ModuleDict(upconvs_1)
        self.translation_layer = _conv_elu(_DEC_CHANNELS[0], 3, padding=0)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = feats[-1]
        with self.autocast(x):
            for i in range(4, -1, -1):
                x = _upsample_2x_align(self.upconvs_0[i](_reflect_pad(x)))
                if i > 0:
                    x = torch.cat([x, feats[i - 1]], dim=1)
                    x = self.upconvs_1[str(i)](_reflect_pad(x))
            x = self.translation_layer(_reflect_pad(x))
        flow = 0.001 * widened(x)
        if self.auto_mask:
            norm = torch.sqrt((flow * flow).sum(dim=1, keepdim=True))
            mean = norm.detach().mean()
            flow = flow * (norm > mean).to(flow.dtype)
        return flow


def _depthwise_separable(in_ch: int, out_ch: int) -> nn.Sequential:
    """5x5 depthwise + BN + ReLU + 1x1 pointwise + BN + ReLU."""
    return nn.Sequential(
        nn.Conv2d(in_ch, in_ch, 5, padding=2, groups=in_ch, bias=False),
        BatchNorm2d(in_ch), nn.ReLU(inplace=True),
        nn.Conv2d(in_ch, out_ch, 1, bias=False),
        BatchNorm2d(out_ch), nn.ReLU(inplace=True))


class _InstanceDecoder(nn.Module):
    """Panoptic-DeepLab shared decoder."""

    NUM_CH_PROJECT = (64, 32, 16)
    NUM_CH_DEC = (256, 128, 128)

    def __init__(self, num_ch_enc: Sequence[int]):
        super().__init__()
        net = {"conv": nn.Sequential(
            nn.Conv2d(num_ch_enc[-1], self.NUM_CH_DEC[0], 1, bias=False))}
        feat_ch = self.NUM_CH_DEC[0]
        for i in range(3):
            proj = self.NUM_CH_PROJECT[i]
            net[f"project_{i}"] = nn.Sequential(
                nn.Conv2d(num_ch_enc[-(i + 2)], proj, 1, bias=False),
                BatchNorm2d(proj), nn.ReLU(inplace=True))
            net[f"fuse_{i}"] = _depthwise_separable(feat_ch + proj,
                                                    self.NUM_CH_DEC[i])
            feat_ch = self.NUM_CH_DEC[i]
        self.net = nn.ModuleDict(net)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self.net["conv"](feats[-1])
        for i in range(3):
            skip = self.net[f"project_{i}"](feats[-(i + 2)])
            x = resize_bilinear_nchw(x, tuple(skip.shape[-2:]),
                                     align_corners=True)
            x = self.net[f"fuse_{i}"](torch.cat([x, skip], dim=1))
        return x


def _upsample_2x_align(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    return resize_bilinear_nchw(x, (2 * h, 2 * w), align_corners=True)


class _InstanceSubHead(nn.Module):
    """Upsample 2x -> depthwise separable -> 1x1 conv -> upsample 2x."""

    def __init__(self, in_ch: int, num_outputs: int):
        super().__init__()
        self.net = nn.ModuleDict({
            "depth_conv": _depthwise_separable(in_ch, 32),
            "conv": nn.Conv2d(32, num_outputs, 1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.net["depth_conv"](_upsample_2x_align(x))
        return _upsample_2x_align(self.net["conv"](x))


class InstanceHead(ComputeDtype, nn.Module):
    """Center heatmap (B, 1, H, W), offsets (B, 2, H, W) as (dy, dx), and
    optionally thing-mask probabilities (B, 2, H, W), all float32."""

    def __init__(self, num_ch_enc: Sequence[int],
                 use_thing_mask: bool = False):
        super().__init__()
        self.decoder = _InstanceDecoder(num_ch_enc)
        dec_ch = _InstanceDecoder.NUM_CH_DEC[-1]
        self.center_head = _InstanceSubHead(dec_ch, 1)
        self.offset_head = _InstanceSubHead(dec_ch, 2)
        self.thing_mask_head = (nn.Sequential(_InstanceSubHead(dec_ch, 2))
                                if use_thing_mask else None)

    def forward(self, feats: Sequence[torch.Tensor]):
        with self.autocast(feats[-1]):
            x = self.decoder(feats)
            center = self.center_head(x)
            offset = self.offset_head(x)
            thing_logits = (None if self.thing_mask_head is None
                            else self.thing_mask_head(x))
        thing_mask = None
        if thing_logits is not None:
            thing_mask = torch.softmax(widened(thing_logits), dim=1)
        return widened(center), widened(offset), thing_mask
