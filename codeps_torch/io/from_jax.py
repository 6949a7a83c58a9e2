"""Carry the JAX package's weights into the port's modules.

The inverse of ``codeps_tpu/io/convert_pth.py:58-261``, written from the
port's side: the JAX parameter and batch-stat trees (numpy arrays, keyed
by module name) become one state dict per module in the reference
checkpoint layout, which is also the layout of the port's modules:

  Flax kernel (kh, kw, I, O)      -> Conv2d weight (O, I, kh, kw)
  Flax depthwise (kh, kw, 1, C)   -> Conv2d weight (C, 1, kh, kw)
  BatchNorm scale / bias          -> weight / bias
  BatchNorm mean / var            -> running_mean / running_var
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_STAGE_SIZES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(
        np.array(np.transpose(np.asarray(kernel), (3, 2, 0, 1)), order="C"))


def _vec(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value))


def _bn(sd: StateDict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _vec(params["scale"])
    sd[f"{prefix}.bias"] = _vec(params["bias"])
    sd[f"{prefix}.running_mean"] = _vec(stats["mean"])
    sd[f"{prefix}.running_var"] = _vec(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def resnet_encoder(params: Mapping, stats: Mapping,
                   num_layers: int) -> StateDict:
    sd: StateDict = {}
    sd["encoder.conv1.weight"] = _conv(params["conv1"]["conv"]["kernel"])
    _bn(sd, "encoder.bn1", params["conv1"]["bn"], stats["conv1"]["bn"])
    convs_per_block = 3 if num_layers > 34 else 2
    for stage, num_blocks in enumerate(_STAGE_SIZES[num_layers]):
        for i in range(num_blocks):
            fname = f"layer{stage + 1}_{i}"
            tprefix = f"encoder.layer{stage + 1}.{i}"
            p, s = params[fname], stats[fname]
            for c in range(1, convs_per_block + 1):
                sd[f"{tprefix}.conv{c}.weight"] = _conv(
                    p[f"conv{c}"]["conv"]["kernel"])
                _bn(sd, f"{tprefix}.bn{c}", p[f"conv{c}"]["bn"],
                    s[f"conv{c}"]["bn"])
            if "downsample" in p:
                sd[f"{tprefix}.downsample.0.weight"] = _conv(
                    p["downsample"]["conv"]["kernel"])
                _bn(sd, f"{tprefix}.downsample.1", p["downsample"]["bn"],
                    s["downsample"]["bn"])
    return sd


def _decoder_convs(sd: StateDict, params: Mapping) -> None:
    for i in range(5):
        for j in range(2):
            conv = params[f"upconv_{i}_{j}"]["conv"]
            sd[f"upconvs_{j}.{i}.0.weight"] = _conv(conv["kernel"])
            sd[f"upconvs_{j}.{i}.0.bias"] = _vec(conv["bias"])


def depth_head(params: Mapping) -> StateDict:
    sd: StateDict = {}
    _decoder_convs(sd, params)
    sd["dispconvs.0.1.weight"] = _conv(params["dispconv_0"]["kernel"])
    sd["dispconvs.0.1.bias"] = _vec(params["dispconv_0"]["bias"])
    return sd


def pose_head(params: Mapping) -> StateDict:
    """Flax squeeze/pose_0/pose_1/pose_2 -> the reference's ``net.0..3``."""
    sd: StateDict = {}
    for idx, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        sd[f"net.{idx}.weight"] = _conv(params[name]["kernel"])
        sd[f"net.{idx}.bias"] = _vec(params[name]["bias"])
    return sd


def semantic_head(params: Mapping, use_guda_fusion: bool) -> StateDict:
    sd: StateDict = {}
    _decoder_convs(sd, params)
    if use_guda_fusion:
        sd["semconv_guda.weight"] = _conv(params["semconv_guda"]["kernel"])
        sd["semconv_guda.bias"] = _vec(params["semconv_guda"]["bias"])
    else:
        sd["semconv.1.weight"] = _conv(params["semconv"]["kernel"])
        sd["semconv.1.bias"] = _vec(params["semconv"]["bias"])
    return sd


def _dw_separable(sd: StateDict, prefix: str, params: Mapping,
                  stats: Mapping) -> None:
    """Flax depthwise/bn1/pointwise/bn2 -> Sequential indices 0, 1, 3, 4."""
    sd[f"{prefix}.0.weight"] = _conv(params["depthwise"]["kernel"])
    _bn(sd, f"{prefix}.1", params["bn1"], stats["bn1"])
    sd[f"{prefix}.3.weight"] = _conv(params["pointwise"]["kernel"])
    _bn(sd, f"{prefix}.4", params["bn2"], stats["bn2"])


def instance_head(params: Mapping, stats: Mapping,
                  use_thing_mask: bool) -> StateDict:
    sd: StateDict = {}
    dec_p, dec_s = params["decoder"], stats["decoder"]
    sd["decoder.net.conv.0.weight"] = _conv(dec_p["conv"]["kernel"])
    for i in range(3):
        sd[f"decoder.net.project_{i}.0.weight"] = _conv(
            dec_p[f"project_{i}_conv"]["kernel"])
        _bn(sd, f"decoder.net.project_{i}.1", dec_p[f"project_{i}_bn"],
            dec_s[f"project_{i}_bn"])
        _dw_separable(sd, f"decoder.net.fuse_{i}", dec_p[f"fuse_{i}"],
                      dec_s[f"fuse_{i}"])
    heads = [("center_head", "center_head"), ("offset_head", "offset_head")]
    if use_thing_mask:
        heads.append(("thing_mask_head", "thing_mask_head.0"))
    for fname, tname in heads:
        _dw_separable(sd, f"{tname}.net.depth_conv",
                      params[fname]["depth_conv"], stats[fname]["depth_conv"])
        sd[f"{tname}.net.conv.weight"] = _conv(params[fname]["conv"]["kernel"])
        sd[f"{tname}.net.conv.bias"] = _vec(params[fname]["conv"]["bias"])
    return sd


def state_dicts_from_jax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any],
                         cfg) -> Dict[str, StateDict]:
    """{module_name: state_dict} for every module of the JAX trees: the
    two ResNet encoders and the depth, pose, semantic and instance heads.
    The flow head is not ported yet and is skipped."""
    out: Dict[str, StateDict] = {}
    if "backbone_po_depth" in params:
        out["backbone_po_depth"] = resnet_encoder(
            params["backbone_po_depth"], batch_stats["backbone_po_depth"],
            cfg.model.po_depth_net.params.nof_layers)
    if "backbone_pose_sflow" in params:
        out["backbone_pose_sflow"] = resnet_encoder(
            params["backbone_pose_sflow"],
            batch_stats["backbone_pose_sflow"],
            cfg.model.pose_sflow_net.params.nof_layers)
    if "depth_head" in params:
        out["depth_head"] = depth_head(params["depth_head"])
    if "pose_head" in params:
        out["pose_head"] = pose_head(params["pose_head"])
    if "semantic_head" in params:
        out["semantic_head"] = semantic_head(
            params["semantic_head"], cfg.model.semantic_head.use_guda_fusion)
    if "instance_head" in params:
        out["instance_head"] = instance_head(
            params["instance_head"], batch_stats["instance_head"],
            cfg.model.instance_head.use_thing_mask)
    return out


def load_from_jax(modules, params: Mapping[str, Any],
                  batch_stats: Mapping[str, Any], cfg):
    """Fill every module of ``modules`` (a ``CodepsModules``) strictly from
    the JAX trees; returns ``modules``."""
    state_dicts = state_dicts_from_jax(params, batch_stats, cfg)
    for name in modules.module_names():
        getattr(modules, name).load_state_dict(state_dicts[name], strict=True)
    return modules
