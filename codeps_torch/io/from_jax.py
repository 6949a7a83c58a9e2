"""Carry the JAX package's weights into the port's modules.

The inverse of ``codeps_tpu/io/convert_pth.py:58-261``, written from the
port's side: the JAX parameter and batch-stat trees (numpy arrays, keyed
by module name) become one state dict per module in the reference
checkpoint layout, which is also the layout of the port's modules:

  Flax kernel (kh, kw, I, O)      -> Conv2d weight (O, I, kh, kw)
  Flax depthwise (kh, kw, 1, C)   -> Conv2d weight (C, 1, kh, kw)
  BatchNorm scale / bias          -> weight / bias
  BatchNorm mean / var            -> running_mean / running_var

Adam's moments are trees of the parameters' structure and take the same
road (``adam_state_from_jax``).
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


def flow_head(params: Mapping) -> StateDict:
    """Flax upconv_i_0, upconv_i_1 (i = 1..4) and translation -> the
    reference's ``upconvs_0.i.0``, ``upconvs_1.i.0`` and
    ``translation_layer.0``."""
    sd: StateDict = {}
    for i in range(5):
        for j in ((0, 1) if i > 0 else (0,)):
            conv = params[f"upconv_{i}_{j}"]["conv"]
            sd[f"upconvs_{j}.{i}.0.weight"] = _conv(conv["kernel"])
            sd[f"upconvs_{j}.{i}.0.bias"] = _vec(conv["bias"])
    conv = params["translation"]["conv"]
    sd["translation_layer.0.weight"] = _conv(conv["kernel"])
    sd["translation_layer.0.bias"] = _vec(conv["bias"])
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
    two ResNet encoders (the pose encoder's conv1 over 6 or, with the
    flow head, 8 channels) and the depth, pose, flow, semantic and
    instance heads."""
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
    if "flow_head" in params:
        out["flow_head"] = flow_head(params["flow_head"])
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


def _sorted_leaves(tree) -> list:
    """Leaves of nested dicts in JAX's flattening order (sorted keys)."""
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree)
                for leaf in _sorted_leaves(tree[key])]
    return [tree]


def _unflatten_like(tree, leaves):
    """``tree`` with its leaves, in JAX's order, taken from the iterator
    ``leaves``."""
    if isinstance(tree, Mapping):
        return {key: _unflatten_like(tree[key], leaves)
                for key in sorted(tree)}
    return next(leaves)


def adam_state_from_jax(opt_leaves, params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any], live, cfg
                        ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """torch Adam state per parameter from the flat optax leaf list that
    the JAX package's ``save_checkpoint`` stores (a list, or the int-keyed
    dict Orbax makes of it).

    ``codeps_tpu/tasks/optim.build_optimizer`` is ``optax.adam`` (masked
    to the trained modules when some are frozen), so the list is Adam's
    count, its first moments over the trained modules' parameters, its
    second moments over the same, and the schedule's count when the
    learning rate is a schedule. ``live`` names those modules. Returns
    ``{module: {parameter name: {"step", "exp_avg", "exp_avg_sq"}}}`` in
    the port's layout.
    """
    if isinstance(opt_leaves, Mapping):
        opt_leaves = [opt_leaves[key] for key in sorted(opt_leaves, key=int)]
    trained = {name: params[name] for name in live}
    count = len(_sorted_leaves(trained))
    if len(opt_leaves) not in (1 + 2 * count, 2 + 2 * count):
        raise ValueError(
            f"{len(opt_leaves)} optimizer leaves do not fit Adam over the "
            f"{count} parameters of {sorted(live)}: was the run's freezing "
            "another?")
    step = int(np.asarray(opt_leaves[0]))
    moments = [state_dicts_from_jax(
        _unflatten_like(trained, iter(opt_leaves[start:start + count])),
        batch_stats, cfg) for start in (1, 1 + count)]
    return {name: {key: {"step": step, "exp_avg": value,
                         "exp_avg_sq": moments[1][name][key]}
                   for key, value in moments[0][name].items()}
            for name in live}
