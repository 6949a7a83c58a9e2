"""The plain reference of the adaptation stream's first frames.

It follows the port step by step from the batches the port's runner
assembled (replay sampling, augmentation, the mixup materials and the cut
cells are the port's; the target triplet of each is checked against the
generator by itself, ``target_start_gap``): the frozen copy's modules in
float32 with TF32 off, loaded with the same seeded weights, its own
``AdaptState`` (the automask noise from a generator seeded as the port's)
and its own adaptation step and teacher eval, with the camera warp's taps
worked out again from the mixup cameras. ``precision="fp8"`` runs the same
in emulated float8 (the control); ``fault="half_batch"`` leaves out half
of each side domain's samples, the fault the check must catch, planted in
the reference put in the program's place.
"""

from __future__ import annotations

from benchmark import common, roofline
from benchmark.reference import fp8
from benchmark.reference import model as ref_model
from benchmark.reference.codeps_ref.data import labels as labels_lib
from benchmark.reference.codeps_ref.tasks.adapt import (
    batch_to_device, build_eval_forward, make_adapt_step)
from benchmark.reference.codeps_ref.tasks.mixup_prep import c2c_prewarp
from benchmark.reference.codeps_ref.tasks.state import make_adapt_state

MIXUP_KEYS = ("cut_mixup", "class_mixup", "conf_instance_mixup")
SIDE_DOMAINS = ("source", "target_replay", "mixup")


def module_lists(cfg, names):
    """(frozen, EMA-filtered) module names from the adapt flags."""
    flags = cfg.adapt.model
    frozen = [name for name, live in (
        ("backbone_po_depth", flags.backbone_po_depth),
        ("backbone_pose_sflow", flags.backbone_pose_sflow),
        ("depth_head", flags.depth), ("pose_head", flags.pose),
        ("flow_head", flags.sflow), ("semantic_head", flags.semantic),
        ("instance_head", flags.instance)) if not live and name in names]
    ema = []
    if cfg.adapt.ema.semantic and flags.semantic:
        ema.append("semantic_head")
    if cfg.adapt.ema.instance and flags.instance:
        ema.append("instance_head")
    return tuple(frozen), tuple(m for m in ema if m in names)


def classes(cfg):
    """(thing classes, number of classes, ignored classes) of the target."""
    mode, removed = cfg.dataset.label_mode, list(cfg.dataset.remove_classes)
    return (tuple(labels_lib.thing_classes(mode, removed)),
            labels_lib.num_classes(mode, removed), ())


def make_state_and_step(cfg, modules, seed, device):
    thing_list, num_classes, ignore = classes(cfg)
    frozen, ema = module_lists(cfg, modules.module_names())
    state = make_adapt_state(
        modules, cfg.train.optimizer.learning_rate, ema_modules=ema,
        frozen_modules=frozen, ema_alpha=cfg.adapt.ema.alpha, seed=seed,
        device=device)
    strategies = list(cfg.adapt.mixup.general.mixup_strategies)
    num_mixup = (cfg.adapt.mixup.general.nof_samples
                 if cfg.adapt.mixup.general.active else 0)
    groups = tuple((name, strategies.count(name)) for name in MIXUP_KEYS
                   if name in strategies) if num_mixup else ()
    fused = num_mixup > 0 and all(s in ("cut_mixup", "class_mixup")
                                  for s in strategies)
    class_weights = [w for i, w in enumerate(cfg.semantics.class_weights)
                     if i not in cfg.dataset.remove_classes]
    wise = cfg.model.make_depth and cfg.model.make_semantic
    eval_forward = build_eval_forward(cfg, thing_list, num_classes, ignore,
                                      class_wise_depth_stats=wise)
    step = make_adapt_step(
        cfg, class_weights, has_replay=True, num_mixup=num_mixup,
        mixup_groups=groups, fused_mixup=fused,
        sem_ignore_classes=list(ignore) or None, eval_forward=eval_forward)
    return state, step


def _first_half(tree):
    if isinstance(tree, dict):
        return {k: _first_half(v) for k, v in tree.items()}
    if hasattr(tree, "shape") and tree.ndim:
        return tree[:max(1, tree.shape[0] // 2)]
    return tree


def half_batch(batch):
    """The batch with the first half of each side domain's samples: the
    fault "half of the batch left out"."""
    return {k: _first_half(v) if k in SIDE_DOMAINS else v
            for k, v in batch.items()}


def readings_of(out, state, names, step_index, readings, initial):
    """Into ``readings``: a frame's loss, features and eval maps; after the
    first step the gradients Adam took, after the last the changes."""
    metrics, features, results = out[0], out[1], out[2]
    readings["loss"].append(float(metrics["loss_total"]))
    readings["terms"].append({k: float(v) for k, v in metrics.items()
                              if v.is_floating_point()})
    readings["features"].append(common.to_host(features).float())
    for key in ("depth", "semantic_soft", "panoptic"):
        readings[key].append(common.to_host(results[key]))
    if step_index == 0:
        readings["grads"] = common.adam_gradient_norms(state.optimizer,
                                                       names)


def final_readings(state, readings, initial):
    live = set(state.live_modules())
    readings["change"] = common.change_norms(
        ((n, p) for n, p in state.student.named_parameters()
         if n.split(".")[0] in live), initial)
    readings["ema_change"] = common.change_norms(
        ((n, p) for n, p in state.teacher.named_parameters()
         if n.split(".")[0] in state.ema_modules), initial)


def empty_readings():
    return {"loss": [], "terms": [], "features": [], "depth": [],
            "semantic_soft": [], "panoptic": []}


def follow(config, seed, weights, frames, device, precision="float32",
           fault=None, flops=False):
    """The reference's readings over the captured ``frames`` (each
    ``{"batch", "cameras"}``), from ``weights`` (the host state dict);
    with ``flops`` also the FLOPs of the first frame's step."""
    cfg = ref_model.reference_config(config, "float32")
    modules = ref_model.build(cfg, config["num_classes"], device)
    modules.load_state_dict(weights)
    state, step = make_state_and_step(cfg, modules, seed, device)
    names = {p: n for n, p in state.student.named_parameters()}
    initial = weights
    readings = empty_readings()
    out_size = tuple(cfg.adapt.source_dataset.feed_img_size)
    counted = None
    with fp8.precision(precision):
        for i, frame in enumerate(frames):
            batch = batch_to_device(frame["batch"], device)
            if "mixup" in batch and frame.get("cameras") is not None:
                intr_tgt, intr_src, size = frame["cameras"]
                batch["mixup"]["prewarp"] = batch_to_device(
                    c2c_prewarp(intr_tgt, intr_src, tuple(size), out_size),
                    device)
            if fault == "half_batch":
                batch = half_batch(batch)
            if flops and i == 0:
                out, counted = roofline.count_flops(
                    lambda: step(state, batch))
            else:
                out = step(state, batch)
            readings_of(out, state, names, i, readings, initial)
    final_readings(state, readings, initial)
    readings["flops"] = counted
    del state, modules
    return readings
