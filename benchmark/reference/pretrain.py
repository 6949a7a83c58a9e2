"""The plain reference of pretraining's first steps.

It works each batch out again from the seed: the same item order (the
loader's shuffle of the epoch), the same augmentation draws (one seed a
batch, as the loader's worker processes seed ``random``; or the run's
seed, as the benchmark seeds ``random`` for the loader's thread), the
frozen
copy's Cityscapes reader on the same raw frames and its collation; then
the copy's modules in float32 with TF32 off from the same seeded weights,
its own ``TrainState`` (the automask noise from a generator seeded as the
port's) and its own train step. ``precision="fp8"`` runs the same in
emulated float8 (the control); ``fault="half_batch"`` trains on the first
half of each batch, the mean taken over it.
"""

from __future__ import annotations

import random

import numpy as np

from benchmark import common, roofline
from benchmark.reference import fp8
from benchmark.reference import model as ref_model
from benchmark.reference.codeps_ref.data.loader import (DataLoader,
                                                        collate_batch)
from benchmark.reference.codeps_ref.tasks.optim import build_schedule
from benchmark.reference.codeps_ref.tasks.state import make_train_state
from benchmark.reference.codeps_ref.tasks.train import make_train_step
from benchmark.reference.readers import MemoryCityscapes

BN_BUFFERS = ("running_mean", "running_var")
# heads whose first output of the first step is compared
HEADS = ("semantic_head", "depth_head")


def head_hooks(modules, store: dict):
    """Forward hooks that keep, on the host, each head's first output
    (the first of a tuple) once; remove them when the step is done."""
    hooks = []
    for name in HEADS:
        module = getattr(modules, name, None)
        if module is None:
            continue

        def keep(mod, args, out, name=name):
            if name not in store:
                first = out[0] if isinstance(out, (tuple, list)) else out
                store[name] = first.detach().float().cpu()
        hooks.append(module.register_forward_hook(keep))
    return hooks


def task_seed(seed: int, epoch: int, shard: int, batch: int) -> int:
    """The loader's augmentation seed of a batch."""
    seq = np.random.SeedSequence([seed, epoch, shard, batch])
    return int(seq.generate_state(1)[0])


def batches(config, traffic, seed, count, stream):
    """The first ``count`` batches of the epoch, as the loader makes them:
    with worker processes each batch's augmentation seeded by itself, with
    the loader's thread drawn in item order from the module generator
    seeded with the run's seed."""
    cfg = ref_model.reference_config(config, "float32")
    dataset = MemoryCityscapes(cfg.dataset, "train", traffic["epoch_items"],
                               seed, stream)
    dataset.return_only_rgb = cfg.dataset.return_only_rgb
    size = cfg.train.batch_size_per_gpu
    loader = DataLoader(dataset, size, cfg.dataset.offsets, shuffle=True,
                        seed=seed)
    indices = loader._indices()
    offsets = list(cfg.dataset.offsets)
    workers = cfg.train.nof_workers_per_gpu
    # a generator of its own: the port's loader thread may still draw from
    # the module generator while the reference runs
    rng = random.Random(seed)
    out = []
    for i in range(count):
        if workers:
            rng = random.Random(task_seed(seed, 0, 0, i))
        items = [dataset.__getitem__(int(j), rng=rng)
                 for j in indices[i * size:(i + 1) * size]]
        out.append(collate_batch(items, offsets))
    return out, len(loader)


def make_state_and_step(cfg, modules, steps_per_epoch, seed, device):
    class_weights = [w for i, w in enumerate(cfg.semantics.class_weights)
                     if i not in cfg.dataset.remove_classes]
    state = make_train_state(modules, build_schedule(cfg, steps_per_epoch),
                             seed=seed, device=device)
    step = make_train_step(cfg, class_weights, sem_ignore_classes=None,
                           num_classes=modules.num_classes,
                           eval_ignore_classes=[])
    return state, step


def half_batch(batch):
    return {k: v[:max(1, v.shape[0] // 2)] if hasattr(v, "shape")
            and v.ndim else v for k, v in batch.items()}


def empty_readings():
    return {"loss": [], "terms": [], "heads": {}}


def bn_changes(modules, initial) -> dict:
    return common.change_norms(
        ((n, b) for n, b in modules.named_buffers()
         if n.rsplit(".", 1)[-1] in BN_BUFFERS), initial)


def readings_of(metrics, state, names, index, readings, initial):
    """Into ``readings``: a step's loss and loss terms; after the first
    step the gradients Adam took and the BatchNorm statistics' change."""
    readings["loss"].append(float(metrics["loss_total"]))
    readings["terms"].append({k: float(v) for k, v in metrics.items()
                              if v.ndim == 0 and v.is_floating_point()})
    if index == 0:
        readings["grads"] = common.adam_gradient_norms(state.optimizer,
                                                       names)
        readings["stats_change0"] = bn_changes(state.modules, initial)


def final_readings(state, readings, initial):
    modules = state.modules
    readings["change"] = common.change_norms(
        modules.named_parameters(), initial)
    readings["stats_change"] = bn_changes(modules, initial)


def follow(cell, seed, weights, count, stream, device, precision="float32",
           fault=None, flops=False):
    """The reference's readings over the first ``count`` steps."""
    config = cell["config"]
    made, steps_per_epoch = batches(config, cell["traffic"], seed, count,
                                    stream)
    cfg = ref_model.reference_config(config, "float32")
    modules = ref_model.build(cfg, config["num_classes"], device)
    modules.load_state_dict(weights)
    state, step = make_state_and_step(cfg, modules, steps_per_epoch, seed,
                                      device)
    names = {p: n for n, p in modules.named_parameters()}
    readings = empty_readings()
    counted = None
    with fp8.precision(precision):
        for i, batch in enumerate(made):
            if fault == "half_batch":
                batch = half_batch(batch)
            hooks = head_hooks(modules, readings["heads"]) if i == 0 else []
            if flops and i == 0:
                metrics, counted = roofline.count_flops(
                    lambda: step(state, batch))
            else:
                metrics = step(state, batch)
            for hook in hooks:
                hook.remove()
            readings_of(metrics, state, names, i, readings, weights)
    final_readings(state, readings, weights)
    readings["flops"] = counted
    readings["batches"] = made
    del state, modules
    return readings
