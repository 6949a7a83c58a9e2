"""Driver of pretraining: the port's train loop as
``codeps_torch.scripts.train.run_training`` wires it, with its parts called
in the loop's own order (``run_training`` has no way to end on time).

Set-up: the seeded Cityscapes-like epoch through the port's reader, the
seeded weights, ``make_train_state`` with the config's schedule,
``make_train_step`` and the port's ``DataLoader`` with the config's worker
processes. The loop takes a batch, steps, and reads the step's scalars
back as one stacked tensor, as ``run_training`` does. The first steps are
the warm-up (every worker process has then delivered a batch) and the
first ``checked_steps`` of them are kept for the check; the window
follows for ``seconds``; with ``trace`` the ``profiled_steps`` after it
run under ``torch.profiler``. Once the window has closed and the port's
state is freed, the plain reference works the checked steps out again.
"""

from __future__ import annotations

import gc
import math
import random

import numpy as np
import torch

from benchmark import common, configs, judge, trace
from benchmark.reference import fp8
from benchmark.reference import pretrain as reference
from benchmark.weights import made_weights

TRAIN_STREAM = 1


def build(cell, seed, device):
    """(cfg, state, step, loader, host weights) of the cell."""
    from codeps_torch.config import get_cfg_defaults
    from codeps_torch.data.loader import DataLoader
    from codeps_torch.models import build_modules
    from codeps_torch.tasks.optim import build_schedule
    from codeps_torch.tasks.state import make_train_state
    from codeps_torch.tasks.train import make_train_step

    from benchmark.readers import MemoryCityscapes
    config, traffic = cell["config"], cell["traffic"]
    cfg = configs.apply(get_cfg_defaults(), config)
    dataset = MemoryCityscapes(cfg.dataset, "train", traffic["epoch_items"],
                               seed, TRAIN_STREAM)
    dataset.return_only_rgb = cfg.dataset.return_only_rgb
    loader = DataLoader(dataset, cfg.train.batch_size_per_gpu,
                        cfg.dataset.offsets, shuffle=True, seed=seed,
                        num_workers=cfg.train.nof_workers_per_gpu)
    weights, _ = made_weights(config, seed, device)
    modules = build_modules(cfg, dataset.num_classes, device=device)
    modules.load_state_dict(weights)
    state = make_train_state(modules, build_schedule(cfg, len(loader)),
                             seed=seed, device=device)
    class_weights = [w for i, w in enumerate(cfg.semantics.class_weights)
                     if i not in cfg.dataset.remove_classes]
    ignore = list(dataset.ignore_classes)
    step = make_train_step(cfg, class_weights,
                           sem_ignore_classes=ignore or None,
                           num_classes=dataset.num_classes,
                           eval_ignore_classes=ignore)
    return cfg, state, step, loader, weights


def control_step(cell, weights, seed, device, steps_per_epoch, precision,
                 fault):
    """(state, step) of the reference put in the program's place."""
    from benchmark.reference import model as ref_model
    cfg = ref_model.reference_config(cell["config"], "float32")
    modules = ref_model.build(cfg, cell["config"]["num_classes"], device)
    modules.load_state_dict(weights)
    state, step = reference.make_state_and_step(cfg, modules,
                                                steps_per_epoch, seed,
                                                device)

    def call(state, batch, noise=None):
        if fault == "half_batch":
            batch = reference.half_batch(batch)
        with fp8.precision(precision):
            return step(state, batch, noise=noise)
    return state, call


def faulty(step, fault):
    def call(state, batch, noise=None):
        if fault == "half_batch":
            batch = reference.half_batch(batch)
        saved = None
        if fault == "unchanged":
            saved = {k: v.detach().clone() for k, v in
                     state.modules.state_dict().items()}
        out = step(state, batch, noise=noise)
        if saved is not None:
            with torch.no_grad():
                state.modules.load_state_dict(saved)
        return out
    return call


def compare(prog, ref, batches):
    """(the numbers that decide ``correct``, readings that do not).

    Decide: the first step's loss terms (the worst term), BatchNorm
    statistics (the worst leaf) and the semantic and depth heads' outputs
    (rel. L2), all from the same weights and batch;
    the median leaf's change after the checked steps; the batches the
    steps took against the reference's own (exact). Readings only (they
    swing from seed to seed in sound runs, and neither the control nor
    half a batch moves them ten times further; PERF.md): the later steps'
    loss, the statistics after the checked steps, the median and worst
    leaf of the first gradient, the worst leaf of the change.
    """
    keep = judge.kept_leaves(ref["grads"])
    grads = judge.leaf_gaps(prog["grads"], ref["grads"], keep)
    change = judge.leaf_gaps(prog["change"], ref["change"], keep)
    numbers = {
        "loss_start_gap": max(judge.rel_gap(prog["terms"][0].get(k,
                                                                 math.inf),
                                            v)
                              for k, v in ref["terms"][0].items()),
        "stats_start_gap": judge.worst_leaf(judge.leaf_gaps(
            prog["stats_change0"], ref["stats_change0"]))[0],
        "semantic_start_gap": judge.rel_l2(prog["heads"]["semantic_head"],
                                           ref["heads"]["semantic_head"]),
        "depth_start_gap": judge.rel_l2(prog["heads"]["depth_head"],
                                        ref["heads"]["depth_head"]),
        "change_median_gap": judge.median_leaf(change),
        "batch_start_gap": batch_gap(batches, ref["batches"]),
    }
    readings = {
        "loss_gap_by_step": [judge.rel_gap(p, r)
                             for p, r in zip(prog["loss"], ref["loss"])],
        "grad_median_gap": judge.median_leaf(grads),
        "stats_gap": judge.worst_leaf(judge.leaf_gaps(
            prog["stats_change"], ref["stats_change"]))[0],
        "grad_worst": judge.worst_leaf(grads),
        "change_worst": judge.worst_leaf(change)}
    return numbers, readings


def batch_gap(got, made) -> float:
    """Largest difference between the batches the checked steps took and
    the reference's batches of the same seed, over every array."""
    gap = 0.0
    for a, b in zip(got, made):
        if set(a) != set(b):
            return math.inf
        for key in a:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            if x.shape != y.shape:
                return math.inf
            if x.size:
                gap = max(gap, float(np.abs(x.astype(np.float64)
                                            - y.astype(np.float64)).max()))
    return gap


def run(cell, seed, seconds, trace_on, device, clock, fault=None,
        control=None):
    """One run of the cell; returns the record the harness reads."""
    traffic = cell["traffic"]
    checked = traffic["checked_steps"]
    profiled = traffic["profiled_steps"] if trace_on else 0
    cfg, state, step, loader, weights = build(cell, seed, device)
    if control is not None:
        state, step = control_step(cell, weights, seed, device, len(loader),
                                   *control)
    if fault is not None:
        step = faulty(step, fault)
    # every worker process (or the loader's thread) has delivered a batch
    # and filled its prefetch before the window
    warmup = max(checked, cfg.train.nof_workers_per_gpu + loader.prefetch)
    names = {p: n for n, p in state.modules.named_parameters()}
    prog = reference.empty_readings()
    batch_size = cfg.train.batch_size_per_gpu
    waits, step_s, losses, taken = [], [], [], []
    window, profile = {}, {}
    # worker processes seed each batch's augmentation themselves; the
    # loader's thread draws it from the module generator, seeded here
    random.seed(seed)
    batches = iter(loader)
    try:
        for i in range(len(loader)):
            if "t0" not in window and (i == warmup or seconds <= 0
                                       and i == checked):
                common.synchronize(device)
                window["t0"] = clock()
                window["first"] = i
                if seconds <= 0:
                    break
            if "prof" in profile and i == window["last"] + 1 + profiled:
                break
            t_wait = clock()
            with trace.span("loader_wait"):
                batch = next(batches)
            t_step = clock()
            hooks = (reference.head_hooks(state.modules, prog["heads"])
                     if i == 0 else [])
            with trace.span("train_step"):
                out = step(state, batch)
                metrics = {k: v for k, v in out.items() if v.ndim == 0}
            for hook in hooks:
                hook.remove()
            with trace.span("readback"):
                values = torch.stack([v.float() for v in metrics.values()])
                values = dict(zip(metrics, values.cpu().tolist()))
            done = clock()
            waits.append(t_step - t_wait)
            step_s.append(done - t_step)
            losses.append(values["loss_total"])
            if i < checked:
                taken.append(batch)
                reference.readings_of(out, state, names, i, prog,
                                      weights)
                if i == checked - 1:
                    reference.final_readings(state, prog, weights)
            if "t0" in window and "end" not in window \
                    and done - window["t0"] >= seconds:
                window["end"] = done
                window["last"] = i
                if not profiled:
                    break
                profile["start"] = clock()
                profile["prof"] = trace.profiler()
                profile["prof"].__enter__()
        else:
            common.synchronize(device)
    finally:
        batches.close()
        if "prof" in profile:
            common.synchronize(device)
            profile["end"] = clock()
            profile["prof"].__exit__(None, None, None)
    if "end" not in window:
        window["end"] = clock()
        window["last"] = len(step_s) - 1
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    record = {"kind": "train", "t0": window["t0"],
              "window_s": window["end"] - window["t0"]}
    first, last = window["first"], window["last"]
    steps = last - first + 1
    record["attempted"] = max(steps, 0)
    record["failed"] = sum(1 for v in losses[first:last + 1]
                           if not math.isfinite(v))
    record["rate"] = (steps * batch_size / record["window_s"]
                      if steps > 0 else None)
    record["step_s"] = step_s[first:last + 1]
    record["wait_s"] = waits[first:last + 1]
    record["notes"] = {"setup_steps_s": [round(a + b, 4) for a, b in
                                         zip(waits[:first], step_s[:first])]}
    if "prof" in profile:
        record["profile"] = trace.summarize(
            profile["prof"].events(), profile["end"] - profile["start"])
    del state, step, loader, profile
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.follow(cell, seed, weights, checked, TRAIN_STREAM,
                           device, flops=trace_on)
    record["flops_per_unit"] = (ref["flops"] / batch_size
                                if ref["flops"] else None)
    record["memory_peak_bytes"] = memory_peak
    record["numbers"], readings = compare(prog, ref, taken)
    record.setdefault("notes", {})["readings"] = readings
    return record
