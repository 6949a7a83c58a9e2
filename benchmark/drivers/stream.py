"""Driver of the adaptation stream: ``AdaptationRunner.run`` of the port on
a seeded KITTI-360-like target sequence and a Cityscapes-like source.

Set-up: the readers, the replay buffer (the whole source of the traffic's
``source_images`` in the source buffer; ``replay_prefill`` seeded feature
rows added to the target buffer, so it is full at the window's start, the
steady state of a long drive), the seeded weights, the runner. Then one
call of ``runner.run``: its first ``checked_frames`` frames are the
warm-up, and their step inputs and outputs are kept for the check; the
window follows for ``seconds``, frame after frame as the runner takes them
(a closed loop); with ``trace`` the ``profiled_frames`` after the window
run under ``torch.profiler``. The stream stops by an exception from the
runner's ``on_frame`` hook. Once the window has closed and the port's state
is freed, the plain reference follows the checked frames.
"""

from __future__ import annotations

import gc
import math
import random
import statistics

import numpy as np
import torch

from benchmark import common, configs, host, judge, synth, trace
from benchmark.reference import fp8
from benchmark.reference import model as ref_model
from benchmark.reference import replay
from benchmark.reference import stream as reference
from benchmark.weights import made_weights

TARGET_STREAM, SOURCE_STREAM, CALIBRATION_STREAM = 1, 2, 3
GROUPING_KERNEL = "group_pixels_kernel"


class Stop(Exception):
    """Raised from ``on_frame`` to end the stream."""


def build(cell, seed, device):
    """(cfg, runner, buffer, host weights) of the cell."""
    from codeps_torch.config import get_cfg_defaults_adapt
    from codeps_torch.data.replay_buffer import ReplayBuffer
    from codeps_torch.models import build_modules
    from codeps_torch.tasks.adapt_loop import AdaptationRunner

    from benchmark.readers import MemoryCityscapes, MemoryKitti360
    config, traffic = cell["config"], cell["traffic"]
    cfg = configs.apply(get_cfg_defaults_adapt(), config)
    first_prefill = traffic["stream_frames"]
    split = first_prefill + traffic["replay_prefill"]
    ratio = cfg.adapt.target_dataset_adapt_ratio
    total = math.ceil(split / ratio)
    while int(total * ratio) < split:
        total += 1
    target = MemoryKitti360(cfg.dataset, total, seed, TARGET_STREAM)
    source = MemoryCityscapes(cfg.adapt.source_dataset, "train",
                              traffic["source_images"], seed, SOURCE_STREAM)
    buffer = ReplayBuffer(target, cfg.adapt, "train",
                          rng=random.Random(seed))
    buffer.initialize_source_buffer(source, None)
    frame = synth.SeededFrames(seed, CALIBRATION_STREAM,
                               cfg.dataset.feed_img_size).frame(0)
    weights, _ = made_weights(config, seed, device, frame)
    modules = build_modules(cfg, config["num_classes"], device=device)
    modules.load_state_dict(weights)
    runner = AdaptationRunner(cfg, modules, buffer, seed=seed,
                              device=device, verbose=False)
    rows = synth.feature_rows(seed, traffic["replay_prefill"],
                              modules.backbone_po_depth.num_ch_enc[-1])
    for j, row in enumerate(rows):
        buffer.add(first_prefill + j, row[None])
    return cfg, runner, buffer, weights


def control_steps(cell, runner, weights, seed, device, precision, fault,
                  loss_dtype="float32"):
    """The reference put in the program's place: the runner's state and
    steps become the frozen copy's, in ``precision``, its losses'
    arithmetic in ``loss_dtype``."""
    cfg = ref_model.reference_config(cell["config"], "float32")
    modules = ref_model.build(cfg, cell["config"]["num_classes"], device)
    modules.load_state_dict(weights)
    # the modules keep the float32 they were built in; the step takes its
    # losses' arithmetic type from the configuration it is made from
    state, step = reference.make_state_and_step(
        ref_model.reference_config(cell["config"], loss_dtype), modules,
        seed, device)
    runner.state = state

    def call(state, batch, noise=None):
        if fault == "half_batch":
            batch = reference.half_batch(batch)
        with fp8.precision(precision):
            return step(state, batch, noise=noise)
    return {key: call for key in runner.steps}


def faulty(step, fault):
    """``step`` with a fault planted underneath (the checks' own test)."""
    def call(state, batch, noise=None):
        if fault == "half_batch":
            batch = reference.half_batch(batch)
        saved = None
        if fault == "unchanged":
            saved = [{k: v.detach().clone() for k, v in m.state_dict()
                      .items()} for m in (state.student, state.teacher)]
        out = step(state, batch, noise=noise)
        if saved is not None:
            with torch.no_grad():
                state.student.load_state_dict(saved[0])
                state.teacher.load_state_dict(saved[1])
        return out
    return call


def target_start_gap(cfg, seed, frames):
    """Largest gap between the target triplets the checked steps took and
    the generator's frames, normalized as the config states: the start of
    what the reference takes from the port's batches."""
    norm = cfg.dataset.normalization
    mean = np.asarray(norm.rgb_mean, np.float32)
    std = np.asarray(norm.rgb_std, np.float32)
    made = synth.SeededFrames(seed, TARGET_STREAM, cfg.dataset.feed_img_size)
    gap = 0.0
    for index, frame in enumerate(frames):
        got = np.asarray(frame["batch"]["target"]["frames"], np.float32)
        triplet = made.triplet(index)
        want = np.stack([triplet[o] for o in (0, -1, 1)])[None]
        if got.dtype == np.uint8 or not norm.active:
            want = want.astype(np.float32)
        else:
            want = (want.astype(np.float32) / 255.0 - mean) / std
        if got.shape != want.shape:
            return math.inf
        gap = max(gap, float(np.abs(got - want).max()))
    return gap


def compare(prog, ref):
    """(the numbers that decide ``correct``, readings that do not).

    Decide: the first frame's loss terms (the worst term; one step from
    the same weights), every frame's replay features and teacher
    semantics, the first frame's teacher depth, the median leaf's change
    after the checked steps, the EMA teacher's change. Readings only (they
    swing from seed to seed in sound runs, and the control moves them no
    further; PERF.md): the later frames' total loss and depth, the
    median and worst leaf of the first gradient, the worst leaf of the
    change, the panoptic maps' segment disagreement.
    """
    keep = judge.kept_leaves(ref["grads"])
    grads = judge.leaf_gaps(prog["grads"], ref["grads"], keep)
    change = judge.leaf_gaps(prog["change"], ref["change"], keep)
    frames = range(len(ref["loss"]))
    first_terms = ref["terms"][0]
    numbers = {
        "loss_start_gap": max(judge.rel_gap(prog["terms"][0].get(k,
                                                                 math.inf),
                                            v)
                              for k, v in first_terms.items()),
        "feature_gap": max(judge.rel_l2(prog["features"][i],
                                        ref["features"][i]) for i in frames),
        "semantic_gap": max(judge.rel_l2(prog["semantic_soft"][i],
                                         ref["semantic_soft"][i])
                            for i in frames),
        "depth_start_gap": judge.rel_l2(prog["depth"][0], ref["depth"][0]),
        "change_median_gap": judge.median_leaf(change),
        "ema_gap": judge.worst_leaf(judge.leaf_gaps(
            prog["ema_change"], ref["ema_change"], keep))[0],
    }
    readings = {
        "loss_gap": max(judge.rel_gap(prog["loss"][i], ref["loss"][i])
                        for i in frames),
        "grad_median_gap": judge.median_leaf(grads),
        "grad_worst": judge.worst_leaf(grads),
        "change_worst": judge.worst_leaf(change),
        "depth_gap_by_frame": [judge.rel_l2(prog["depth"][i],
                                            ref["depth"][i])
                               for i in frames],
        "panoptic_gap_by_frame": [judge.segment_disagreement(
            prog["panoptic"][i], ref["panoptic"][i]) for i in frames]}
    return numbers, readings


def grouping_mismatch(calls, frames: int) -> float:
    """Pixels on which the port's grouping of the checked frames differs
    from the plain grouping of the same centers and offsets; infinite
    where the checked frames made fewer calls than frames (each frame's
    ground-truth map makes one), so a path that skips the kernel fails."""
    from benchmark.reference.codeps_ref.ops.grouping import \
        group_pixels_plain
    if len(calls) < frames:
        return math.inf
    return float(sum(int((out != group_pixels_plain(yx, valid, offsets))
                         .sum()) for yx, valid, offsets, out in calls))


def run(cell, seed, seconds, trace_on, device, clock, fault=None,
        control=None):
    """One run of the cell; returns the record the harness reads."""
    from codeps_torch.ops import panoptic as panoptic_ops
    traffic = cell["traffic"]
    checked = traffic["checked_frames"]
    profiled = traffic["profiled_frames"] if trace_on else 0
    cfg, runner, buffer, weights = build(cell, seed, device)

    if control is not None:
        steps = control_steps(cell, runner, weights, seed, device,
                              *control)
    else:
        steps = runner.steps
    if fault is not None:
        steps = {key: faulty(step, fault) for key, step in steps.items()}
    names = {p: n for n, p in runner.state.student.named_parameters()}
    prog = reference.empty_readings()
    captured, cameras = [], []
    prewarp = runner._c2c_prewarp_cached

    def recording_prewarp(intr_tgt, intr_src, size):
        cameras.append((np.array(intr_tgt), np.array(intr_src),
                        tuple(size)))
        return prewarp(intr_tgt, intr_src, size)

    checked_groupings = []

    def checking_grouping(yx, valid, offsets):
        out = group_pixels(yx, valid, offsets)
        checked_groupings.append(tuple(t.detach().clone() for t in
                                       (yx, valid, offsets, out)))
        return out

    def checking(step):
        def call(state, batch, noise=None):
            i = len(captured)
            captured.append({"batch": common.to_host(batch),
                             "cameras": cameras[-1] if cameras else None})
            out = step(state, batch, noise=noise)
            reference.readings_of(out, state, names, i, prog, weights)
            if i == checked - 1:
                reference.final_readings(state, prog, weights)
            return out
        return call

    group_pixels = panoptic_ops.group_pixels
    runner._c2c_prewarp_cached = recording_prewarp
    runner.steps = {key: checking(step) for key, step in steps.items()}
    panoptic_ops.group_pixels = checking_grouping
    marks, window, calls = {}, {}, []
    profile, pinned = {}, {}

    def recording_grouping(yx, valid, offsets):
        calls.append((tuple(offsets.shape[:3]), valid.sum(1)))
        return group_pixels(yx, valid, offsets)

    def start_profile():
        panoptic_ops.group_pixels = recording_grouping
        runner.steps = {key: trace.wrap(step, "adapt_step")
                        for key, step in steps.items()}
        runner.gt_panoptic = trace.wrap(runner.gt_panoptic, "gt_map")
        buffer.add = trace.wrap(buffer.add, "replay.add")
        profile["prof"] = trace.profiler()
        profile["prof"].__enter__()

    def on_frame(it):
        now = clock()
        marks[it] = now
        if it == 0 and torch.device(device).type == "cuda":
            # the prefetch thread and its pool run by now
            pinned.update(host.pin_threads())
        if it == checked - 1:
            runner._c2c_prewarp_cached = prewarp
            runner.steps = steps
            panoptic_ops.group_pixels = group_pixels
            common.synchronize(device)
            window["t0"] = clock()
            window["first"] = it + 1
            marks[it] = window["t0"]
            if seconds <= 0:
                raise Stop
        elif "t0" in window and "end" not in window \
                and now - window["t0"] >= seconds:
            common.synchronize(device)
            window["end"] = clock()
            window["last"] = it
            if not profiled:
                raise Stop
            marks[it] = clock()
            start_profile()
        elif "prof" in profile and it == window["last"] + profiled:
            common.synchronize(device)
            marks[it] = clock()
            raise Stop

    try:
        runner.run(max_frames=traffic["stream_frames"], on_frame=on_frame)
    except Stop:
        pass
    finally:
        panoptic_ops.group_pixels = group_pixels
        if "prof" in profile:
            profile["prof"].__exit__(None, None, None)
    if "end" not in window:
        common.synchronize(device)
        window["end"] = clock()
        window["last"] = max(marks)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)

    record = window_record(runner, window, marks, seconds)
    record.setdefault("notes", {})["host"] = pinned
    if "prof" in profile:
        last = window["last"]
        record["profile"] = trace.summarize(
            profile["prof"].events(), marks[last + profiled] - marks[last],
            kernel_names=(GROUPING_KERNEL,))
        record["grouping_calls"] = [(shape, [int(v) for v in valid])
                                    for shape, valid in calls]
    start_gap = target_start_gap(cfg, seed, captured)
    side_gap = replay.side_gap(
        [frame["batch"] for frame in captured],
        replay.side_batches(ref_model.reference_config(cell["config"]), seed,
                            len(captured), TARGET_STREAM, SOURCE_STREAM,
                            traffic["source_images"]))
    grouping_calls = len(checked_groupings)
    mismatch = grouping_mismatch(checked_groupings, len(captured))
    del checked_groupings
    del runner, buffer, steps, profile
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref = reference.follow(cell["config"], seed, weights, captured, device,
                           flops=trace_on)
    numbers, readings = compare(prog, ref)
    numbers["target_start_gap"] = start_gap
    numbers["side_gap"] = side_gap
    numbers["grouping_mismatch"] = mismatch
    record["flops_per_unit"] = ref["flops"]
    record["memory_peak_bytes"] = memory_peak
    record["numbers"] = numbers
    readings["grouping_calls"] = grouping_calls
    record.setdefault("notes", {})["readings"] = readings
    return record


def window_record(runner, window, marks, seconds):
    first, last = window.get("first"), window["last"]
    record = {"kind": "stream", "t0": window.get("t0"),
              "window_s": window["end"] - window.get("t0", window["end"])}
    if first is None or last < first:
        record.update(attempted=0, failed=0, rate=None)
        return record
    frames = list(range(first, last + 1))
    record["attempted"] = len(frames)
    record["failed"] = 0
    record["rate"] = len(frames) / record["window_s"]
    record["frame_s"] = [marks[i] - marks[i - 1] for i in frames]
    # the runner's per-frame lists hold one entry an adapted frame, from 0
    record["frame_phases"] = {k: v[first:last + 1] for k, v in
                              runner.frame_phases.items()}
    adds = runner.host_times.get("add", [])
    record["add_s"] = adds[first - 1:last]
    losses = runner.meters["losses"]["loss"]
    record["failed"] = 0 if math.isfinite(float(losses.value)) \
        else len(frames)
    record["notes"] = {
        "frame_p50_ms": statistics.median(record["frame_s"]) * 1e3,
        "phase_mean_ms": {k: sum(v) / len(v) * 1e3 for k, v in
                          record["frame_phases"].items() if v},
        "getitem_mean_ms": statistics.fmean(
            runner.host_times["getitem"][first:last + 1]) * 1e3}
    return record
