"""The port's spans and counters (``codeps_torch/tasks/trace.py``): on the
profiler's timeline only while it records, one entry a frame, the parts
inside their phase, exact upload counts.

The stream is ``tests/_spatial_worker.py``'s one-process runner (64x96,
ResNet-18, fused cut and class mixup, 3 frames of the synthetic KITTI-360
tree) under a CPU ``torch.profiler``. Its device is the CPU, where no copy
crosses to another device, so the stream's uploads are also counted as if
they went to the ``meta`` device. No JAX.
"""

import random

import numpy as np
import pytest
import torch

import _spatial_worker as worker
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree)
from codeps_torch.tasks import adapt as adapt_task
from codeps_torch.tasks import trace

PHASES = ("batch", "step", "gt_map", "meters", "prefetch_wait", "add")
STEP_PARTS = ("step.forward", "step.backward", "step.eval", "step.update")
SPANS = PHASES + STEP_PARTS + ("batch.assemble", "batch.upload",
                               "step.optimizer", "step.ema")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _runner(root):
    from codeps_torch.data.cityscapes import Cityscapes
    from codeps_torch.data.kitti_360 import Kitti360
    from codeps_torch.data.replay_buffer import ReplayBuffer
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.tasks.adapt_loop import AdaptationRunner
    cfg = worker.runner_config(root, False)
    target = Kitti360("sequence", cfg.dataset, return_depth=True,
                      sequences=["03"], sequence_reference_mode="rgb")
    buffer = ReplayBuffer(target, cfg.adapt, "train",
                          rng=random.Random(7))
    buffer.initialize_source_buffer(
        Cityscapes("train", cfg.adapt.source_dataset), None)
    modules = init_params(build_modules(cfg, worker.NC, device="cpu"),
                          seed=0, device="cpu")
    return AdaptationRunner(cfg, modules, buffer, seed=1, device="cpu",
                            verbose=False)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """(runner, the profiler's codeps.* events, the thread that streamed,
    the host bytes a frame's ``_to_device`` calls took) of a 3-frame
    stream under a CPU profiler."""
    root = tmp_path_factory.mktemp("torch_trace")
    make_cityscapes_tree(root / "cs", num_frames=6, width=worker.W,
                         height=worker.H)
    make_kitti360_tree(root / "k360", num_frames=6, width=worker.W,
                       height=worker.H)
    runner = _runner(root)
    upload, to_device, sent = trace.upload, runner._to_device, {}

    def counted(tensor, device, dtype=None):
        # a leaf the stream put "on the device" before is not copied again
        if not getattr(tensor, "uploaded", False):
            upload(tensor, "meta", dtype)
        out = tensor.to(device, dtype)
        out.uploaded = True
        return out

    def recording(tree):
        index = trace._open().index
        sent[index] = sent.get(index, 0) + _host_bytes(tree)
        return to_device(tree)

    runner._to_device = recording
    patch = pytest.MonkeyPatch()
    patch.setattr(trace, "upload", counted)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                record_shapes=True) as prof:
            with torch.profiler.record_function("test.main_thread"):
                runner.run(max_frames=worker.RUNNER_FRAMES)
    finally:
        patch.undo()
        runner._to_device = to_device
    events = prof.events()
    main = next(e.thread for e in events if e.name == "test.main_thread")
    ours = [e for e in events if e.name.startswith(trace.PREFIX)]
    return runner, ours, main, sent


def _host_bytes(tree):
    """Bytes of the leaves of ``tree`` not yet uploaded (the warp's taps
    come from a cache on the device)."""
    if isinstance(tree, dict):
        return sum(_host_bytes(v) for v in tree.values())
    if getattr(tree, "uploaded", False):
        return 0
    return np.asarray(tree).nbytes


def _frames(events):
    return [e for e in events if e.name == trace.PREFIX + "frame"]


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler recording a span, phase, frame or upload never
    opens a range on the profiler's timeline."""
    def fail(*args):
        raise AssertionError("a range opened with no profiler recording")
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    phases, counters = {}, {}
    with trace.span("outside"):
        pass
    with trace.frame(0, phases, counters):
        phase = trace.clock(0.0)
        with phase("batch"), trace.span("batch.assemble"):
            trace.upload(torch.ones(2), "meta")
    assert set(phases) == {"batch", "batch.assemble"}
    assert counters["h2d_copies"] == [1]


def test_one_frame_range_a_frame_with_its_index(stream):
    runner, events, main, _ = stream
    frames = _frames(events)
    assert len(runner.step_times) == worker.RUNNER_FRAMES
    assert [e.concrete_inputs for e in frames] == [
        [i] for i in range(worker.RUNNER_FRAMES)]
    assert {e.thread for e in frames} == {main}


def test_spans_nest_inside_their_frame(stream):
    """Each span of a frame lies inside that frame's range, on the
    streaming thread, with the frame's index."""
    _, events, main, _ = stream
    frames = _frames(events)
    seen = {}
    for event in events:
        name = event.name[len(trace.PREFIX):]
        if name == "frame":
            continue
        assert event.thread == main, event.name
        index, = event.concrete_inputs
        outer = frames[index].time_range
        assert outer.start <= event.time_range.start \
            and event.time_range.end <= outer.end, event.name
        seen.setdefault(name, set()).add(index)
    for name in SPANS:
        assert seen.get(name) == set(range(worker.RUNNER_FRAMES)), name


def test_one_entry_per_adapted_frame(stream):
    runner = stream[0]
    assert set(SPANS) <= set(runner.frame_phases)
    assert set(runner.frame_counters) == {
        "h2d_bytes", "h2d_pageable_bytes", "h2d_copies", "step.eager_steps",
        "step.graph_captures", "step.graph_replays"}
    for lists in (runner.frame_phases, runner.frame_counters):
        for name, entries in lists.items():
            assert len(entries) == worker.RUNNER_FRAMES, name


def test_parts_lie_within_their_phase(stream):
    phases = stream[0].frame_phases
    for i in range(worker.RUNNER_FRAMES):
        parts = sum(phases[p][i] for p in STEP_PARTS)
        assert 0 < parts <= phases["step"][i]
        assert 0 < phases["batch.assemble"][i] + phases["batch.upload"][i] \
            <= phases["batch"][i]
        assert phases["step.optimizer"][i] + phases["step.ema"][i] \
            <= phases["step.update"][i]


def test_stream_counts_its_uploads(stream):
    """A frame uploads its batch and eval GT (``_to_device``) and the GT
    map's center and offset planes, all from pageable memory (the first
    frame also the warp's taps); the step's own ``batch_to_device`` of
    leaves already on the device adds nothing."""
    counters, sent = stream[0].frame_counters, stream[3]
    gt_map = 3 * worker.H * worker.W * 4
    for i in range(worker.RUNNER_FRAMES):
        assert counters["h2d_pageable_bytes"][i] == counters["h2d_bytes"][i]
        if i:
            assert counters["h2d_bytes"][i] == sent[i] + gt_map
        else:
            assert counters["h2d_bytes"][i] > sent[i] + gt_map


def test_step_outside_a_frame_records_nothing(stream):
    runner = stream[0]
    before = {k: list(v) for k, v in runner.frame_phases.items()}
    sample = runner.buffer[0]
    batch = runner._to_device(runner._adapt_batch(sample))
    runner.steps[("target_replay" in batch, True)](runner.state, batch)
    assert runner.frame_phases == before
    assert trace._open() is None


def test_upload_counts_exact_bytes():
    """Bytes as copied (after a conversion), pageable and pinned apart,
    one copy a leaf; leaves already on the device count nothing."""
    pinned = torch.zeros((3, 5), dtype=torch.int32)
    pinned.is_pinned = lambda: True
    tree = {"frames": np.zeros((1, 3, 4, 6, 3), np.uint8),
            "camera": np.zeros((1, 4), np.float32),
            "gt": {"depth": torch.zeros((2, 4, 6), dtype=torch.float32),
                   "labels": pinned},
            "on_device": torch.zeros((7,), device="meta")}
    phases, counters = {}, {}
    with trace.frame(0, phases, counters):
        out = adapt_task.batch_to_device(tree, "meta")
    assert out["gt"]["labels"].device.type == "meta"
    assert counters == {"h2d_bytes": [216 + 16 + 192 + 60],
                        "h2d_pageable_bytes": [216 + 16 + 192],
                        "h2d_copies": [4]}
    with trace.frame(1, phases, counters):
        adapt_task.batch_to_device(tree, "meta", torch.float64)
    # float leaves go up as float64; the pinned int32 leaf stays pinned
    assert counters["h2d_bytes"][1] == 216 + 32 + 384 + 60
    assert counters["h2d_pageable_bytes"][1] == 216 + 32 + 384
    with trace.frame(2, phases, counters):
        adapt_task.batch_to_device(out, "meta")
        adapt_task.batch_to_device(dict(tree, on_device=None), "cpu")
    assert [len(v) for v in counters.values()] == [2, 2, 2]


def test_frame_adds_one_entry_a_frame():
    """Spans of one name in a frame add to one entry; a frame that raises
    adds none and leaves no frame open."""
    phases, counters = {}, {}
    for index in range(2):
        with trace.frame(index, phases, counters) as opened:
            with trace.span("a"):
                pass
            first = opened.phases["a"]
            with trace.span("a"):
                pass
            assert opened.phases["a"] > first
    with pytest.raises(RuntimeError), trace.frame(2, phases, counters):
        with trace.span("a"):
            raise RuntimeError
    assert list(phases) == ["a"] and len(phases["a"]) == 2
    assert counters == {} and trace._open() is None


def test_clock_phases_are_contiguous():
    """A clock's phases sum to the time from its start to the last one's
    end, the gap between two blocks the later phase's; a span inside a
    phase keeps its own seconds."""
    import time
    phases, counters = {}, {}
    start = time.perf_counter()
    with trace.frame(0, phases, counters):
        phase = trace.clock(start)
        with phase("x"):
            time.sleep(0.002)
        time.sleep(0.002)              # between blocks: the next phase's
        with phase("y"), trace.span("y.part"):
            pass
        end = time.perf_counter()
    assert phases["x"][0] >= 0.002 and phases["y"][0] >= 0.002
    assert phases["x"][0] + phases["y"][0] <= end - start
    assert phases["y.part"][0] < 0.002


def test_profiler_started_inside_a_span():
    """A span opened before the profiler starts exits cleanly and is not
    on its timeline; one opened while it records is, also when the
    profiler stops first."""
    outer = trace.span("before")
    outer.__enter__()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.__enter__()
    with trace.span("during"):
        inner = trace.span("across").__enter__()
    outer.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    inner.__exit__(None, None, None)
    names = {e.name for e in prof.events()}
    assert trace.PREFIX + "during" in names
    assert trace.PREFIX + "before" not in names


def test_operator_log_reads_phases_and_counters(monkeypatch):
    """``scripts/adapt.py`` logs each phase's mean ms and the uploads'
    mean MB, copies and pageable share a frame, past the first 3, and
    where the step counts them the stream's eager steps, graph captures
    and replays."""
    from types import SimpleNamespace

    from codeps_torch.scripts import adapt as adapt_cli
    lines = []
    monkeypatch.setattr(adapt_cli, "log_info",
                        lambda message, *args: lines.append(message % args))
    metric = SimpleNamespace(value=np.float32(0.5))
    runner = SimpleNamespace(
        step_times=[1.0] * 5,
        frame_phases={"batch": [1.0, 1.0, 1.0, 0.002, 0.004]},
        frame_counters={"h2d_bytes": [9, 9, 9, 3_000_000, 1_000_000],
                        "h2d_pageable_bytes": [0, 0, 0, 3_000_000, 0],
                        "h2d_copies": [1, 1, 1, 4, 2]},
        panoptic_eval=SimpleNamespace(pq_stats=SimpleNamespace(
            pq_per_cat={})))
    sink = SimpleNamespace(log_scalars=lambda *a, **k: None,
                           log_depth_per_class=lambda *a, **k: None)
    cfg = SimpleNamespace(dataset=SimpleNamespace(remove_classes=[],
                                                  label_mode=None))
    meters = {"metrics": {"sem_miou": metric, "p_pq": metric}, "losses": {}}
    adapt_cli._log_stream(cfg, runner, meters, sink)
    assert "batch 3.0" in lines[1]
    assert lines[2] == ("Host to device a frame: 2.00 MB in 3.0 copies, "
                        "75.0% from pageable memory")
    assert len(lines) == 4
    runner.frame_counters.update({"step.eager_steps": [1, 0, 0, 0, 0],
                                  "step.graph_captures": [0, 1, 0, 0, 0],
                                  "step.graph_replays": [0, 1, 1, 1, 1]})
    lines.clear()
    adapt_cli._log_stream(cfg, runner, meters, sink)
    assert lines[3] == ("Adaptation steps: 1 eager, 1 graph capture(s), "
                        "4 graph replay(s)")
