"""The adaptation step as one CUDA graph (``codeps_torch/tasks/step_graph.py``)
and the graph-safe constants it needs.

On the CPU (each test a few seconds, the benchmark's small published
cell's configuration, ResNet-18): the graphs' signature; the skip ring's
in-place push against the functional one it replaced; ``scale_intrinsics``,
the translation matrix's last column and the class-weighted CE exactly as
they were computed from host-made tensors; the generator's draws handed in
as ``noise`` (the card tests' eager baseline) against the step's own.

On a card (``gpu``; ``python -m pytest --noconftest -m gpu
tests/test_torch_step_graph.py``, no JAX): a graph with the generator
registered draws what eager calls draw; 4 frames of the small published
cell (``benchmark/tests/small.py``) through the runner, with the flow head
too, count 1 eager step, 1 capture and 3 replays, and a step from the
state they leave, replayed, equals the eager step; a new batch shape
captures a second graph.
"""

import copy
import types

import numpy as np
import pytest
import torch

from benchmark import configs
from benchmark.tests.small import small_cell
from codeps_torch.config import get_cfg_defaults_adapt
from codeps_torch.geometry import camera, pose
from codeps_torch.losses import semantic_loss
from codeps_torch.models import build_modules, init_params
from codeps_torch.tasks import adapt as adapt_task
from codeps_torch.tasks import step_graph, trace
from codeps_torch.tasks.state import make_adapt_state

NC = 14
CELL = "kitti360.stream"
FLOW = {"model.make_sflow": True, "adapt.model.sflow": True}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(values=None):
    return configs.apply(get_cfg_defaults_adapt(),
                         small_cell(CELL, values)["config"])


def _state_and_step(cfg):
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=0,
                          device="cpu")
    state = make_adapt_state(modules, 1e-4, ema_modules=("semantic_head",),
                             frozen_modules=("backbone_po_depth",
                                             "instance_head"),
                             seed=3, device="cpu")
    step = adapt_task.make_adapt_step(cfg, [1.0 + 0.1 * c
                                            for c in range(NC)])
    return state, step


def _batch(cfg, seed=0, replay=2):
    """A random step batch at the configuration's sizes."""
    gen = torch.Generator().manual_seed(seed)
    ht, wt = cfg.dataset.feed_img_size
    hs, ws = cfg.adapt.source_dataset.feed_img_size
    camera_row = torch.tensor([[0.6 * wt, 0.6 * wt, wt / 2, ht / 2]])

    def frames(n, h, w):
        return torch.randn((n, 3, h, w, 3), generator=gen)
    batch = {
        "target": {"frames": frames(1, ht, wt), "camera": camera_row},
        "source": {
            "frames": frames(2, hs, ws),
            "camera": camera_row.repeat(2, 1) * 0.9,
            "semantic": torch.randint(0, NC, (2, hs, ws), generator=gen,
                                      dtype=torch.int32),
            "semantic_weights": torch.rand((2, hs, ws), generator=gen),
            "center": torch.rand((2, hs, ws, 1), generator=gen),
            "offset": torch.randn((2, hs, ws, 2), generator=gen)},
        "do_ema": True}
    if replay:
        batch["target_replay"] = {"frames": frames(replay, ht, wt),
                                  "camera": camera_row.repeat(replay, 1)}
    return batch


@pytest.fixture(scope="module")
def small():
    cfg = _cfg()
    state, step = _state_and_step(cfg)
    return cfg, state, step


# ------------------------------------------------------------- signature

def test_signature_tells_batches_and_modes_apart(small):
    cfg, state, _ = small
    batch = _batch(cfg)
    key = step_graph.signature(state, batch)
    assert step_graph.signature(state, _batch(cfg, seed=1)) == key
    # a non-tensor leaf is not part of it
    assert step_graph.signature(state, dict(batch, do_ema=False)) == key
    shape = _batch(cfg, replay=1)
    assert step_graph.signature(state, shape) != key
    dtype = copy.deepcopy(batch)
    dtype["source"]["semantic"] = dtype["source"]["semantic"].long()
    assert step_graph.signature(state, dtype) != key
    missing = copy.deepcopy(batch)
    del missing["source"]["center"]
    assert step_graph.signature(state, missing) != key
    head = state.student.pose_head
    training = head.training
    head.train(not training)
    try:
        assert step_graph.signature(state, batch) != key
    finally:
        head.train(training)
    assert step_graph.signature(state, batch) == key


def test_engages_only_on_one_card_with_the_generator(small):
    _, state, _ = small
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert step_graph.StepGraphs.engages(on_card, None)
    assert not step_graph.StepGraphs.engages(on_card, lambda shape: None)
    assert not step_graph.StepGraphs.engages(state, None)


# ------------------------------------------------------------- skip ring

def _functional_push(dist_buffer, dist_count, dist_head, dist, skip):
    """The push as it was: new tensors."""
    capacity = dist_buffer.shape[0]
    pushed = dist_buffer.index_put((dist_head.reshape(1),),
                                   dist.reshape(1).to(dist_buffer.dtype))
    return (torch.where(skip, dist_buffer, pushed),
            torch.where(skip, dist_count,
                        torch.clamp(dist_count + 1, max=capacity)),
            torch.where(skip, dist_head, (dist_head + 1) % capacity))


def test_in_place_push_equals_the_functional_push():
    ring = (torch.zeros(5), torch.zeros((), dtype=torch.int64),
            torch.zeros((), dtype=torch.int64))
    expected = tuple(t.clone() for t in ring)
    gen = torch.Generator().manual_seed(0)
    skips = [False, False, True, False, False, False, True, False, False]
    for skip in skips:
        dist = torch.rand((), generator=gen)
        skip = torch.tensor(skip)
        expected = _functional_push(*expected, dist, skip)
        out = adapt_task.push_ring_buffer(*ring, dist, skip)
        assert all(a is b for a, b in zip(out, ring))
        for got, want in zip(ring, expected):
            assert torch.equal(got, want)
    assert int(ring[1]) == 5 and int(ring[2]) == 7 % 5


# ------------------------------------------------------------- constants

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_constants_equal_the_host_made_ones(dtype):
    gen = torch.Generator().manual_seed(0)
    intrinsics = torch.rand((3, 4), generator=gen, dtype=dtype) * 900
    for scale_u, scale_v in ((0.5, 0.5), (1 / 3, 0.25), (704 / 1408, 0.1)):
        old = intrinsics * torch.tensor([scale_u, scale_v, scale_u, scale_v],
                                        dtype=dtype)
        assert torch.equal(camera.scale_intrinsics(intrinsics, scale_u,
                                                   scale_v), old)
    translation = torch.randn((3, 3), generator=gen, dtype=dtype)
    pad = torch.cat([translation, translation.new_zeros(3, 1)], dim=-1)
    old = torch.eye(4, dtype=dtype) + pad[:, :, None] * torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=dtype)[None, None, :]
    assert torch.equal(pose.translation_matrix(translation), old)

    weights = [1.0 + 0.37 * c for c in range(NC)]
    prediction = torch.softmax(torch.randn((2, NC, 8, 12), generator=gen,
                                           dtype=dtype), dim=1)
    target = torch.randint(0, NC, (2, 8, 12), generator=gen)
    target[0, 0] = 255
    pixel = torch.rand((2, 8, 12), generator=gen, dtype=dtype)
    logp = torch.log_softmax(prediction, dim=1)
    valid = target != 255
    safe = torch.where(valid, target, 0)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0] * torch.tensor(
        weights, dtype=dtype)[safe]
    old = (torch.where(valid, nll, 0.0) * pixel).mean()
    assert torch.equal(semantic_loss(prediction, target, pixel,
                                     class_weights=weights), old)


# ----------------------------------------------------------------- noise

def _snapshot(state):
    return ({k: v.clone() for k, v in state.student.state_dict().items()},
            {k: v.clone() for k, v in state.teacher.state_dict().items()},
            copy.deepcopy(state.optimizer.state_dict()),
            state.generator.get_state(),
            [t.clone() for t in (state.dist_buffer, state.dist_count,
                                 state.dist_head)], state.step)


def _restore(state, saved):
    student, teacher, optimizer, generator, ring, count = saved
    state.student.load_state_dict(student)
    state.teacher.load_state_dict(teacher)
    state.optimizer.load_state_dict(optimizer)
    state.generator.set_state(generator)
    for tensor, value in zip((state.dist_buffer, state.dist_count,
                              state.dist_head), ring):
        tensor.copy_(value)
    state.step = count


def _generator_noise(state):
    """The step's own noise, handed in: draws from the state's generator,
    which takes the eager path."""
    def noise(shape):
        return torch.randn(shape, generator=state.generator,
                           device=state.device)
    return noise


def test_generator_noise_handed_in_equals_the_default(small):
    """The eager baseline of the card tests: the generator's draws handed
    in as ``noise`` give the step's own losses and leave the generator
    where the step leaves it."""
    cfg, state, step = small
    batch = _batch(cfg)
    saved = _snapshot(state)
    try:
        metrics, features = step(state, batch)
        after = state.generator.get_state()
        _restore(state, saved)
        handed, handed_features = step(state, batch,
                                       noise=_generator_noise(state))
        assert torch.equal(state.generator.get_state(), after)
    finally:
        _restore(state, saved)
    assert set(handed) == set(metrics)
    for name, value in metrics.items():
        assert torch.equal(handed[name], value), name
    assert torch.equal(handed_features, features)


def test_counters_count_an_eager_step_a_frame(small):
    cfg, state, step = small
    saved = _snapshot(state)
    phases, counters = {}, {}
    try:
        with trace.frame(0, phases, counters):
            step(state, _batch(cfg, replay=1))
    finally:
        _restore(state, saved)
    assert counters == {"step.eager_steps": [1],
                        "step.graph_captures": [0],
                        "step.graph_replays": [0]}


# ------------------------------------------------------------------ card

on_card = pytest.mark.skipif(not torch.cuda.is_available(),
                             reason="needs a CUDA card")
FRAMES = 4


@pytest.mark.gpu
@on_card
def test_graph_draws_what_eager_draws_on_card():
    """A graph with the generator registered draws, replay after replay,
    the numbers the eager calls draw, and leaves the generator where they
    leave it."""
    shapes = [(2, 2, 8, 12), (2, 2, 4, 6), (3, 2, 2, 3)]
    eager_gen = torch.Generator(device="cuda").manual_seed(5)
    eager = [[torch.randn(s, generator=eager_gen, device="cuda")
              for s in shapes] for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    first = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        drawn = [torch.randn(s, generator=gen, device="cuda")
                 for s in shapes]
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append([d.clone() for d in drawn])
    for got, want in zip([first] + replays, eager):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert torch.equal(torch.randn(7, generator=gen, device="cuda"),
                       torch.randn(7, generator=eager_gen, device="cuda"))


def _stream(values, seed=11):
    """A runner of the small published cell on the card after ``FRAMES``
    frames, graphed, and the batch its last step took."""
    from benchmark.drivers import stream
    _, runner, _, _ = stream.build(small_cell(CELL, values), seed,
                                   torch.device("cuda"))
    batches = []

    def keeping(step):
        def call(state, batch, noise=None):
            batches.append(batch)
            return step(state, batch, noise=noise)
        return call
    runner.steps = {key: keeping(step) for key, step in runner.steps.items()}
    runner.run(max_frames=FRAMES)
    return runner, batches[-1]


def _reading(state, out):
    params = [p for group in state.optimizer.param_groups
              for p in group["params"]]
    return {
        "losses": {k: v.detach().cpu().clone() for k, v in out[0].items()},
        "features": out[1].cpu().clone(),
        "ring": [t.cpu().clone() for t in (state.dist_buffer,
                                           state.dist_count,
                                           state.dist_head)],
        "grads": torch.cat([p.grad.detach().double().flatten().cpu()
                            for p in params if p.grad is not None]),
        "student": torch.cat([p.detach().double().flatten().cpu()
                              for p in state.student.parameters()]),
        "teacher": torch.cat([p.detach().double().flatten().cpu()
                              for p in state.teacher.parameters()])}


def _rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


@pytest.mark.gpu
@on_card
@pytest.mark.parametrize("values", [None, FLOW], ids=["published", "flow"])
def test_graphed_step_equals_eager_on_card(values):
    """4 frames of the small published cell (and with the flow head): 1
    eager step, 1 capture, 3 replays. Then, from the state the stream
    left, one more step on its last batch, replayed and twice eager (the
    generator's noise handed in): the forward's outputs (losses, replay
    features, the skip ring) equal; the gradients, student and teacher
    within the eager path's own spread (float32 atomics in the bilinear
    and grid-sample backwards sum in another order each run)."""
    runner, batch = _stream(values)
    counts = runner.frame_counters
    assert counts["step.eager_steps"] == [1, 0, 0, 0]
    assert counts["step.graph_captures"] == [0, 1, 0, 0]
    assert counts["step.graph_replays"] == [0, 1, 1, 1]
    state = runner.state
    step = runner.steps[("target_replay" in batch, True)]
    saved = _snapshot(state)
    readings = []
    for noise in (None, _generator_noise(state), _generator_noise(state)):
        _restore(state, saved)
        phases, counters = {}, {}
        with trace.frame(0, phases, counters):
            out = step(state, batch, noise=noise)
        assert counters["step.graph_replays"] == [int(noise is None)]
        readings.append(_reading(state, out))
    graphed, eager, again = readings
    for name, value in eager["losses"].items():
        assert torch.equal(graphed["losses"][name], value), name
    assert torch.equal(graphed["features"], eager["features"])
    for got, want in zip(graphed["ring"], eager["ring"]):
        assert torch.equal(got, want)
    for kind in ("grads", "student", "teacher"):
        spread = _rel_l2(again[kind], eager[kind])
        gap = _rel_l2(graphed[kind], eager[kind])
        print(f"{kind}: graphed {gap:.3e}, eager spread {spread:.3e}")
        assert gap <= max(1e-6, 4 * spread), kind


@pytest.mark.gpu
@on_card
def test_new_shape_recaptures_on_card():
    cfg = _cfg()
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=0,
                          device="cuda")
    state = make_adapt_state(modules, 1e-4, ema_modules=("semantic_head",),
                             frozen_modules=("backbone_po_depth",
                                             "instance_head"),
                             seed=3, device="cuda")
    step = adapt_task.make_adapt_step(cfg, [1.0] * NC)
    phases, counters = {}, {}
    batches = [_batch(cfg, seed=i, replay=r)
               for i, r in enumerate((2, 2, 2, 1, 1, 2, 1))]
    for i, batch in enumerate(batches):
        with trace.frame(i, phases, counters):
            metrics, _ = step(state, adapt_task.batch_to_device(batch,
                                                                "cuda"))
        assert np.isfinite(float(metrics["loss_total"]))
    assert counters["step.eager_steps"] == [1, 0, 0, 1, 0, 0, 0]
    assert counters["step.graph_captures"] == [0, 1, 0, 0, 1, 0, 0]
    assert counters["step.graph_replays"] == [0, 1, 1, 0, 1, 1, 1]
