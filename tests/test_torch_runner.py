"""The port's adaptation stream against ``codeps_tpu``'s ``AdaptationRunner``
on the synthetic KITTI-360 tree (the done bar of the port's main path).

Setup of ``tests/test_adapt_loop.py:20-48``: feed 32x64, ResNet-18, two
source and two target-replay samples, a diversity buffer of 3, the
published freezing (depth encoder and instance head frozen, semantic head
EMA 0.99), with ``[cut_mixup, class_mixup]`` (both fused), a unit weight
on the class-mixup loss so it counts, a similarity threshold of 1.01 so
every frame enters the buffer and the fourth evicts one, and the JAX step
in float32. Both runners start from the same bridged weights, seeds and
Python ``random`` state (the JAX package augments with the module
``random``, the port with the ``random.Random`` given to its buffer); the
JAX runner's automask normals are injected into the port's steps.

The JAX runner prefetches the next frame in a thread, and when the
previous frame's buffer add runs against that prefetch is a race there;
the test's subclass of the JAX buffer fixes it to the port's order (frame
it+1 is sampled before frame it-1 is added), so both streams sample the
same replay. Four frames: the fourth has target replay.

Tolerances (``scripts/parity_e2e.py:52-54``): PQ within 0.5 percentage
points, mIoU and abs_rel within 0.005; the step count and the buffer's
ids equal. Beyond the done bar: the mean losses within 1e-3 relative; the
PQ statistics per class with equal true positives and false negatives and
false positives within one; the summed confusion matrices within 5% of
their pixels (seen: 2.9%). The first frame's teacher eval is equal on
both sides; after it the weights differ by Adam's sign flips (see
test_torch_adapt.py), and the random heads' class scores are so close
that an argmax flips for about 1% of a frame's pixels per step.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.data import Cityscapes as JaxCityscapes
from codeps_tpu.data import Kitti360 as JaxKitti360
from codeps_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer
from codeps_tpu.tasks import make_adapt_state as jax_make_adapt_state
from codeps_tpu.tasks.adapt_loop import AdaptationRunner as JaxRunner

from codeps_torch.config import gen_config
from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.kitti_360 import Kitti360
from codeps_torch.data.replay_buffer import ReplayBuffer
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree)
from codeps_torch.io import from_jax
from codeps_torch.models import build_modules
from codeps_torch.tasks.adapt_loop import AdaptationRunner
from torch_parity import JaxNoise, SequencedJaxBuffer

NC = 14
FRAMES = 4
SEED = 7
FROZEN = ("backbone_po_depth", "instance_head")
PQ_TOL = 0.005        # 0.5 percentage points, as a fraction
MIOU_TOL = 0.005
ABS_REL_TOL = 0.005
LOSS_REL_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configure(cfg, k360_root, cs_root):
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.dataset.name = "kitti_360"
    cfg.dataset.path = str(k360_root)
    cfg.dataset.feed_img_size = [32, 64]
    cfg.dataset.center_heatmap_sigma = 4
    cfg.adapt.source_dataset.name = "cityscapes"
    cfg.adapt.source_dataset.path = str(cs_root)
    cfg.adapt.source_dataset.feed_img_size = [32, 64]
    cfg.adapt.replay_sampler.nof_source_samples = 2
    cfg.adapt.replay_sampler.nof_target_samples = 2
    cfg.adapt.replay_buffer.maximize_diversity = True
    cfg.adapt.replay_buffer.target_size = 3
    cfg.adapt.replay_buffer.similarity_threshold = 1.01
    cfg.adapt.mixup.general.nof_samples = 2
    cfg.adapt.mixup.general.mixup_strategies = ["cut_mixup", "class_mixup"]
    cfg.adapt.ema.semantic = True
    cfg.adapt.model.backbone_po_depth = False
    cfg.adapt.model.instance = False
    cfg.semantics.class_weights = [1.0] * NC
    cfg.losses.weights.semantic_class_mixup = 1.0
    cfg.tpu.compute_dtype = "float32"
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_runner")
    cs_root = make_cityscapes_tree(tmp / "cs", num_frames=6, width=96,
                                   height=64)
    k360_root = make_kitti360_tree(tmp / "k360", num_frames=8, width=96,
                                   height=64)
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False), k360_root,
                      cs_root)
    pcfg = _configure(gen_config(adapt=True, freeze=False), k360_root,
                      cs_root)

    # ---- JAX
    target = JaxKitti360("sequence", jcfg.dataset, return_depth=True,
                         sequences=["03"], sequence_reference_mode="rgb")
    jbuffer = SequencedJaxBuffer(target, jcfg.adapt, "train",
                                 num_frames=FRAMES)
    jbuffer.initialize_source_buffer(
        JaxCityscapes("train", jcfg.adapt.source_dataset), None)
    modules = jax_build_modules(jcfg, NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), modules, (32, 64))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    tx = jax_build_optimizer(jcfg, jcfg.train.optimizer.learning_rate,
                             frozen_modules=list(FROZEN))
    state_key = jax.random.PRNGKey(1)
    state = jax_make_adapt_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        tx, jnp.array(state_key), ema_modules=("semantic_head",),
        frozen_modules=list(FROZEN), ema_alpha=0.99)
    jrunner = JaxRunner(jcfg, modules, state, tx, jbuffer,
                        frozen_modules=list(FROZEN), verbose=False)
    random.seed(SEED)
    jmeters = jrunner.run(max_frames=FRAMES)

    # ---- port
    target = Kitti360("sequence", pcfg.dataset, return_depth=True,
                      sequences=["03"], sequence_reference_mode="rgb")
    pbuffer = ReplayBuffer(target, pcfg.adapt, "train",
                           rng=random.Random(SEED))
    pbuffer.initialize_source_buffer(
        Cityscapes("train", pcfg.adapt.source_dataset), None)
    pmodules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                      params, stats, pcfg)
    prunner = AdaptationRunner(pcfg, pmodules, pbuffer, device="cpu",
                               verbose=False, noise=JaxNoise(state_key))
    ended = []
    pmeters = prunner.run(max_frames=FRAMES, on_frame=ended.append)
    return {"jax": (jrunner, jmeters), "port": (prunner, pmeters),
            "frames_ended": ended}


def _value(meters, kind, name):
    return float(np.asarray(meters[kind][name].value))


def test_stream_metrics_match(streams):
    (_, jm), (_, pm) = streams["jax"], streams["port"]
    for name, tol in (("p_pq", PQ_TOL), ("p_sq", PQ_TOL), ("p_rq", PQ_TOL),
                      ("sem_miou", MIOU_TOL), ("sem_miou_pixels", MIOU_TOL),
                      ("d_abs_rel", ABS_REL_TOL)):
        ref, ours = _value(jm, "metrics", name), _value(pm, "metrics", name)
        assert np.isfinite(ours), name
        assert abs(ours - ref) <= tol, (name, ours, ref)
    # every meter the JAX stream filled, the port filled as often
    for kind in ("losses", "metrics"):
        for name, meter in jm[kind].items():
            count = getattr(meter, "count", None)
            if count is not None:
                assert pm[kind][name].count == count, (kind, name)


def test_on_frame_follows_every_frame(streams):
    prunner, _ = streams["port"]
    assert streams["frames_ended"] == list(range(FRAMES))
    assert len(prunner.step_times) == FRAMES


def test_panoptic_statistics_match(streams):
    (jrunner, _), (prunner, _) = streams["jax"], streams["port"]
    jstats = jrunner.panoptic_eval.pq_stats.pq_per_cat
    pstats = prunner.panoptic_eval.pq_stats.pq_per_cat
    assert set(pstats) == set(jstats)
    assert sum(s.fn for s in jstats.values()) > 0
    for cat, ref in jstats.items():
        ours = pstats[cat]
        assert (ours.tp, ours.fn) == (ref.tp, ref.fn), cat
        assert abs(ours.fp - ref.fp) <= 1, cat
        assert abs(ours.iou - ref.iou) <= 1e-6 * max(ref.tp, 1), cat


def test_confusion_and_depth_meters_match(streams):
    (_, jm), (_, pm) = streams["jax"], streams["port"]
    conf_j = jm["metrics"]["sem_conf"].sum
    conf_p = pm["metrics"]["sem_conf"].sum
    assert conf_p.sum() == conf_j.sum() > 0
    # the teacher's argmax flips near-tie pixels after the first step
    assert np.abs(conf_p - conf_j).sum() <= 0.05 * conf_j.sum()
    per_class = [n for n in jm["metrics"] if n.startswith("d_abs_rel_c")]
    filled = [n for n in per_class if jm["metrics"][n].count]
    assert filled
    for name in per_class:
        assert pm["metrics"][name].count == jm["metrics"][name].count, name
    for name in filled:
        ref, ours = (_value(jm, "metrics", name),
                     _value(pm, "metrics", name))
        assert abs(ours - ref) <= ABS_REL_TOL, (name, ours, ref)


def test_losses_match(streams):
    (_, jm), (_, pm) = streams["jax"], streams["port"]
    assert jm["losses"]["semantic_class_mixup"].count == FRAMES
    assert jm["losses"]["semantic_cut_mixup"].count == FRAMES
    for name, meter in jm["losses"].items():
        if not meter.count:
            continue
        ref, ours = _value(jm, "losses", name), _value(pm, "losses", name)
        assert abs(ours - ref) <= LOSS_REL_TOL * abs(ref), (name, ours, ref)


def test_step_count_and_buffer_match(streams):
    (jrunner, _), (prunner, _) = streams["jax"], streams["port"]
    assert int(jrunner.state.step) == prunner.state.step == FRAMES
    jids, jvecs = jrunner.buffer.sim_index.dump()
    pids, pvecs = prunner.buffer.sim_index.dump()
    np.testing.assert_array_equal(pids, jids)
    assert len(pids) == 3                          # 4 adds, 1 eviction
    np.testing.assert_allclose(pvecs, jvecs, atol=1e-4)
    np.testing.assert_array_equal(prunner.buffer.buffer_indices["target"],
                                  jrunner.buffer.buffer_indices["target"])
    np.testing.assert_array_equal(
        prunner.buffer.distance_matrix_indices,
        jrunner.buffer.distance_matrix_indices)
    # the replay buffer's samplers drew the same: source indices left
    np.testing.assert_array_equal(prunner.buffer.buffer_indices["source"],
                                  jrunner.buffer.buffer_indices["source"])
    assert len(prunner.host_times["getitem"]) == FRAMES
    assert len(prunner.host_times["add"]) == FRAMES


@pytest.fixture(scope="module")
def eval_streams(tmp_path_factory):
    """Both runners in eval-only mode (``adapt.mode: off``), 2 frames."""
    tmp = tmp_path_factory.mktemp("torch_runner_eval")
    cs_root = make_cityscapes_tree(tmp / "cs", num_frames=6, width=96,
                                   height=64)
    k360_root = make_kitti360_tree(tmp / "k360", num_frames=8, width=96,
                                   height=64)
    out = {}
    for side, make in (("jax", jax_gen_config), ("port", gen_config)):
        cfg = make(adapt=True, freeze=False)
        cfg.adapt.mode = "off"
        cfg = _configure(cfg, k360_root, cs_root)
        if side == "jax":
            target = JaxKitti360("sequence", cfg.dataset, return_depth=True,
                                 sequences=["03"])
            buffer = JaxReplayBuffer(target, cfg.adapt, "train")
            buffer.initialize_source_buffer(
                JaxCityscapes("train", cfg.adapt.source_dataset), None)
            modules = jax_build_modules(cfg, NC)
            params, stats = jax_init_params(jax.random.PRNGKey(0), modules,
                                            (32, 64))
            tx = jax_build_optimizer(cfg, 1e-4, frozen_modules=list(FROZEN))
            state = jax_make_adapt_state(params, stats, tx,
                                         jax.random.PRNGKey(1),
                                         frozen_modules=list(FROZEN))
            runner = JaxRunner(cfg, modules, state, tx, buffer,
                               frozen_modules=list(FROZEN), verbose=False)
            bridge = (jax.tree.map(np.array, params),
                      jax.tree.map(np.array, stats))
        else:
            target = Kitti360("sequence", cfg.dataset, return_depth=True,
                              sequences=["03"])
            buffer = ReplayBuffer(target, cfg.adapt, "train",
                                  rng=random.Random(SEED))
            buffer.initialize_source_buffer(
                Cityscapes("train", cfg.adapt.source_dataset), None)
            runner = AdaptationRunner(
                cfg, from_jax.load_from_jax(build_modules(cfg, NC,
                                                          device="cpu"),
                                            *bridge, cfg),
                buffer, device="cpu", verbose=False)
        random.seed(SEED)
        out[side] = (runner, runner.run(max_frames=2))
    return out


def test_eval_only_stream_matches(eval_streams):
    (jrunner, jm), (prunner, pm) = eval_streams["jax"], eval_streams["port"]
    assert prunner.disable_adaptation
    assert prunner.state.step == int(jrunner.state.step) == 0
    assert pm["losses"]["loss"].count == jm["losses"]["loss"].count == 0
    # the same teacher on the same frames: equal maps
    np.testing.assert_array_equal(pm["metrics"]["sem_conf"].sum,
                                  jm["metrics"]["sem_conf"].sum)
    for name, tol in (("p_pq", PQ_TOL), ("sem_miou", MIOU_TOL),
                      ("d_abs_rel", ABS_REL_TOL)):
        ref, ours = _value(jm, "metrics", name), _value(pm, "metrics", name)
        assert abs(ours - ref) <= tol, (name, ours, ref)
    assert pm["metrics"]["d_abs_rel"].count == 2
    # eval-only adds nothing to the diversity buffer
    assert prunner.buffer.sim_index is None
