"""The port's adaptation stream on the host mixup path against
``codeps_tpu``'s ``AdaptationRunner``, with the package-default strategies
``[cut_mixup, conf_instance_mixup]`` (and its ``conf_instance_mix``
defaults) and the camera warp.

Setup of ``tests/test_torch_runner.py`` (synthetic KITTI-360 at 32x64,
ResNet-18, the published freezing, the JAX step in float32, the JAX
buffer held to the port's order, the JAX runner's automask normals
injected into the port's steps) for 3 frames, before any target replay,
so that the JAX runner compiles its step once. The teacher starts from
JAX-made weights whose thing logits and center head are raised
(``torch_parity.raise_instances``), so that the pseudo-labels hold
instances and ``conf_instance_mixup`` pastes them; a unit weight on its
loss makes it count.

Tolerances (``scripts/parity_e2e.py:52-54``): PQ within 0.5 percentage
points and abs_rel within 0.005; the mean losses within 1e-4 relative;
the buffer's ids equal. The port-only tests stream without the camera
warp with uint8 frames, and hold the composition from uint8 frames to the
one from float32 frames.
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
from torch_parity import JaxNoise, SequencedJaxBuffer, raise_instances

NC = 14
FRAMES = 3
SEED = 7
FROZEN = ("backbone_po_depth", "instance_head")
THINGS = (9, 10, 11, 12, 13)
PQ_TOL = 0.005        # 0.5 percentage points, as a fraction
ABS_REL_TOL = 0.005
LOSS_REL_TOL = 1e-4


def _configure(cfg, k360_root, cs_root, geom_augment=True, uint8=False,
               strategies=None):
    """The setup above; ``strategies`` replaces the package default."""
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.dataset.name = "kitti_360"
    cfg.dataset.path = str(k360_root)
    cfg.dataset.feed_img_size = [32, 64]
    cfg.dataset.center_heatmap_sigma = 4
    cfg.dataset.normalization.uint8_transfer = uint8
    cfg.adapt.source_dataset.name = "cityscapes"
    cfg.adapt.source_dataset.path = str(cs_root)
    cfg.adapt.source_dataset.feed_img_size = [32, 64]
    cfg.adapt.source_dataset.normalization.uint8_transfer = uint8
    cfg.adapt.replay_sampler.nof_source_samples = 2
    cfg.adapt.replay_sampler.nof_target_samples = 2
    cfg.adapt.replay_buffer.maximize_diversity = True
    cfg.adapt.replay_buffer.target_size = 3
    cfg.adapt.replay_buffer.similarity_threshold = 1.01
    if strategies is not None:
        cfg.adapt.mixup.general.mixup_strategies = list(strategies)
    cfg.adapt.mixup.general.nof_samples = len(
        cfg.adapt.mixup.general.mixup_strategies)
    cfg.adapt.mixup.general.geom_augment = geom_augment
    cfg.adapt.ema.semantic = True
    cfg.adapt.model.backbone_po_depth = False
    cfg.adapt.model.instance = False
    cfg.semantics.class_weights = [1.0] * NC
    cfg.losses.weights.semantic_conf_instance_mixup = 1.0
    cfg.tpu.compute_dtype = "float32"
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_runner_host_mixup")
    return (make_kitti360_tree(tmp / "k360", num_frames=8, width=96,
                               height=64),
            make_cityscapes_tree(tmp / "cs", num_frames=6, width=96,
                                 height=64))


@pytest.fixture(scope="module")
def weights():
    """JAX-made weights whose pseudo-labels hold instances."""
    cfg = jax_gen_config(adapt=True, freeze=False)
    cfg.model.po_depth_net.params.nof_layers = 18
    params, stats = jax_init_params(jax.random.PRNGKey(0),
                                    jax_build_modules(cfg, NC), (32, 64))
    return raise_instances(params, THINGS), jax.tree.map(np.array, stats)


def _port_runner(cfg, weights, noise=None):
    target = Kitti360("sequence", cfg.dataset, return_depth=True,
                      sequences=["03"], sequence_reference_mode="rgb")
    buffer = ReplayBuffer(target, cfg.adapt, "train",
                          rng=random.Random(SEED))
    buffer.initialize_source_buffer(
        Cityscapes("train", cfg.adapt.source_dataset), None)
    modules = from_jax.load_from_jax(build_modules(cfg, NC, device="cpu"),
                                     *weights, cfg)
    return AdaptationRunner(cfg, modules, buffer, device="cpu",
                            verbose=False, noise=noise)


@pytest.fixture(scope="module")
def streams(trees, weights):
    k360_root, cs_root = trees
    params, stats = weights
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False), k360_root,
                      cs_root)
    pcfg = _configure(gen_config(adapt=True, freeze=False), k360_root,
                      cs_root)
    assert list(jcfg.adapt.mixup.general.mixup_strategies) == [
        "cut_mixup", "conf_instance_mixup"]

    target = JaxKitti360("sequence", jcfg.dataset, return_depth=True,
                         sequences=["03"], sequence_reference_mode="rgb")
    jbuffer = SequencedJaxBuffer(target, jcfg.adapt, "train",
                                 num_frames=FRAMES)
    jbuffer.initialize_source_buffer(
        JaxCityscapes("train", jcfg.adapt.source_dataset), None)
    tx = jax_build_optimizer(jcfg, jcfg.train.optimizer.learning_rate,
                             frozen_modules=list(FROZEN))
    state_key = jax.random.PRNGKey(1)
    state = jax_make_adapt_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        tx, jnp.array(state_key), ema_modules=("semantic_head",),
        frozen_modules=list(FROZEN), ema_alpha=0.99)
    jrunner = JaxRunner(jcfg, jax_build_modules(jcfg, NC), state, tx,
                        jbuffer, frozen_modules=list(FROZEN), verbose=False)
    random.seed(SEED)
    jmeters = jrunner.run(max_frames=FRAMES)

    prunner = _port_runner(pcfg, weights, noise=JaxNoise(state_key))
    pmeters = prunner.run(max_frames=FRAMES)
    return (jrunner, jmeters), (prunner, pmeters)


def _value(meters, kind, name):
    return float(np.asarray(meters[kind][name].value))


def test_host_path_is_taken(streams):
    (jrunner, _), (prunner, _) = streams
    assert not jrunner.fused_mixup and not prunner.fused_mixup
    assert len(prunner.pasted_instances) == FRAMES
    assert sum(prunner.pasted_instances) >= 1, prunner.pasted_instances
    for name in ("prep", "readback", "cut_mixup", "conf_instance_mixup"):
        assert len(prunner.frame_phases["mixup." + name]) == FRAMES, name


def test_host_mixup_losses_match(streams):
    (_, jm), (_, pm) = streams
    for name in ("semantic_cut_mixup", "semantic_conf_instance_mixup"):
        assert jm["losses"][name].count == FRAMES, name
    for name, meter in jm["losses"].items():
        assert pm["losses"][name].count == meter.count, name
        if not meter.count:
            continue
        ref, ours = _value(jm, "losses", name), _value(pm, "losses", name)
        assert abs(ours - ref) <= LOSS_REL_TOL * abs(ref), (name, ours, ref)


def test_host_mixup_metrics_match(streams):
    (_, jm), (_, pm) = streams
    for name, tol in (("p_pq", PQ_TOL), ("d_abs_rel", ABS_REL_TOL)):
        ref, ours = _value(jm, "metrics", name), _value(pm, "metrics", name)
        assert np.isfinite(ours), name
        assert abs(ours - ref) <= tol, (name, ours, ref)


def test_host_mixup_buffer_matches(streams):
    (jrunner, _), (prunner, _) = streams
    assert int(jrunner.state.step) == prunner.state.step == FRAMES
    jids, _ = jrunner.buffer.sim_index.dump()
    pids, _ = prunner.buffer.sim_index.dump()
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_array_equal(prunner.buffer.buffer_indices["target"],
                                  jrunner.buffer.buffer_indices["target"])


def test_unwarped_stream_with_uint8_frames(trees, weights):
    """``[conf_instance_mixup]`` alone without the camera warp (equal feed
    sizes): the host path labels the stack and composes each item with
    ``Mixup.do_mixup``."""
    cfg = _configure(gen_config(adapt=True, freeze=False), *trees,
                     geom_augment=False, uint8=True,
                     strategies=("conf_instance_mixup",))
    runner = _port_runner(cfg, weights)
    meters = runner.run(max_frames=2)
    assert not runner.fused_mixup
    assert meters["losses"]["semantic_conf_instance_mixup"].count == 2
    assert meters["losses"]["semantic_cut_mixup"].count == 0
    for name, meter in meters["losses"].items():
        if meter.count:
            assert np.isfinite(_value(meters, "losses", name)), name
    # the warped path's parts only
    assert not [k for k in runner.frame_phases if k.startswith("mixup.")]


def test_uint8_frames_compose_as_float_frames(trees, weights):
    """The composed samples do not depend on the frames' transport: the
    device normalizes uint8 frames for the teacher, the host for the
    source frame."""
    composed = {}
    for uint8 in (False, True):
        cfg = _configure(gen_config(adapt=True, freeze=False), *trees,
                         uint8=uint8)
        runner = _port_runner(cfg, weights)
        sample = runner.buffer[0]
        assert (sample["cut_mixup"][0]["rgb_src"][0].dtype == np.uint8) \
            is uint8
        composed[uint8] = runner._compose_mixups(sample)
    assert [m["strategy"] for m in composed[True]] == [
        "cut_mixup", "conf_instance_mixup"]
    for ours, ref in zip(composed[True], composed[False]):
        np.testing.assert_allclose(ours["rgb"][0], ref["rgb"][0], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(ours["semantic"], ref["semantic"])
        np.testing.assert_array_equal(ours["instance"], ref["instance"])
