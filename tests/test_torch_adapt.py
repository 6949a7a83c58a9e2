"""The port's adaptation step against ``codeps_tpu.tasks.adapt.
make_adapt_step`` on the same weights, batch and automask noise.

Setup of ``tests/test_adapt_step.py``: ResNet-18 for both encoders,
target 32x64 (1 frame + 2 replay), source 32x96 (2 triplets), 2 composed
cut-mixup samples, 14 classes, the published freezing (depth encoder and
instance head frozen, semantic head EMA-filtered with alpha 0.99, the
rest live and copied), the in-step teacher eval with GT. The JAX step runs
in float32 (``cfg.tpu.compute_dtype``); its weights reach the port
through ``codeps_torch.io.from_jax``. The automask noise is the normals
JAX draws, reproduced here from the step's key splits (``adapt.py:770,
507, 537``, ``photometric.py:187``) and injected into the port's step.
One JAX compile serves every test (module-scoped fixture).

Tolerances, each with its reason:
  - losses, depth metrics, replay features, eval head outputs: relative
    1e-4 of the reference value (head outputs: of its maximum). oneDNN and
    XLA sum the convolutions in different orders (see
    test_torch_models.py); Flax's train-mode BatchNorm uses the fast
    variance E[x^2] - E[x]^2 where torch takes two passes.
  - gradients of the live modules: max abs error 2e-4 of the tensor's
    largest gradient, and relative L2 error 1e-4 over the module (seen:
    2.5e-5 and 1.4e-5 on the pose backbone, under 4e-6 on the heads).
    The forward differences above reach the gradients through deep conv
    stacks, and the warp's bilinear taps and the automask's min switch
    at exact coordinates and ties, where float noise picks a side.
  - parameters after n Adam steps: the first steps move each component
    by about lr * sign(g), so a gradient near 0 whose sign differs moves
    it by up to 2 lr: max |diff| <= 2.2 lr n, and 99.9% of the components
    within 2e-5 n (``scripts/parity_adapt.py:1037-1040``).
  - frozen modules, the copy-class teachers and the skip ring: exact.
  - semantic and panoptic maps and the confusion matrix: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer
from codeps_tpu.tasks import make_adapt_state as jax_make_adapt_state
from codeps_tpu.tasks.adapt import build_eval_forward as jax_eval_forward
from codeps_tpu.tasks.adapt import make_adapt_step as jax_make_adapt_step

from codeps_torch.config import gen_config
from codeps_torch.io import from_jax
from codeps_torch.models import build_modules, init_params
from codeps_torch.tasks.adapt import (DIST_BUFFER_LEN, build_eval_forward,
                                      make_adapt_step)
from codeps_torch.tasks.state import make_adapt_state

HT, WT = 32, 64
HS, WS = 32, 96
NC = 14
THINGS = (9, 10, 11, 12, 13)
NUM_SOURCE = NUM_REPLAY = NUM_MIXUP = 2
NUM_SCALES = 5
LR = 1e-4
FROZEN = ("backbone_po_depth", "instance_head")
EMA = ("semantic_head",)
LIVE = ("backbone_pose_sflow", "depth_head", "pose_head", "semantic_head")
REL_TOL = 1e-4


def _configure(cfg):
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.adapt.ema.semantic = True
    cfg.adapt.ema.alpha = 0.99
    cfg.tpu.compute_dtype = "float32"
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)

    def cams(n, h, w, f):
        return np.tile(np.asarray([[f, f, w / 2, h / 2]], np.float32),
                       (n, 1))

    def frames(n, h, w):
        return rng.integers(0, 256, (n, 3, h, w, 3), dtype=np.uint8)

    return {
        "target": {"frames": frames(1, HT, WT), "camera": cams(1, HT, WT,
                                                                30.0)},
        "source": {
            "frames": frames(NUM_SOURCE, HS, WS),
            "camera": cams(NUM_SOURCE, HS, WS, 28.0),
            "semantic": rng.integers(0, NC, (NUM_SOURCE, HS, WS)).astype(
                np.int32),
            "semantic_weights": rng.uniform(
                0.5, 2.0, (NUM_SOURCE, HS, WS)).astype(np.float32),
            "center": rng.uniform(0, 1, (NUM_SOURCE, HS, WS, 1)).astype(
                np.float32),
            "offset": rng.normal(0, 4, (NUM_SOURCE, HS, WS, 2)).astype(
                np.float32),
        },
        "target_replay": {"frames": frames(NUM_REPLAY, HT, WT),
                          "camera": cams(NUM_REPLAY, HT, WT, 30.0)},
        "mixup": {
            "rgb": rng.integers(0, 256, (NUM_MIXUP, HS, WS, 3),
                                dtype=np.uint8),
            "semantic": rng.integers(0, NC, (NUM_MIXUP, HS, WS)).astype(
                np.int32),
        },
        "eval_gt": {
            "semantic": rng.integers(0, NC, (1, HT, WT)).astype(np.int32),
            "depth_gt": np.where(rng.random((1, HT, WT)) < 0.2, 0.0,
                                 rng.uniform(1, 60, (1, HT, WT))).astype(
                np.float32),
        },
    }


def _recon_noise(key, batch, height, width):
    out = []
    for s in range(NUM_SCALES):
        key, sub = jax.random.split(key)
        draw = jax.random.normal(
            sub, (batch, height >> s, width >> s, 2), jnp.float32)
        out.append(np.asarray(draw).transpose(0, 3, 1, 2))
    return out


def jax_step_noise(step_key):
    """The automask normals one JAX step draws from ``state.rng``, in the
    order the port asks for them: source scales, then target scales."""
    _, loss_key = jax.random.split(step_key)
    key, sub = jax.random.split(loss_key)
    source = _recon_noise(sub, NUM_SOURCE, HS, WS)
    _, sub = jax.random.split(key)
    return source + _recon_noise(sub, 1 + NUM_REPLAY, HT, WT)


class Injected:
    """Noise source for the port's step that hands out given arrays in
    order and checks the shapes asked for."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape):
        draw = self.arrays.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(np.array(draw))


def _tree_np(tree):
    return jax.tree.map(np.array, tree)


def _state_dict(name, params, stats, cfg):
    """A port state dict of module ``name`` from JAX trees (``params`` may
    be any tree of the params' structure, such as Adam's moments)."""
    if name == "backbone_pose_sflow":
        return from_jax.resnet_encoder(params, stats, 18)
    if name == "depth_head":
        return from_jax.depth_head(params)
    if name == "pose_head":
        return from_jax.pose_head(params)
    if name == "semantic_head":
        return from_jax.semantic_head(params, True)
    raise KeyError(name)


def _full_ring():
    ring = np.linspace(0.5, 1.5, DIST_BUFFER_LEN).astype(np.float32)
    return ring, DIST_BUFFER_LEN, 7


@pytest.fixture(scope="module")
def runs():
    """Two steps from the initial state, and one step from a state whose
    ring is full of large distances (the frame is skipped), on both
    sides. Returns a dict of their inputs and outputs."""
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False))
    jcfg.tpu.compute_dtype = "float32"
    jmodules = jax_build_modules(jcfg, num_classes=NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules,
                                    (HT, WT))
    params, stats = _tree_np(params), _tree_np(stats)
    tx = jax_build_optimizer(jcfg, LR, frozen_modules=FROZEN)
    jstep = jax_make_adapt_step(
        jmodules, jcfg, tx, class_weights=[1.0] * NC, ema_modules=EMA,
        frozen_modules=FROZEN, has_replay=True, num_mixup=NUM_MIXUP,
        donate=False, eval_forward=jax_eval_forward(jmodules, jcfg, THINGS))

    def jax_state():
        return jax_make_adapt_state(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats), tx, jax.random.PRNGKey(2),
            ema_modules=EMA, frozen_modules=FROZEN, ema_alpha=0.99)

    pcfg = _configure(gen_config(adapt=True, freeze=False))
    port_eval = build_eval_forward(pcfg, THINGS, NC)
    pstep = make_adapt_step(pcfg, [1.0] * NC, has_replay=True,
                            num_mixup=NUM_MIXUP, eval_forward=port_eval)

    def port_state():
        modules = build_modules(pcfg, NC, device="cpu")
        from_jax.load_from_jax(modules, params, stats, pcfg)
        return make_adapt_state(modules, LR, ema_modules=EMA,
                                frozen_modules=FROZEN, ema_alpha=0.99,
                                device="cpu")

    batches = [_batch(1), _batch(2)]
    out = {"params": params, "stats": stats, "cfg": pcfg, "jax": [],
           "port": []}

    js, ps = jax_state(), port_state()
    for batch in batches:
        noise = jax_step_noise(js.rng)
        js, *jres = jstep(js, jax.tree.map(jnp.asarray, batch))
        out["jax"].append((jax.tree.map(np.array, js), _tree_np(jres)))
        pres = pstep(ps, batch, noise=Injected(noise))
        grads = {name: {k: p.grad.clone() for k, p in
                        getattr(ps.student, name).named_parameters()}
                 for name in LIVE}
        out["port"].append(({
            "student": {n: {k: v.clone() for k, v in
                            getattr(ps.student, n).state_dict().items()}
                        for n in ps.student.module_names()},
            "teacher": {n: {k: v.clone() for k, v in
                            getattr(ps.teacher, n).state_dict().items()}
                        for n in ps.teacher.module_names()},
            "ring": (ps.dist_buffer.clone(), int(ps.dist_count),
                     int(ps.dist_head)),
            "grads": grads}, pres))

    ring, count, head = _full_ring()
    js = jax_state().replace(dist_buffer=jnp.asarray(ring),
                             dist_count=jnp.asarray(count, jnp.int32),
                             dist_head=jnp.asarray(head, jnp.int32))
    noise = jax_step_noise(js.rng)
    js, *jres = jstep(js, jax.tree.map(jnp.asarray, batches[0]))
    out["jax_skip"] = (jax.tree.map(np.array, js), _tree_np(jres))
    ps = port_state()
    ps.dist_buffer = torch.from_numpy(ring.copy())
    ps.dist_count = torch.tensor(count)
    ps.dist_head = torch.tensor(head)
    pres = pstep(ps, batches[0], noise=Injected(noise))
    out["port_skip"] = ((ps.dist_buffer.clone(), int(ps.dist_count),
                         int(ps.dist_head)), pres)
    return out


def _rel_close(ours, ref, rel, what):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rel * abs(ref), (what, ours, ref)


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match(runs, step):
    (_, (jmetrics, _, _, _)) = runs["jax"][step]
    (_, (pmetrics, _, _, _)) = runs["port"][step]
    assert set(pmetrics) == set(jmetrics)
    for key, ref in jmetrics.items():
        if key == "target_skipped":
            assert bool(pmetrics[key]) is bool(ref) is False
        else:
            _rel_close(pmetrics[key], ref, REL_TOL, key)


def test_skip_flag_and_ring_match(runs):
    for step in range(2):
        jstate, (jmetrics, _, _, _) = runs["jax"][step]
        pout, (pmetrics, _, _, _) = runs["port"][step]
        assert not bool(pmetrics["target_skipped"])
        buf, count, head = pout["ring"]
        assert count == int(jstate.dist_count) == step + 1
        assert head == int(jstate.dist_head) == step + 1
        np.testing.assert_allclose(buf.numpy(), jstate.dist_buffer,
                                   rtol=REL_TOL, atol=0)
        assert (buf.numpy()[step + 1:] == 0).all()


def test_skipped_frame_with_full_ring(runs):
    jstate, (jmetrics, _, _, _) = runs["jax_skip"]
    (buf, count, head), (pmetrics, _, _, _) = runs["port_skip"]
    ring, full, start = _full_ring()
    assert bool(jmetrics["target_skipped"])
    assert bool(pmetrics["target_skipped"])
    # the ring is not pushed on a skipped frame
    np.testing.assert_array_equal(buf.numpy(), ring)
    np.testing.assert_array_equal(jstate.dist_buffer, ring)
    assert count == int(jstate.dist_count) == full
    assert head == int(jstate.dist_head) == start
    # the target counts 0 images: the depth losses are the source and
    # replay domains' alone
    for key, ref in jmetrics.items():
        if key != "target_skipped":
            _rel_close(pmetrics[key], ref, REL_TOL, key)
    # same weights, batch and noise with an empty ring: only the target's
    # weight differs, by more than the tolerance can hide
    (_, (kept, _, _, _)) = runs["jax"][0]
    assert abs(float(jmetrics["depth_recon"])
               - float(kept["depth_recon"])) > 2 * REL_TOL * float(
                   kept["depth_recon"])


@pytest.mark.parametrize("step", [0, 1])
def test_replay_features_match(runs, step):
    (_, (_, jfeat, _, _)) = runs["jax"][step]
    (_, (_, pfeat, _, _)) = runs["port"][step]
    assert tuple(pfeat.shape) == jfeat.shape == (1, 512)
    err = np.abs(pfeat.numpy() - jfeat).max()
    assert err <= REL_TOL * np.abs(jfeat).max(), err
    np.testing.assert_allclose(np.linalg.norm(pfeat.numpy(), axis=1), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1])
def test_teacher_eval_matches(runs, step):
    (_, (_, _, jres, jstats)) = runs["jax"][step]
    (_, (_, _, pres, pstats)) = runs["port"][step]
    pres = {k: v.numpy() for k, v in pres.items() if v is not None}
    jres = {k: v for k, v in jres.items() if v is not None}
    assert set(pres) == set(jres)
    for key in ("depth", "semantic_soft", "center", "offset"):
        err = np.abs(pres[key] - jres[key]).max()
        assert err <= REL_TOL * np.abs(jres[key]).max(), (key, err)
    for key in ("semantic", "panoptic", "instance"):
        assert pres[key].dtype == jres[key].dtype
        np.testing.assert_array_equal(pres[key], jres[key], err_msg=key)
    assert set(pstats) == set(jstats)
    np.testing.assert_array_equal(pstats["sem_conf"].numpy(),
                                  jstats["sem_conf"])
    for key, ref in jstats.items():
        if key != "sem_conf":
            _rel_close(pstats[key], ref, REL_TOL, key)


def _adam_mu(jstate, name):
    partition = jstate.opt_state.inner_states["trained"]
    return partition.inner_state[0].mu[name]


@pytest.mark.parametrize("name", LIVE)
def test_live_module_gradients_match(runs, name):
    jstate, _ = runs["jax"][0]
    pout, _ = runs["port"][0]
    # Adam's first moment after one step from zero is (1 - b1) * g.
    ref = _state_dict(name, _adam_mu(jstate, name),
                      runs["stats"].get(name), runs["cfg"])
    ours = pout["grads"][name]
    assert set(ours) <= set(ref)
    num, den = 0.0, 0.0
    for key, grad in ours.items():
        expect = ref[key].numpy() / (1.0 - 0.9)
        got = grad.numpy()
        bound = 2e-4 * np.abs(expect).max()
        err = np.abs(got - expect).max()
        assert err <= bound, (key, err, bound)
        num += float(((got - expect) ** 2).sum())
        den += float((expect ** 2).sum())
    assert np.sqrt(num / den) <= 1e-4


def _param_bounds(diffs, steps):
    flat = np.concatenate([d.ravel() for d in diffs])
    assert flat.max() <= 2.2 * LR * steps, flat.max()
    assert np.quantile(flat, 0.999) <= 2e-5 * steps, np.quantile(flat, 0.999)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("role", ["student", "teacher"])
def test_parameters_after_steps(runs, step, role):
    jstate, _ = runs["jax"][step]
    pout, _ = runs["port"][step]
    jparams = jstate.params if role == "student" else jstate.ema_params
    diffs = []
    for name in LIVE:
        ref = _state_dict(name, jparams[name], runs["stats"].get(name),
                          runs["cfg"])
        ours = pout[role][name]
        for key, value in ours.items():
            if key.endswith(("running_mean", "running_var",
                             "num_batches_tracked")):
                continue
            diffs.append(np.abs(value.numpy() - ref[key].numpy()))
    _param_bounds(diffs, step + 1)


@pytest.mark.parametrize("step", [0, 1])
def test_frozen_and_copy_modules_exact(runs, step):
    jstate, _ = runs["jax"][step]
    pout, _ = runs["port"][step]
    initial = from_jax.state_dicts_from_jax(runs["params"], runs["stats"],
                                            runs["cfg"])
    for name in FROZEN:
        for role in ("student", "teacher"):
            for key, value in pout[role][name].items():
                assert torch.equal(value, initial[name][key]), (role, key)
    for name in LIVE:
        if name in EMA:
            continue
        for key, value in pout["teacher"][name].items():
            assert torch.equal(value, pout["student"][name][key]), key
    # the student's BatchNorm running statistics never move
    for key, value in pout["student"]["backbone_pose_sflow"].items():
        if key.endswith(("running_mean", "running_var")):
            assert torch.equal(value, initial["backbone_pose_sflow"][key])


def test_semantic_teacher_is_the_ema_of_the_student(runs):
    initial = from_jax.state_dicts_from_jax(runs["params"], runs["stats"],
                                            runs["cfg"])
    first, _ = runs["port"][0]
    second, _ = runs["port"][1]
    for key, e0 in initial["semantic_head"].items():
        e1 = 0.99 * e0 + (1.0 - 0.99) * first["student"]["semantic_head"][key]
        assert torch.equal(first["teacher"]["semantic_head"][key], e1), key
        e2 = 0.99 * e1 + (1.0 - 0.99) * second["student"]["semantic_head"][
            key]
        assert torch.equal(second["teacher"]["semantic_head"][key], e2), key


def _port_setup(frozen=FROZEN, make_depth=True, has_replay=True):
    """A port state of seeded weights (no JAX) and its step."""
    cfg = _configure(gen_config(adapt=True, freeze=False))
    cfg.model.make_depth = make_depth
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=4,
                          device="cpu")
    state = make_adapt_state(modules, LR, ema_modules=EMA,
                             frozen_modules=frozen, device="cpu")
    step = make_adapt_step(cfg, [1.0] * NC, has_replay=has_replay,
                           num_mixup=NUM_MIXUP,
                           eval_forward=build_eval_forward(cfg, THINGS, NC))
    return cfg, state, step


def test_teacher_eval_reads_the_weights_before_the_update():
    """With a live depth encoder the teacher evaluates the frame with its
    own modules; the result equals the teacher's evaluation taken before
    the step, bit for bit, though the step moves the student."""
    cfg, state, step = _port_setup(frozen=("instance_head",))
    batch = _batch(3)
    eval_batch = {"frames": torch.from_numpy(batch["target"]["frames"]),
                  **{k: torch.from_numpy(v)
                     for k, v in batch["eval_gt"].items()}}
    before, before_stats = build_eval_forward(cfg, THINGS, NC)(
        state.teacher, eval_batch)
    encoder0 = [p.clone() for p in state.student.backbone_po_depth
                .parameters()]
    _, _, results, stats = step(state, batch)
    assert any(not torch.equal(p, p0) for p, p0 in zip(
        state.student.backbone_po_depth.parameters(), encoder0))
    for key, value in before.items():
        if value is not None:
            assert torch.equal(results[key], value), key
    for key, value in before_stats.items():
        assert torch.equal(stats[key], value), key


def test_do_ema_blends_once_per_frame():
    """``do_ema=False`` keeps the teacher; the next step's blend applies
    the formula once to the student it finds."""
    _, state, step = _port_setup()
    ema0 = {n: [p.clone() for p in getattr(state.teacher, n).parameters()]
            for n in ("semantic_head", "depth_head")}
    batch = _batch(4)
    step(state, dict(batch, do_ema=np.asarray(False)))
    for name, params in ema0.items():
        for e, e0 in zip(getattr(state.teacher, name).parameters(), params):
            assert torch.equal(e, e0), name
    step(state, dict(batch, do_ema=np.asarray(True)))
    for e, e0, p in zip(state.teacher.semantic_head.parameters(),
                        ema0["semantic_head"],
                        state.student.semantic_head.parameters()):
        assert torch.equal(e, 0.99 * e0 + (1.0 - 0.99) * p)
    for e, p in zip(state.teacher.depth_head.parameters(),
                    state.student.depth_head.parameters()):
        assert torch.equal(e, p)


@pytest.mark.parametrize("make_depth,has_replay",
                         [(True, False), (False, True)])
def test_step_without_replay_or_depth(make_depth, has_replay):
    """The step's other branches run: target alone through the depth
    losses (a stream before its replay buffer fills), and no depth head
    at all (no depth losses, no ring push)."""
    _, state, step = _port_setup(make_depth=make_depth,
                                 has_replay=has_replay)
    metrics, features, results, stats = step(state, _batch(5))
    assert ("depth_recon" in metrics) is make_depth
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(state.dist_count) == int(make_depth)
    assert tuple(features.shape) == (1, 512)
    assert results["panoptic"].shape == (1, HT, WT)
    assert ("d_abs_rel" in stats) is make_depth
