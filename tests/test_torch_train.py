"""The port's pretraining step against ``codeps_tpu.tasks.train.
make_train_step`` on the same weights, batches and automask noise.

Setup of ``tests/test_train_step.py`` at 64x96: ResNet-18 for both
encoders, depth, pose, GUDA semantic (14 classes, class 3 ignored, top-k
0.2) and instance heads with the thing mask, batch 2 with depth GT, the
depth encoder frozen by the prefix ``backbone_po_`` (the CLI's rule), Adam
at 1e-4, float32 on both sides (``cfg.tpu.compute_dtype``). The automask
noise is the normals JAX draws from the step's key chain (``train.py:215,
101``, ``photometric.py:187``), injected into the port's step. One JAX
compile of the multi-task step serves the tests of it (module fixture);
the depth-only config (``cfg/train_cityscapes_depth_only.yaml``'s
modules) has its own.

The JAX step does not return gradients; its Adam moments after the first
step are ``0.1 g`` (b1 = 0.9 from zeros), and after the second
``0.9 m1 + 0.1 g2``, which give them back.

Tolerances, each with its reason:
  - losses and depth metrics: relative 1e-4 (oneDNN and XLA sum the
    convolutions in different orders; Flax's BatchNorm takes the fast
    variance E[x^2] - E[x]^2);
  - gradients of the first step: 1e-4 of the module's largest gradient
    (measured: pose backbone 5.9e-5, pose head 2.8e-5, depth head 1.2e-5,
    semantic head 8e-7). A tensor whose own gradient is near 0 by
    cancellation (a BatchNorm scale whose output the next BatchNorm
    normalizes again) is float noise on both sides, so the bound is the
    module's. The instance head: 2.5e-4 of its largest (measured
    1.6e-4). Its every layer runs train-mode BatchNorm over few elements
    a channel, which amplifies the difference of the encoder's features
    (1.5e-5 of their largest at layer4; the frozen encoder too runs
    train-mode BatchNorm) about tenfold; on equal features its gradients
    hold 2.5e-5 (measured 1.2e-6, a test of its own). The second
    step's gradients are not compared: after the first update the weights
    already differ within the parameter bound below, which moves them
    by more than float noise; the parameters after two steps are held;
  - parameters after n Adam steps: each step moves a component by about
    lr * sign(g), so a gradient near 0 whose sign differs moves it by up
    to 2 lr: max |diff| <= 2.2 lr n, and 99.9% of a module's components
    within 2e-5 n (test_torch_adapt.py);
  - BatchNorm running statistics: 1e-5 of the tensor's largest value plus
    1e-5 absolute after step 1 (the batch statistics of equal weights);
    after step 2 the weights differ within the bound above, and so do the
    statistics, by up to 2e-4 of their largest value. The rule that moves
    them must be Flax's biased variance: at the encoder's layer4 (6
    elements a channel per image) torch's unbiased variance is 12/11 of
    it, far outside;
  - frozen parameters: exact; the confusion matrix: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import get_cfg_defaults as jax_cfg_defaults
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.tasks import TrainState as JaxTrainState
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer
from codeps_tpu.tasks import make_train_step as jax_make_train_step

from codeps_torch.config import get_cfg_defaults
from codeps_torch.io import from_jax
from codeps_torch.models import build_modules
from codeps_torch.tasks.state import make_train_state, match_prefixes
from codeps_torch.tasks.train import make_train_step

H, W = 64, 96
B = 2
NC = 14
IGNORE = [3]
LR = 1e-4
NUM_SCALES = 5
FREEZE_PREFIXES = ["backbone_po_"]
REL_TOL = 1e-4
# gradients, of the module's largest (see the docstring)
GRAD_TOL = 1e-4
INSTANCE_GRAD_TOL = 2.5e-4
EQUAL_FEATURES_GRAD_TOL = 2.5e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the port: the tier-1 run's workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configure(cfg, multitask=True):
    cfg.model.make_semantic = cfg.model.make_instance = multitask
    cfg.model.instance_head.use_thing_mask = True
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.semantics.top_k = 0.2
    cfg.losses.weights.center = 20.0
    cfg.losses.weights.offset = 0.1
    cfg.losses.weights.thing_mask = 0.5
    cfg.dataset.feed_img_size = [H, W]
    cfg.tpu.compute_dtype = "float32"
    return cfg


def _batch(seed, multitask=True):
    rng = np.random.default_rng(seed)
    batch = {
        "frames": rng.integers(0, 256, (B, 3, H, W, 3), dtype=np.uint8),
        "camera": np.tile(np.asarray([[40.0, 40.0, W / 2, H / 2]],
                                     np.float32), (B, 1)),
        "depth_gt": np.where(rng.random((B, H, W)) < 0.2, 0.0,
                             rng.uniform(1, 60, (B, H, W))).astype(
                                 np.float32),
    }
    if multitask:
        batch.update({
            "semantic": rng.integers(0, NC, (B, H, W)).astype(np.int32),
            "semantic_weights": rng.uniform(0.5, 2.0, (B, H, W)).astype(
                np.float32),
            "center": rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32),
            "center_weights": np.ones((B, H, W, 1), np.float32),
            "offset": rng.normal(0, 4, (B, H, W, 2)).astype(np.float32),
            "offset_weights": np.ones((B, H, W, 1), np.float32),
            "thing_mask": rng.integers(0, 2, (B, H, W)).astype(np.int32),
        })
    return batch


def jax_step_noise(state_rng):
    """The automask normals of one JAX step from ``state.rng``: the step
    splits it (``train.py:215``), the loss splits its half again
    (``:101``), the loss one key a scale (``photometric.py:187``)."""
    _, sub = jax.random.split(state_rng)
    _, key = jax.random.split(sub)
    out = []
    for s in range(NUM_SCALES):
        key, draw_key = jax.random.split(key)
        draw = jax.random.normal(draw_key, (B, H >> s, W >> s, 2),
                                 jnp.float32)
        out.append(np.asarray(draw).transpose(0, 3, 1, 2))
    return out


class Injected:
    """Hands out given arrays in order, checking the shapes asked for."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape):
        draw = self.arrays.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(np.array(draw))


def _module_state_dicts(jparams, jstats, cfg):
    return from_jax.state_dicts_from_jax(jparams, jstats, cfg)


def _run(multitask, steps):
    """Both steps from one seeded JAX initialization; returns per step the
    JAX state and metrics and the port's state dicts, gradients and
    metrics."""
    jcfg = _configure(jax_cfg_defaults(), multitask)
    pcfg = _configure(get_cfg_defaults(), multitask)
    jmodules = jax_build_modules(jcfg, num_classes=NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules, (H, W))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    frozen = match_prefixes(sorted(params), FREEZE_PREFIXES)
    tx = jax_build_optimizer(jcfg, LR, frozen_modules=frozen)
    ignore = IGNORE if multitask else None
    jstep = jax_make_train_step(
        jmodules, jcfg, tx, class_weights=[1.0] * NC,
        sem_ignore_classes=ignore, num_classes=NC,
        eval_ignore_classes=ignore or (), donate=False,
        frozen_modules=frozen)
    js = JaxTrainState(params=jax.tree.map(jnp.asarray, params),
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(7))

    modules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                     params, stats, pcfg)
    ps = make_train_state(modules, LR, frozen_modules=frozen, device="cpu")
    pstep = make_train_step(pcfg, [1.0] * NC, sem_ignore_classes=ignore,
                            num_classes=NC, eval_ignore_classes=ignore or ())
    out = {"init": (params, stats), "frozen": frozen, "cfg": pcfg,
           "jax": [], "port": []}
    for i in range(steps):
        batch = _batch(10 + i, multitask)
        noise = jax_step_noise(js.rng)
        js, jmetrics = jstep(js, jax.tree.map(jnp.asarray, batch))
        out["jax"].append((jax.tree.map(np.array, js.params),
                           jax.tree.map(np.array, js.batch_stats),
                           [np.array(leaf) for leaf in
                            jax.tree.leaves(js.opt_state)],
                           jax.tree.map(np.array, jmetrics)))
        pmetrics = pstep(ps, batch, noise=Injected(noise))
        out["port"].append((
            {name: {k: v.clone() for k, v in
                    getattr(ps.modules, name).state_dict().items()}
             for name in ps.modules.module_names()},
            {name: {k: p.grad.clone() for k, p in
                    getattr(ps.modules, name).named_parameters()}
             for name in ps.live_modules()},
            {k: v.clone() for k, v in pmetrics.items()}))
    assert ps.step == steps
    return out


@pytest.fixture(scope="module")
def multitask():
    return _run(True, steps=2)


def _rel_close(ours, ref, rel, what):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rel * abs(ref), (what, ours, ref)


@pytest.mark.parametrize("step", [0, 1])
def test_losses_and_metrics_match(multitask, step):
    jmetrics = multitask["jax"][step][3]
    pmetrics = multitask["port"][step][2]
    assert set(pmetrics) == set(jmetrics)
    assert {"depth_recon", "depth_smth", "semantic", "center", "offset",
            "thing_mask", "loss_total", "sem_conf", "d_abs_rel"} \
        <= set(pmetrics)
    for key, ref in jmetrics.items():
        if key == "sem_conf":
            np.testing.assert_array_equal(pmetrics[key].numpy(), ref)
            # every GT pixel but the ignored class's counts once
            labels = _batch(10 + step)["semantic"]
            assert int(ref.sum()) == int((labels != IGNORE[0]).sum())
            assert ref[IGNORE[0]].sum() == ref[:, IGNORE[0]].sum() == 0
        else:
            _rel_close(pmetrics[key], ref, REL_TOL, key)


def _moments_tree(leaves, params, live):
    """Adam's first moments as JAX trees of the live modules' params
    (optax's leaf order: count, mu, nu)."""
    trained = {name: params[name] for name in live}
    flat, treedef = jax.tree.flatten(trained)
    n = len(flat)
    mu = jax.tree.unflatten(treedef, leaves[1:1 + n])
    return mu


def test_gradients_match(multitask):
    params, stats = multitask["init"]
    cfg = multitask["cfg"]
    live = [m for m in sorted(params) if m not in multitask["frozen"]]
    assert live == ["backbone_pose_sflow", "depth_head", "instance_head",
                    "pose_head", "semantic_head"]
    mu = _moments_tree(multitask["jax"][0][2], params, live)
    ref = _module_state_dicts(jax.tree.map(lambda m: m / 0.1, mu), stats,
                              cfg)
    grads = multitask["port"][0][1]
    assert set(grads) == set(live)
    for name in live:
        largest = max(float(np.abs(ref[name][key].numpy()).max())
                      for key in grads[name])
        tol = INSTANCE_GRAD_TOL if name == "instance_head" else GRAD_TOL
        for key, g in grads[name].items():
            err = float(np.abs(g.numpy() - ref[name][key].numpy()).max())
            assert err <= tol * largest, (name, key, err, tol * largest)


def test_instance_head_gradients_on_equal_features():
    """The instance head's train-mode gradients on the same encoder
    features on both sides: the tolerance of the other modules holds."""
    from codeps_tpu.losses import binary_mask_loss as jax_mask_loss
    from codeps_tpu.losses import center_loss as jax_center_loss
    from codeps_tpu.losses import offset_loss as jax_offset_loss

    from codeps_torch.losses import (binary_mask_loss, center_loss,
                                     offset_loss)
    jcfg = _configure(jax_cfg_defaults())
    pcfg = _configure(get_cfg_defaults())
    jmodules = jax_build_modules(jcfg, num_classes=NC)
    params, stats = jax_init_params(jax.random.PRNGKey(1), jmodules, (H, W))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    rng = np.random.default_rng(3)
    feats = [rng.normal(0, 1, (B, H >> (i + 1), W >> (i + 1), c)).astype(
        np.float32) for i, c in enumerate((64, 64, 128, 256, 512))]
    batch = _batch(12)

    def jax_loss(p):
        (center, offset, mask), _ = jmodules.instance_head.apply(
            {"params": p, "batch_stats": stats["instance_head"]},
            [jnp.asarray(f) for f in feats], train=True,
            mutable=["batch_stats"])
        return (20.0 * jax_center_loss(center, batch["center"])
                + 0.1 * jax_offset_loss(offset, batch["offset"])
                + 0.5 * jax_mask_loss(mask, batch["thing_mask"]))

    grads = jax.jit(jax.grad(jax_loss))(params["instance_head"])
    ref = from_jax.instance_head(jax.tree.map(np.array, grads),
                                 stats["instance_head"], True)
    head = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                  params, stats, pcfg).instance_head.train()
    center, offset, mask = head([torch.from_numpy(f).permute(0, 3, 1, 2)
                                 .contiguous() for f in feats])
    loss = (20.0 * center_loss(center.permute(0, 2, 3, 1),
                               torch.from_numpy(batch["center"]))
            + 0.1 * offset_loss(offset.permute(0, 2, 3, 1),
                                torch.from_numpy(batch["offset"]))
            + 0.5 * binary_mask_loss(mask,
                                     torch.from_numpy(batch["thing_mask"])))
    loss.backward()
    largest = max(float(np.abs(v.numpy()).max()) for k, v in ref.items()
                  if "running" not in k and "num_batches" not in k)
    for key, param in head.named_parameters():
        err = float(np.abs(param.grad.numpy() - ref[key].numpy()).max())
        assert err <= EQUAL_FEATURES_GRAD_TOL * largest, (key, err, largest)


@pytest.mark.parametrize("step", [0, 1])
def test_parameters_and_running_stats_match(multitask, step):
    cfg = multitask["cfg"]
    jparams, jstats = multitask["jax"][step][:2]
    ref = _module_state_dicts(jparams, jstats, cfg)
    ours = multitask["port"][step][0]
    init = _module_state_dicts(*multitask["init"], cfg)
    n = step + 1
    stat_tol = 1e-5 if step == 0 else 2e-4
    for name, sd in ours.items():
        diffs = []
        for key, value in sd.items():
            if key.endswith("num_batches_tracked"):
                assert int(value) == n, (name, key)
                continue
            expected = ref[name][key].numpy()
            value = value.numpy()
            if key.endswith(("running_mean", "running_var")):
                err = np.abs(value - expected).max()
                bound = stat_tol * np.abs(expected).max() + 1e-5
                assert err <= bound, (name, key, err, bound)
                # the statistics moved: frozen modules update them too
                assert not np.array_equal(value, init[name][key].numpy()), \
                    (name, key)
            elif name in multitask["frozen"]:
                np.testing.assert_array_equal(value, expected)
                np.testing.assert_array_equal(value,
                                              init[name][key].numpy())
            else:
                diffs.append(np.abs(value - expected).ravel())
        if diffs:
            flat = np.concatenate(diffs)
            assert flat.max() <= 2.2 * LR * n, (name, flat.max())
            assert np.mean(flat <= 2e-5 * n) >= 0.999, name


def test_running_variance_is_the_biased_one(multitask):
    """The frozen depth encoder's layer4 sees B x (H/32) x (W/32) = 12
    elements a channel: torch's unbiased update would move its running
    variance by 12/11 of Flax's batch share, far outside the
    tolerance."""
    params, stats = multitask["init"]
    jstats = multitask["jax"][0][1]
    key = "encoder.layer4.1.bn2.running_var"
    ours = multitask["port"][0][0]["backbone_po_depth"][key].numpy()
    ref = _module_state_dicts(multitask["jax"][0][0], jstats,
                              multitask["cfg"])["backbone_po_depth"][
                                  key].numpy()
    init = np.asarray(stats["backbone_po_depth"]["layer4_1"]["conv2"]
                      ["bn"]["var"])
    batch_var = (ref - 0.9 * init) / 0.1
    n = B * (H // 32) * (W // 32)
    assert n == 12
    unbiased = 0.9 * init + 0.1 * batch_var * n / (n - 1)
    assert np.abs(unbiased - ref).max() > 100 * np.abs(ours - ref).max()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_depth_only_config_matches():
    """cfg/train_cityscapes_depth_only.yaml's modules (ResNet-18 depth and
    pose, no semantic or instance head), one step without labels."""
    out = _run(False, steps=1)
    jparams, jstats, _, jmetrics = out["jax"][0]
    ours, _, pmetrics = out["port"][0]
    assert set(pmetrics) == set(jmetrics)
    assert "sem_conf" not in pmetrics
    for key, ref in jmetrics.items():
        _rel_close(pmetrics[key], ref, REL_TOL, key)
    ref = _module_state_dicts(jparams, jstats, out["cfg"])
    assert set(ours) == {"backbone_po_depth", "backbone_pose_sflow",
                         "depth_head", "pose_head"}
    for name in ("depth_head", "pose_head"):
        for key, value in ours[name].items():
            diff = np.abs(value.numpy() - ref[name][key].numpy())
            assert diff.max() <= 2.2 * LR, (name, key)
