"""The port's evaluation metrics (depth, per-class depth, confusion
matrix, PQ, the meters), learning-rate schedules, Adam and skip ring
against the JAX package's, on the same numpy-seeded inputs.

Tolerances: metrics 1e-6 relative (the same float32 formulas summed in
another order; the medians are exact order statistics on both sides),
confusion matrices, mIoU, PQ and the meters exact; schedules 5e-7
relative, looser near the poly schedule's end (the JAX schedules run in
float32, the port's in Python floats); Adam within 4 float32 ulp of the
weights after three steps (float32 moments, another order of
operations); the ring exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from codeps_tpu.evaluation import depth_metrics as jdepth
from codeps_tpu.evaluation import meters as jmeters
from codeps_tpu.evaluation import panoptic_metrics as jpan
from codeps_tpu.evaluation import semantic_metrics as jsem
from codeps_tpu.tasks import optim as joptim
from codeps_tpu.tasks.adapt import (push_ring_buffer as jax_push,
                                    skip_decision as jax_skip)

from codeps_torch.evaluation import (compute_confusion_matrix,
                                     compute_depth_metrics,
                                     compute_depth_metrics_per_class,
                                     compute_sem_miou, meters,
                                     panoptic_metrics)
from codeps_torch.tasks import optim
from codeps_torch.tasks.adapt import push_ring_buffer, skip_decision

B, H, W, C = 2, 24, 40, 14


def _depth_inputs(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 90.0, (B, H, W)).astype(np.float32)
    gt[rng.random((B, H, W)) < 0.3] = 0.0          # void
    pred = rng.uniform(0.2, 60.0, (B, H, W, 1)).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("use_gt_scale", [True, False])
def test_depth_metrics_match(use_gt_scale):
    gt, pred = _depth_inputs(0)
    ref = jdepth.compute_depth_metrics(jnp.asarray(gt), jnp.asarray(pred),
                                       use_gt_scale, (0.1, 80.0))
    ours = compute_depth_metrics(torch.from_numpy(gt),
                                 torch.from_numpy(pred), use_gt_scale,
                                 (0.1, 80.0))
    assert set(ours) == set(ref) == set(jdepth.METRIC_KEYS)
    for key, value in ref.items():
        np.testing.assert_allclose(float(ours[key]), float(value),
                                   rtol=1e-6, err_msg=key)


def test_depth_metrics_skip_frames_without_gt():
    gt, pred = _depth_inputs(1)
    gt[1] = 0.0
    ref = jdepth.compute_depth_metrics(jnp.asarray(gt), jnp.asarray(pred))
    ours = compute_depth_metrics(torch.from_numpy(gt),
                                 torch.from_numpy(pred))
    for key, value in ref.items():
        np.testing.assert_allclose(float(ours[key]), float(value),
                                   rtol=1e-6, err_msg=key)
    empty = compute_depth_metrics(torch.zeros(B, H, W),
                                  torch.from_numpy(pred))
    assert all(bool(torch.isnan(v)) for v in empty.values())


def test_confusion_matrix_and_miou_match():
    rng = np.random.default_rng(4)
    pred = rng.integers(0, C, (B, H, W)).astype(np.int32)
    gt = rng.integers(0, C, (B, H, W)).astype(np.int32)
    gt[0, :2] = 255
    gt[1, :1] = C + 3                               # out of range: dropped
    ref = jsem.compute_confusion_matrix(jnp.asarray(pred), jnp.asarray(gt),
                                        C, ignore_classes=(4,))
    ours = compute_confusion_matrix(torch.from_numpy(pred),
                                    torch.from_numpy(gt), C,
                                    ignore_classes=(4,))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for sum_pixels in (False, True):
        np.testing.assert_array_equal(
            compute_sem_miou(ours, C, (4,), sum_pixels),
            jsem.compute_sem_miou(np.asarray(ref), C, (4,), sum_pixels))


@pytest.mark.parametrize("method,constant_ending",
                         [("linear", 0.0), ("constant", 0.0),
                          ("linear", 0.3)])
def test_warmup_poly_schedule_matches(method, constant_ending):
    args = (1e-3, 500, 0.01, 50, method, 0.9, constant_ending)
    ref = joptim.warmup_poly_schedule(*args)
    ours = optim.warmup_poly_schedule(*args)
    for count in (0, 1, 25, 49, 50, 51, 300, 480, 499, 500, 700):
        # JAX forms 1 - count / max_iters in float32, whose relative error
        # grows as the difference nears 0
        rtol = 5e-7 / max(1.0 - count / 500, 1.0 / 500)
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=rtol, atol=1e-12, err_msg=count)


def test_step_lr_schedule_matches():
    ref = joptim.step_lr_schedule(1e-4, 2, 0.1, 30)
    ours = optim.step_lr_schedule(1e-4, 2, 0.1, 30)
    for count in (0, 29, 30, 59, 60, 61, 119, 120, 500):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, err_msg=count)


def test_adam_matches_optax():
    """Three steps of the port's Adam (torch defaults) against optax's
    adam with the same learning rate on the same gradients."""
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) for _ in range(3)]
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    ref, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(ref)
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    adam = optim.build_optimizer([param], 1e-3)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, ref)
        ref = optax.apply_updates(ref, updates)
        param.grad = torch.from_numpy(g)
        adam.step()
    # updates of ~1e-3 on weights of ~1: the float32 rounding of the
    # weights themselves (a few ulp of max|w|) bounds the agreement
    err = np.abs(param.detach().numpy() - np.asarray(ref)).max()
    assert err <= 4 * np.finfo(np.float32).eps * np.abs(w0).max(), err
    assert np.abs(np.asarray(ref) - w0).max() > 1e-3


@pytest.mark.parametrize("count,dist", [(5, 0.5), (300, 0.01), (300, 0.5)])
def test_skip_ring_matches(count, dist):
    buf = np.linspace(0.2, 1.0, 300).astype(np.float32)
    buf[count:] = 0.0
    head = count % 300 if count < 300 else 17
    args_j = (jnp.asarray(buf), jnp.asarray(count, jnp.int32),
              jnp.asarray(head, jnp.int32))
    args_t = (torch.from_numpy(buf), torch.tensor(count), torch.tensor(head))
    skip_j = jax_skip(args_j[0], args_j[1], jnp.asarray(dist, jnp.float32))
    skip_t = skip_decision(args_t[0], args_t[1], torch.tensor(dist))
    assert bool(skip_t) == bool(skip_j) == (count == 300 and dist < 0.06)
    ref = jax_push(*args_j, jnp.asarray(dist, jnp.float32), skip_j)
    ours = push_ring_buffer(*args_t, torch.tensor(dist), skip_t)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# ------------------------------------------------------- stream meters


@pytest.mark.parametrize("use_gt_scale", [True, False])
def test_depth_metrics_per_class_match(use_gt_scale):
    gt, pred = _depth_inputs(2)
    rng = np.random.default_rng(2)
    semantic = rng.integers(0, C - 3, (B, H, W)).astype(np.int32)
    semantic[0, :4] = C - 1            # a class only on void GT pixels
    gt[0, :4] = 0.0
    ref = jdepth.compute_depth_metrics_per_class(
        jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(semantic), C,
        use_gt_scale, (0.1, 80.0))
    ours = compute_depth_metrics_per_class(
        torch.from_numpy(gt), torch.from_numpy(pred),
        torch.from_numpy(semantic), C, use_gt_scale, (0.1, 80.0))
    assert set(ours) == set(ref)
    assert len(ref) == 7 * C
    for key, value in ref.items():
        value = float(value)
        if np.isnan(value):            # classes absent from the GT
            assert np.isnan(float(ours[key])), key
        else:
            np.testing.assert_allclose(float(ours[key]), value, rtol=1e-6,
                                       err_msg=key)
    assert np.isnan(float(ours[f"d_abs_rel_c{C - 1}"]))
    assert np.isnan(float(ours[f"d_abs_rel_c{C - 2}"]))


def _panoptic_maps(seed, batch=2, height=24, width=40):
    """GT and predicted panoptic ids (class * 1000 + instance, -1 void)
    with overlapping segments."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((batch, height, width), np.int32)
    for b in range(batch):
        gt[b] = rng.integers(0, 3, (1, 1)) * 1000
        gt[b, :, width // 2:] = 2000
        for i in range(4):
            y, x = rng.integers(0, height - 6), rng.integers(0, width - 8)
            gt[b, y:y + 6, x:x + 8] = (11 + i % 2) * 1000 + i + 1
    gt[:, -2:] = -1
    pred = gt.copy()
    shift = rng.integers(-2, 3, (batch, height, width)) == 2
    pred[shift] = np.roll(gt, 3, axis=2)[shift]
    pred[:, :3, :5] = 12009                  # a false positive
    pred[0, -2:, :20] = 2000                 # prediction on void
    return gt, pred


def test_panoptic_evaluator_matches():
    stuff, things = list(range(9)), list(range(9, 14))
    ref = jpan.PanopticEvaluator(stuff, things)
    ours = panoptic_metrics.PanopticEvaluator(stuff, things)
    for seed in range(3):
        gt, pred = _panoptic_maps(seed)
        ref.update(gt, pred)
        ours.update(gt, pred)
        a, b = ours.evaluate(), ref.evaluate()
        for group in ("All", "Things", "Stuff"):
            assert a[group]["n"] == b[group]["n"]
            for key in ("pq", "sq", "rq"):
                assert a[group][key] == b[group][key], (group, key)
        assert a["per_class"] == b["per_class"]
    stats = panoptic_metrics.compute_panoptic_stats(gt[0], pred[0])
    ref_stats = jpan.compute_panoptic_stats(gt[0], pred[0])
    for cat, stat in ref_stats.pq_per_cat.items():
        mine = stats[cat]
        assert (mine.tp, mine.fp, mine.fn, mine.iou) == (
            stat.tp, stat.fp, stat.fn, stat.iou), cat
    ours.reset()
    assert ours.evaluate()["All"]["n"] == 0


def test_meters_match():
    rng = np.random.default_rng(0)
    pairs = [(meters.AverageMeter((), momentum=0.9),
              jmeters.AverageMeter((), momentum=0.9)),
             (meters.ConstantMeter(()), jmeters.ConstantMeter(())),
             (meters.ConfusionMatrixMeter(4), jmeters.ConfusionMatrixMeter(4)),
             (meters.PanopticMeter(3), jmeters.PanopticMeter(3))]
    for ours, ref in pairs:
        assert float(np.asarray(ours.value).sum()) == float(
            np.asarray(ref.value).sum()) == 0.0
        for _ in range(4):
            value = rng.uniform(0, 5, np.shape(ref.last))
            ours.update(value)
            ref.update(value)
        for key, expect in ref.state_dict().items():
            np.testing.assert_array_equal(ours.state_dict()[key], expect)
        np.testing.assert_array_equal(np.asarray(ours.value),
                                      np.asarray(ref.value))
    conf, ref_conf = pairs[2]
    for name in ("iou", "precision", "recall"):
        np.testing.assert_array_equal(getattr(conf, name),
                                      getattr(ref_conf, name))
    restored = meters.AverageMeter(())
    restored.load_state_dict(pairs[0][0].state_dict())
    assert restored.value == pairs[0][0].value
    with pytest.raises(KeyError):
        restored.load_state_dict({"bogus": 1})
