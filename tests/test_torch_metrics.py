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

The schedules, Adam and the skip ring are in
``tests/test_torch_metrics_optim.py``: a file holds under 13 tests.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codeps_tpu.evaluation import depth_metrics as jdepth
from codeps_tpu.evaluation import meters as jmeters
from codeps_tpu.evaluation import panoptic_metrics as jpan
from codeps_tpu.evaluation import semantic_metrics as jsem

from codeps_torch.evaluation import (compute_confusion_matrix,
                                     compute_depth_metrics,
                                     compute_depth_metrics_per_class,
                                     compute_sem_miou, meters,
                                     panoptic_metrics)

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
