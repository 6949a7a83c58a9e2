"""Spatial (row) sharding of the adaptation step over processes
(``codeps_torch/parallel/spatial.py``, the counterpart of
``codeps_tpu/parallel/spatial.py``), on the CPU over gloo.

One spawn of 2 ranks (``tests/_spatial_worker.py``, one intra-op thread
each) serves the module and ``tests/test_torch_spatial_hybrid.py``
(``tests/torch_spatial_cases.py``): each check here runs on the ranks'
rows inside ``spatial.rows()`` and is held against the same port code in
one process (``parallel.replicated()``), or against the JAX package's
step:

  - ``halo_rows`` (zeros, reflect, replicate and -inf edges, halos of 0-3
    rows) and ``gather_rows`` against the padding and concatenation of
    the whole tensor, forward and backward (each rank's loss weighs its
    own output), float64, on even slabs and on the uneven slabs of 96
    rows (2 + 1 blocks) at strides 32 and 16, where a reflection at the
    image's edge reaches into the neighbour's rows: outputs equal,
    gradients within 1e-12 relative;
  - each ported module and loss at 64x96 in float64 (ResNet-18 and
    ResNet-50 in eval and train mode, the depth, semantic (GUDA and
    reflect-padded) and instance heads, the bilinear and nearest resizes,
    the warp, the reconstruction, smoothness, top-k semantic and instance
    losses): outputs (gathered, or the ranks' shares summed) and
    gradients within 1e-10 relative of one process (measured at most
    1.4e-11, the instance head's train-mode BatchNorm at 2x3 pixels);
  - the resizes and the warp also on the uneven slabs of 96 rows;
  - the whole adaptation step in float64, 2 steps with the published
    freezing and the fused cut mixup (the teacher's labels gathered before
    the camera warp), 1 step with a live depth encoder, 1 published step
    at 96 rows (2 + 1 blocks), 1 step with the scene-flow head and a live
    depth encoder (its motion pair in the eval results): losses and every
    live module's gradient within 1e-10 relative, parameters after the
    steps within 1e-12, replay features, ``sem_conf`` and the fused
    panoptic map equal; rank 0 alone scores the teacher eval;
  - the step in float32 against the JAX package's ``make_adapt_step`` on
    the same weights, batch and automask noise, with
    ``tests/test_torch_adapt.py``'s tolerances (losses and depth metrics
    1e-4 relative, eval maps and replay features 1e-4 of their maximum,
    the semantic, panoptic and instance maps and ``sem_conf`` equal;
    gradients 2e-4 of each tensor's maximum and 1e-4 relative L2 a
    module) or, for a module's gradients, 1.5 times the distance of the
    one-process port's step from JAX on the same inputs, whichever is
    larger. At 64x96, the least height that splits over 2 ranks, the pose
    net's train-mode BatchNorm normalizes 24 values a channel in layer4
    and amplifies float32 rounding: the one-process port's gradients lie
    1.1e-2 (pose net), 2.3e-4 (pose head) and 1.1e-4 (depth head) from
    JAX's by relative L2, past those tolerances, which
    ``tests/test_torch_adapt.py`` meets at 32x64 (the semantic head's:
    5.7e-7);
  - ``AdaptationRunner`` with ``tpu.spatial_shard`` streaming the
    synthetic KITTI-360 tree for 3 frames on 2 ranks (its steps under the
    hybrid placement: source and mixup by images, the replay by rows)
    against one process:
    equal buffer ids and step counts, PQ, mIoU and abs_rel within
    ``scripts/parity_e2e.py:52-54``'s tolerances, losses within 1e-5
    relative (float32 sums of the ranks' shares);
  - heights that are not whole 32-row blocks raise; 32 rows (fewer
    blocks than ranks: ``tests/test_torch_spatial_empty.py``) and 96 rows
    do not, and the flow head streams 2 frames.
"""

import numpy as np
import pytest
import torch

import _spatial_worker as worker
import torch_spatial_cases as cases
from codeps_torch.parallel import spatial

MODULE_TOL = cases.MODULE_TOL
HALO_GRAD_TOL = 1e-12
PARAM_TOL = cases.PARAM_TOL
RUNNER_LOSS_REL = 1e-5
PQ_TOL = MIOU_TOL = ABS_REL_TOL = 0.005


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every check's results on each of the 2 ranks, and the JAX step's
    outputs (one spawn, shared with ``tests/test_torch_spatial_hybrid.py``:
    ``tests/torch_spatial_cases.py``)."""
    return cases.spawned(tmp_path_factory)


def test_halo_and_gather_rows(ranks):
    for result in ranks["ranks"]:
        assert len(result["halo"]) == sum(len(cases) + 1 for _, _, cases
                                          in worker.HALO_SIZES)
        for name, case in result["halo"].items():
            assert case["out"] == 0.0, (name, case)
            assert case.get("inf_equal", True), name
            assert case["grad"] <= HALO_GRAD_TOL, (name, case)


def _module_distances(ranks, prefixes):
    found = 0
    for result in ranks["ranks"]:
        for name, distances in result["modules"].items():
            if name.startswith(prefixes):
                found += 1
                for key, value in distances.items():
                    assert value <= MODULE_TOL, (name, key, value)
    return found


def test_encoders_match_one_process(ranks):
    assert _module_distances(ranks, ("encoder",)) == 2 * 4


def test_heads_match_one_process(ranks):
    assert _module_distances(ranks, ("depth head", "semantic head",
                                     "instance head")) == 2 * 4


def test_resizes_and_warp_match_one_process(ranks):
    # at 64 rows (32 + 32) and at 96 (64 + 32)
    assert _module_distances(ranks, ("resize", "warp")) == 2 * 2 * 6


def test_losses_match_one_process(ranks):
    assert _module_distances(ranks, ("reconstruction", "smoothness",
                                     "semantic loss", "instance loss")) \
        == 2 * 4


@pytest.mark.parametrize("variant", [v[0] for v in worker.STEP_VARIANTS])
def test_step_float64_matches_one_process(ranks, variant):
    lead, follower = (r["step"][variant] for r in ranks["ranks"])
    # every rank holds the global metrics; rank 0 alone scores the eval
    assert lead["metrics"] == follower["metrics"]
    assert not any(lead["eval_on_followers"])
    assert all(follower["eval_on_followers"])
    assert lead["loss_rel"] <= MODULE_TOL, lead["loss_rel"]
    assert set(lead["grad_rel_l2"]) >= {"backbone_pose_sflow", "depth_head",
                                        "pose_head", "semantic_head"}
    for name, value in lead["grad_rel_l2"].items():
        assert value <= MODULE_TOL, (name, value)
    assert lead["param_diff"] <= PARAM_TOL, lead["param_diff"]
    assert lead["features"] == 0.0
    assert lead["eval_maps"] <= MODULE_TOL
    assert lead["checks"] == len(lead["metrics"])
    assert lead["sem_conf_equal"] and lead["panoptic_equal"]


def test_step_float32_matches_jax(ranks):
    ours = ranks["ranks"][0]["jax"]
    assert ranks["ranks"][1]["jax"]["metrics"] == ours["metrics"]
    cases.check_against_jax(ours, ours["one_process"], ranks["jax"])


def test_runner_matches_one_process(ranks):
    lead = ranks["ranks"][0]["runner"]
    ours, ref = lead["spatial"], lead["one_process"]
    assert ours["ids"] == ref["ids"]
    assert ours["steps"] == ref["steps"] == worker.RUNNER_FRAMES
    # a broadcast a frame, then the stop message
    assert len(ours["row_times"]["broadcast"]) == worker.RUNNER_FRAMES + 1
    follower = ranks["ranks"][1]["runner"]["spatial"]
    assert len(follower["row_times"]["step"]) == worker.RUNNER_FRAMES
    assert follower["steps"] == 0
    values, expect = ours["values"], ref["values"]
    for key, tol in (("metrics.p_pq", PQ_TOL), ("metrics.sem_miou",
                                                 MIOU_TOL),
                     ("metrics.d_abs_rel", ABS_REL_TOL)):
        assert abs(values[key] - expect[key]) <= tol, key
    for key, value in expect.items():
        if key.startswith("losses."):
            assert abs(values[key] - value) <= RUNNER_LOSS_REL * abs(
                value), key


def test_raises(ranks):
    for result in ranks["ranks"]:
        raises = result["raises"]
        # not a multiple of 32 rows; fewer blocks than ranks step, rank
        # 1's slab empty
        assert "80 rows does not split over 2 ranks" in raises[80]
        assert raises[32] == "no error"
        # 2 + 1 blocks, and the flow head's stream
        assert raises[worker.UNEVEN_H] == "no error"
        assert raises["flow"] == "no error"
    assert ranks["ranks"][0]["raises"]["flow_steps"] == 2


def test_rows_without_a_group_change_nothing():
    """Outside a process group ``spatial.rows()`` is inactive: the step
    inside it computes bit for bit what it computes outside."""
    cfg = worker.step_config()
    batch = worker.step_batch(60, np.uint8)
    runs = []
    for split in (False, True):
        modules, step = worker.build_step(cfg)
        if split:
            with spatial.rows():
                assert not spatial.active()
                runs.append(worker.run_steps(modules, step, [batch]))
        else:
            runs.append(worker.run_steps(modules, step, [batch]))
    (plain, plain_sds), (rows, rows_sds) = runs
    assert plain[0]["metrics"] == rows[0]["metrics"]
    for name, grads in plain[0]["grads"].items():
        for key, grad in grads.items():
            assert torch.equal(rows[0]["grads"][name][key], grad), key
    assert torch.equal(plain[0]["results"]["panoptic"],
                       rows[0]["results"]["panoptic"])
