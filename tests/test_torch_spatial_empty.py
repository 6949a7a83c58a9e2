"""Row sharding with fewer 32-row blocks than ranks
(``codeps_torch/parallel/spatial.py``): the last ranks' slabs are empty,
as the JAX package's GSPMD split takes any multiple-of-32 height over any
mesh (``codeps_tpu/parallel/spatial.py``'s ``shard_adapt_batch_spatial``;
its test splits 32 rows over 8 devices). On the CPU over gloo.

The checks run in the 2-rank spawn that ``tests/test_torch_spatial.py``
reads too (``tests/torch_spatial_cases.py``): at 32 rows, one block,
rank 1 holds no row at any level of the pyramid, and every check is held
against the same port code in one process (``parallel.replicated()``) or
against the JAX package's step:

  - ``halo_rows`` and ``gather_rows`` at strides 1 to 32, every edge mode
    and halos of 0-3 rows, forward and backward against the padding and
    concatenation of the whole tensor in float64: outputs equal (an empty
    slab gets no rows), gradients within 1e-12 relative;
  - ResNet-18 and ResNet-50 in eval and train mode (train-mode BatchNorm
    with an empty rank), the depth, semantic and instance heads, the
    resizes and the warp, the reconstruction, smoothness, top-k semantic
    and instance losses, at 32x96 in float64: outputs and gradients
    within 1e-10 relative of one process;
  - the float64 step at 32 target and 32 source rows against one
    process: the published freezing under pure rows, a live depth
    encoder, the flow head, and the hybrid placement (source and mixup
    by images, the one replay sample with the target by rows): losses
    and gradients within 1e-10 relative, parameters within 1e-12,
    replay features, ``sem_conf`` and the panoptic map equal;
  - every rank all-reduces one gradient layout, also where the empty
    rank reaches no output of a live parameter;
  - the float32 split step at 32x64 against the JAX package's
    ``make_adapt_step`` on ``tests/test_torch_adapt.py``'s first batch
    and weights (target and 2 replay frames at 32x64, source and mixup at
    32x96), with that file's tolerances and no control factor: the setup
    in which the one-process port meets them (on the 64x96 batch of
    ``tests/test_torch_spatial.py`` the pose net's train-mode BatchNorm
    puts even one process past them).

Every layer on an empty slab runs its own op on rows of zeros cut to none
(``spatial.on_empty``), so its output has the type autocast gives the
other ranks' rows and autograd links every rank's graph alike; the CPU
checks run without autocast, and ``chip_smoke.py`` phase 14 (h) runs the
bfloat16 step on the card.
"""

import pytest
import torch

import _spatial_worker as worker
import torch_spatial_cases as cases

MODULE_TOL = cases.MODULE_TOL
HALO_GRAD_TOL = 1e-12
PARAM_TOL = cases.PARAM_TOL


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every check's results on each of the 2 ranks, and the JAX steps'
    outputs (one spawn, shared with ``tests/test_torch_spatial.py``)."""
    return cases.spawned(tmp_path_factory)


def _empty(ranks):
    return [result["empty"] for result in ranks["ranks"]]


def test_halo_and_gather_rows_on_empty_slabs(ranks):
    expected = sum(len(cases_) + 1 for _, _, cases_
                   in worker.EMPTY_HALO_SIZES)
    # each level of the pyramid, from 32 rows down to 1
    assert [rows for _, rows, _ in worker.EMPTY_HALO_SIZES] == [
        32, 16, 8, 4, 2, 1]
    for rank, result in enumerate(_empty(ranks)):
        assert len(result["halo"]) == expected
        for name, case in result["halo"].items():
            assert case["out"] == 0.0, (name, case)
            assert case.get("inf_equal", True), name
            assert case["grad"] <= HALO_GRAD_TOL, (name, case)
            if "rows" in case:
                got, expect = case["rows"]
                assert got == expect, (name, case)
                # rank 1's slab is empty, and so is its halo
                assert (got == 0) == (rank == 1), (name, case)


def _module_distances(ranks, prefixes):
    found = 0
    for result in _empty(ranks):
        for name, distances in result["modules"].items():
            if name.startswith(prefixes):
                found += 1
                for key, value in distances.items():
                    assert value <= MODULE_TOL, (name, key, value)
    return found


def test_encoders_on_empty_slabs_match_one_process(ranks):
    # ResNet-18 and -50, eval and train mode
    assert _module_distances(ranks, ("encoder",)) == 2 * 4


def test_heads_resizes_and_warp_on_empty_slabs_match_one_process(ranks):
    assert _module_distances(ranks, ("depth head", "semantic head",
                                     "instance head", "resize",
                                     "warp")) == 2 * (4 + 6)


def test_losses_on_empty_slabs_match_one_process(ranks):
    assert _module_distances(ranks, ("reconstruction", "smoothness",
                                     "semantic loss", "instance loss")) \
        == 2 * 4


ROWS = {"target": "rows", "eval_gt": "rows", "source": "rows",
        "target_replay": "rows", "mixup": "rows"}
HYBRID = dict(ROWS, source="images", mixup="images")


@pytest.mark.parametrize("variant", [v[0] for v in
                                     worker.EMPTY_STEP_VARIANTS])
def test_step_float64_on_empty_slabs_matches_one_process(ranks, variant):
    lead, follower = (r["step"][variant] for r in _empty(ranks))
    # every rank holds the global metrics; rank 0 alone scores the eval
    assert lead["metrics"] == follower["metrics"]
    assert not lead["eval_on_followers"] and follower["eval_on_followers"]
    # 2 source and mixup samples divide over 2 ranks, 1 replay does not
    assert lead["placement"] == HYBRID
    assert lead["loss_rel"] <= MODULE_TOL, lead["loss_rel"]
    live = {"backbone_pose_sflow", "depth_head", "pose_head",
            "semantic_head"}
    if variant in ("live encoder", "flow"):
        live.add("backbone_po_depth")
    if variant == "flow":
        live.add("flow_head")
    assert set(lead["grad_rel_l2"]) == live
    for name, value in lead["grad_rel_l2"].items():
        assert value <= MODULE_TOL, (name, value)
    assert lead["param_diff"] <= PARAM_TOL, lead["param_diff"]
    assert lead["features"] == 0.0
    assert lead["eval_maps"] <= MODULE_TOL
    assert lead["checks"] == 1
    assert lead["sem_conf_equal"] and lead["panoptic_equal"]
    # one gradient all-reduce a step, of one layout on both ranks
    assert len(lead["records"]) == 1
    assert lead["records"][0]["layout"] == \
        follower["records"][0]["layout"]


def test_every_rank_reduces_one_gradient_layout(ranks):
    lead, follower = (r["layout"] for r in _empty(ranks))
    assert lead["records"][0]["layout"] == follower["records"][0]["layout"]
    # the empty rank reached no output of the scale parameter; the unused
    # parameter no rank reached
    assert lead["records"][0]["missing"] == 1
    assert follower["records"][0]["missing"] == 2
    for result in (lead, follower):
        assert max(result["grads"]) <= HALO_GRAD_TOL, result["grads"]
        assert len(result["grads"]) == 3
        assert result["unused_grad"]


def test_step_float32_on_empty_slabs_matches_jax(ranks):
    ours = ranks["ranks"][0]["empty_jax"]
    assert ranks["ranks"][1]["empty_jax"]["metrics"] == ours["metrics"]
    cases.check_against_jax(ours, None, ranks["jax_empty"])
