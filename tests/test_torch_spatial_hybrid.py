"""The hybrid placement of the adaptation step under spatial sharding
(``codeps_torch/parallel/spatial.py``: ``spatial.hybrid()``, the
counterpart of ``codeps_tpu/parallel/spatial.py``'s
``shard_adapt_batch_hybrid``), on the CPU over gloo.

The checks run in the 2-rank spawn that ``tests/test_torch_spatial.py``
reads too (``tests/torch_spatial_cases.py``, one spawn and one JAX
compile for both files):

  - each domain's placement (images or rows) equals the JAX package's on
    meshes of 2, 4 and 8 virtual CPU devices, on batches of 1, 2 and 3
    side samples; a fused mixup of one cut and one class mixup on 2 ranks
    is where the two depart (JAX tests the class mixups' count, the port
    the samples');
  - the float64 hybrid step against one process, both on 2 ranks: the
    published freezing with 2 replay samples (every side domain by images,
    the merged target and replay pass split) and the flow head with a
    live depth encoder and 1 replay sample (the replay by rows); a fused
    cut and class mixup, one each (each rank holds no sample of one
    group); a source and mixup of 32 rows (one block: no row split) by
    images, and, where its 3 samples do not divide, by rows (rank 1's
    slab empty), which steps. Losses and every live module's gradient
    within 1e-10 relative, parameters within 1e-12, replay features,
    ``sem_conf`` and the panoptic map equal;
  - the float32 hybrid step against the JAX step the spawn's test
    process compiled, with ``test_step_float32_matches_jax``'s
    tolerances.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec

from codeps_tpu.parallel import shard_adapt_batch_hybrid

import _spatial_worker as worker
import torch_spatial_cases as cases
from codeps_torch.parallel import spatial


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return cases.spawned(tmp_path_factory)


def _side_batch(count, mixup="composed"):
    """A step batch of 16x4 images with ``count`` source, replay and mixup
    samples: a composed mixup, or the raw materials of a fused one of cut
    mixups ("cut"), or of one cut and one class mixup ("cut+class",
    ``count`` 2)."""
    h, w = 16, 4

    def zeros(*shape, dtype=np.float32):
        return np.zeros(shape, dtype)
    batch = {
        "target": {"frames": zeros(1, 3, h, w, 3), "camera": zeros(1, 4)},
        "source": {"frames": zeros(count, 3, h, w, 3),
                   "camera": zeros(count, 4),
                   "semantic": zeros(count, h, w, dtype=np.int32),
                   "semantic_weights": zeros(count, h, w),
                   "center": zeros(count, h, w, 1),
                   "offset": zeros(count, h, w, 2)},
        "target_replay": {"frames": zeros(count, 3, h, w, 3),
                          "camera": zeros(count, 4)},
        "eval_gt": {"semantic": zeros(1, h, w, dtype=np.int32),
                    "depth_gt": zeros(1, h, w)},
        "do_ema": True}
    if mixup == "composed":
        batch["mixup"] = {"rgb": zeros(count, h, w, 3),
                          "semantic": zeros(count, h, w, dtype=np.int32)}
    else:
        cuts = count if mixup == "cut" else 1
        batch["mixup"] = {
            "rgb_src": zeros(count, h, w, 3),
            "semantic_src": zeros(count, h, w, dtype=np.int32),
            "rgb_tgt": zeros(count, h, w, 3),
            "prewarp": {key: zeros(count, h, w) for key in ("wx", "wy")},
            "cut_cells": zeros(cuts, 2, dtype=np.int32)}
        if mixup == "cut+class":
            batch["mixup"]["class_replace"] = zeros(count - cuts, 256,
                                                    dtype=bool)
    return batch


def _jax_placement(batch, ranks):
    """"images" or "rows" for each domain as the JAX package places it:
    images where every leaf is split along its leading axis, rows where
    every split leaf is split along its height."""
    mesh = Mesh(np.array(jax.devices()[:ranks]), ("data",))
    placed = shard_adapt_batch_hybrid(batch, mesh)
    out = {}
    for key, value in placed.items():
        if not isinstance(value, dict):
            continue
        specs = [tuple(leaf.sharding.spec)
                 for leaf in jax.tree.leaves(value)]
        if all(spec[:1] == ("data",) for spec in specs):
            out[key] = "images"
        else:
            assert not any(spec[:1] == ("data",) for spec in specs), specs
            out[key] = "rows"
    return out


@pytest.mark.parametrize("ranks_", [2, 4, 8])
def test_placement_matches_jax(ranks_):
    for count in (1, 2, 3):
        for mixup in ("composed", "cut"):
            batch = _side_batch(count, mixup)
            ours = spatial.hybrid_placement(batch, ranks_)
            assert ours == _jax_placement(batch, ranks_), (count, mixup)
            assert ours["target"] == ours["eval_gt"] == "rows"
            side = "images" if count % ranks_ == 0 else "rows"
            assert {ours[k] for k in spatial.SIDE_DOMAINS} == {side}
    # JAX tests the first leaf in sorted key order, here class_replace's
    # one row; the port the mixup's 2 samples
    batch = _side_batch(2, "cut+class")
    ours, theirs = spatial.hybrid_placement(batch, 2), _jax_placement(
        batch, 2)
    assert ours.pop("mixup") == "images" and theirs.pop("mixup") == "rows"
    assert ours == theirs


def _check_against_one_process(ranks, name, placement):
    lead, follower = (r["hybrid"][name] for r in ranks["ranks"])
    assert lead["placement"] == follower["placement"] == placement
    # every rank holds the global metrics; rank 0 alone scores the eval
    assert lead["metrics"] == follower["metrics"]
    assert not lead["eval_on_followers"] and follower["eval_on_followers"]
    assert lead["loss_rel"] <= cases.MODULE_TOL, lead["loss_rel"]
    assert set(lead["grad_rel_l2"]) >= {"backbone_pose_sflow", "depth_head",
                                        "pose_head", "semantic_head"}
    for module, value in lead["grad_rel_l2"].items():
        assert value <= cases.MODULE_TOL, (module, value)
    assert lead["param_diff"] <= cases.PARAM_TOL, lead["param_diff"]
    assert lead["features"] == 0.0
    assert lead["eval_maps"] <= cases.MODULE_TOL
    assert lead["checks"] == 1
    assert lead["sem_conf_equal"] and lead["panoptic_equal"]
    return lead


SIDE_BY_IMAGES = {"target": "rows", "eval_gt": "rows", "source": "images",
                  "target_replay": "images", "mixup": "images"}
REPLAY_BY_ROWS = dict(SIDE_BY_IMAGES, target_replay="rows")


@pytest.mark.parametrize("name,placement", [
    ("published", SIDE_BY_IMAGES), ("flow", REPLAY_BY_ROWS)])
def test_hybrid_step_float64_matches_one_process(ranks, name, placement):
    lead = _check_against_one_process(ranks, name, placement)
    if name == "flow":
        assert {"backbone_po_depth", "flow_head"} <= set(lead["grad_rel_l2"])


def test_rank_without_a_group_sample_matches_one_process(ranks):
    lead = _check_against_one_process(ranks, "mixup groups", REPLAY_BY_ROWS)
    assert {"semantic_cut_mixup", "semantic_class_mixup"} <= set(
        lead["metrics"])


def test_image_split_domain_takes_any_height(ranks):
    # 32 rows, one block: by images it steps; by rows (3 samples) it steps
    # too, rank 1's slab empty
    _check_against_one_process(ranks, "any height", REPLAY_BY_ROWS)
    for result in ranks["ranks"]:
        assert result["hybrid"]["raise"] == "no error"


def test_hybrid_step_float32_matches_jax(ranks):
    ours = ranks["ranks"][0]["jax_hybrid"]
    assert ranks["ranks"][1]["jax_hybrid"]["metrics"] == ours["metrics"]
    cases.check_against_jax(ours, ranks["ranks"][0]["jax"]["one_process"],
                            ranks["jax"])


def test_hybrid_without_a_group_changes_nothing():
    """Outside a process group ``spatial.hybrid()`` is inactive: the step
    inside it computes bit for bit what it computes outside."""
    cfg = worker.step_config()
    batch = worker.step_batch(61, np.uint8, fused=True)
    runs = []
    for split in (False, True):
        modules, step = worker.build_step(cfg, fused=True)
        if split:
            with spatial.hybrid():
                assert not spatial.active()
                assert not spatial.hybrid_active()
                runs.append(worker.run_steps(modules, step, [batch]))
        else:
            runs.append(worker.run_steps(modules, step, [batch]))
    (plain, _), (hybrid, _) = runs
    assert plain[0]["metrics"] == hybrid[0]["metrics"]
    for name, grads in plain[0]["grads"].items():
        for key, grad in grads.items():
            assert torch.equal(hybrid[0]["grads"][name][key], grad), key
    assert torch.equal(plain[0]["results"]["panoptic"],
                       hybrid[0]["results"]["panoptic"])
