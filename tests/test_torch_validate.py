"""The port's ``run_validation`` against ``codeps_tpu``'s on the same
bridged weights: the held-out split of the synthetic KITTI-360 tree
(``ReplayBuffer(mode="val")`` over ``sequence_reference_mode="semantic"``,
as the adaptation CLI validates the target) and synthetic Cityscapes val
(the forgetting eval).

ResNet-18 at 32x64, the JAX package in float32; the center head's bias is
raised so that the random heads give centers, and the small-instance area
lowered so that the GT maps of both splits hold thing segments. Both
splits share one JAX compile of the eval step. Cityscapes val is also
validated with losses (``compute_loss=True``), as the pretraining CLI
validates; the losses within 1e-4 relative.

Tolerances: PQ, SQ, RQ (All, Stuff, Things), mIoU and abs_rel within
0.005 (``scripts/parity_e2e.py:52-54``); the other depth means within
1e-3 relative; the confusion matrices equal up to near-tie pixels, at most
0.5% of them, and so the predicted panoptic maps; the GT panoptic maps
equal.
"""

import numpy as np
import pytest
import torch

import jax

import codeps_tpu.tasks.validate as jax_validate
from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.data import Cityscapes as JaxCityscapes
from codeps_tpu.data import DataLoader as JaxDataLoader
from codeps_tpu.data import Kitti360 as JaxKitti360
from codeps_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from codeps_tpu.evaluation.panoptic_metrics import \
    PanopticEvaluator as JaxPanopticEvaluator
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params

from codeps_torch.config import gen_config
from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.kitti_360 import Kitti360
from codeps_torch.data.loader import DataLoader
from codeps_torch.data.replay_buffer import ReplayBuffer
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree)
from codeps_torch.evaluation.panoptic_metrics import PanopticEvaluator
from codeps_torch.io import from_jax
from codeps_torch.models import build_modules
from codeps_torch.tasks.validate import run_validation

NC = 14
PQ_TOL = MIOU_TOL = ABS_REL_TOL = 0.005
DEPTH_REL_TOL = 1e-3
NEAR_TIE_SHARE = 0.005
SPLITS = ("k360_val", "cs_val")
# the split validated with losses, as the pretraining CLI validates
LOSS_SPLIT = "cs_val"
LOSS_REL_TOL = 1e-4


def _configure(cfg, k360_root, cs_root):
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.dataset.name = "kitti_360"
    cfg.dataset.path = str(k360_root)
    cfg.dataset.feed_img_size = [32, 64]
    cfg.dataset.center_heatmap_sigma = 4
    # the synthetic things are small; the KITTI-360 eval labels drop an
    # instance under a tenth of this area (scaled to the feed size)
    cfg.dataset.small_instance_area_full_res = 100
    source = cfg.adapt.source_dataset
    source.name = "cityscapes"
    source.path = str(cs_root)
    source.feed_img_size = [32, 64]
    source.center_heatmap_sigma = 4
    cfg.semantics.class_weights = [1.0] * NC
    cfg.tpu.compute_dtype = "float32"
    cfg.freeze()
    return cfg


def _datasets(side, cfg):
    kitti, city, buffer = ((JaxKitti360, JaxCityscapes, JaxReplayBuffer)
                           if side == "jax" else
                           (Kitti360, Cityscapes, ReplayBuffer))
    target = kitti("sequence", cfg.dataset, return_depth=True,
                   sequences=["03"], sequence_reference_mode="semantic")
    return {"k360_val": buffer(target, cfg.adapt, mode="val"),
            "cs_val": city("val", cfg.adapt.source_dataset,
                           return_depth=True)}


def _recording(evaluator_cls, maps):
    """An ``update`` that appends the (GT, prediction) maps it takes to
    ``maps[-1]``."""
    update = evaluator_cls.update

    def record(self, pan_gt, pan_pred):
        maps[-1].append((np.array(pan_gt), np.array(pan_pred)))
        return update(self, pan_gt, pan_pred)
    return record



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the port: the tier-1 run's workers share
    the cores, and torch's default of a thread a core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_validate")
    k360_root = make_kitti360_tree(tmp / "k360", num_frames=8, width=96,
                                   height=64, semantic_gaps=(6,))
    cs_root = make_cityscapes_tree(tmp / "cs", num_frames=3, width=96,
                                   height=64, split="val", seed=5)
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False), k360_root,
                      cs_root)
    pcfg = _configure(gen_config(adapt=True, freeze=False), k360_root,
                      cs_root)

    modules = jax_build_modules(jcfg, NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), modules, (32, 64))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    params["instance_head"]["center_head"]["conv"]["bias"][:] = 0.12
    pmodules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                      params, stats, pcfg)

    out = {"jax": {}, "port": {}}
    maps = []
    with pytest.MonkeyPatch.context() as mp:
        # one compile of the JAX eval step for both splits (same shapes)
        steps = {}
        make_eval_step = jax_validate.make_eval_step

        def shared_eval_step(modules, cfg, thing_list, ignore_classes=()):
            key = (tuple(thing_list), tuple(ignore_classes))
            if key not in steps:
                steps[key] = make_eval_step(modules, cfg, thing_list,
                                            ignore_classes)
            return steps[key]
        mp.setattr(jax_validate, "make_eval_step", shared_eval_step)
        for cls in (JaxPanopticEvaluator, PanopticEvaluator):
            mp.setattr(cls, "update", _recording(cls, maps))
        for side, cfg in (("jax", jcfg), ("port", pcfg)):
            for split, dataset in _datasets(side, cfg).items():
                maps.append([])
                if side == "jax":
                    loader = JaxDataLoader(dataset, batch_size=2,
                                           offsets=[1], shuffle=False,
                                           num_threads=1, drop_last=False)
                    metrics = jax_validate.run_validation(
                        cfg, modules, params, stats, loader,
                        dataset.thing_classes, dataset.stuff_classes,
                        dataset.ignore_classes, gen_visuals=True,
                        compute_loss=split == LOSS_SPLIT)
                else:
                    loader = DataLoader(dataset, batch_size=2, offsets=[1],
                                        shuffle=False, drop_last=False)
                    metrics = run_validation(
                        cfg, pmodules, loader, dataset.thing_classes,
                        dataset.stuff_classes, dataset.ignore_classes,
                        gen_visuals=True, compute_loss=split == LOSS_SPLIT)
                out[side][split] = (metrics, maps[-1], len(dataset))
    out["port_modules"], out["port_cfg"] = pmodules, pcfg
    return out


@pytest.mark.parametrize("split", SPLITS)
def test_metrics_match(runs, split):
    ref, _, n = runs["jax"][split]
    ours, _, _ = runs["port"][split]
    assert n >= 2
    scalars = {k for k, v in ref.items()
               if k != "visual_panels" and np.ndim(v) == 0}
    assert scalars == {k for k, v in ours.items()
                       if k != "visual_panels" and np.ndim(v) == 0}
    assert {"p_pq", "p_things_rq", "p_stuff_sq", "sem_miou"} <= scalars
    for key in scalars:
        r, o = float(ref[key]), float(ours[key])
        assert np.isfinite(o), key
        if key.startswith(("p_", "sem_miou")) or key == "d_abs_rel":
            tol = PQ_TOL
        else:
            tol = DEPTH_REL_TOL * abs(r)
        assert abs(o - r) <= tol, (split, key, o, r)
    if split == "k360_val":
        assert {"d_abs_rel", "d_rmse", "d_a1"} <= scalars


@pytest.mark.parametrize("split", SPLITS)
def test_confusion_and_panoptic_maps_match(runs, split):
    ref, ref_maps, n = runs["jax"][split]
    ours, maps, _ = runs["port"][split]
    conf_ref, conf = ref["sem_conf"], ours["sem_conf"]
    total = int(conf_ref.sum())
    assert int(conf.sum()) == total > 0
    # a pixel whose argmax flips moves one count between two cells
    assert np.abs(conf - conf_ref).sum() / 2 <= NEAR_TIE_SHARE * total
    assert len(maps) == len(ref_maps) == (n + 1) // 2
    for (gt, pred), (gt_ref, pred_ref) in zip(maps, ref_maps):
        np.testing.assert_array_equal(gt, gt_ref)
        assert ((gt > 0) & (gt % 1000 > 0)).any()      # thing segments
        assert (pred == pred_ref).mean() >= 1 - NEAR_TIE_SHARE


@pytest.mark.parametrize("split", SPLITS)
def test_visual_panels_match(runs, split):
    ref = runs["jax"][split][0]["visual_panels"]
    ours = runs["port"][split][0]["visual_panels"]
    assert set(ours) == set(ref) and ref
    for key, panel in ref.items():
        assert ours[key].shape == panel.shape, key
        assert ours[key].dtype == panel.dtype, key


def test_validation_losses_match(runs):
    """``compute_loss=True``: the unweighted pretraining losses with
    running statistics and their weighted total, averaged over the
    batches. The automask noise differs (a torch generator seeded 0, a
    JAX key 0); at 1e-5 it moves the per-pixel minimum only at near-ties,
    far below the tolerance."""
    ref = runs["jax"][LOSS_SPLIT][0]
    ours = runs["port"][LOSS_SPLIT][0]
    keys = {k for k in ref if k.startswith("val_loss")}
    assert keys == {k for k in ours if k.startswith("val_loss")}
    assert {"val_loss", "val_loss_depth_recon", "val_loss_depth_smth",
            "val_loss_semantic", "val_loss_center",
            "val_loss_offset"} <= keys
    for key in keys:
        r, o = float(ref[key]), float(ours[key])
        assert abs(o - r) <= LOSS_REL_TOL * abs(r), (key, o, r)
    assert not any(k.startswith("val_loss")
                   for k in runs["port"]["k360_val"][0])


def test_validation_needs_eval_mode_and_has_no_losses_yet(runs):
    modules, cfg = runs["port_modules"], runs["port_cfg"]
    # no batch, no loss: compute_loss adds nothing to an empty split
    assert run_validation(cfg, modules, [], (), (), compute_loss=True) == {}
    modules.depth_head.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            run_validation(cfg, modules, [], (), ())
    finally:
        modules.eval()
    assert run_validation(cfg, modules, [], (), ()) == {}
