"""The online-adaptation stream.

Counterpart of ``codeps_tpu/tasks/adapt_loop.py:46-795``. For each frame
of the replay buffer's target stream:

  1. the replay buffer assembles the frame's sample (target, source and
     target replay, mixup raw materials) one frame ahead, in a worker
     thread;
  2. the mixup samples: when every strategy is ``cut_mixup`` or
     ``class_mixup`` the adaptation step composes them itself (the fused
     path); otherwise (``conf_instance_mixup``) the host composes them
     (``_compose_mixups``): one pseudo-label call on the teacher
     (``tasks/mixup_prep.py``: panoptic fusion with the grouping kernel and
     the camera warp for the whole stack), the readback, then numpy
     composition per item (``data/mixup.py``), whose instance paste
     re-fuses the warped map at ``conf_thresh`` on the device;
  3. the adaptation step (``tasks/adapt.py``) evaluates the teacher on
     the frame (panoptic fusion with the grouping kernel) and updates the
     student and the teacher; at ``nof_adaptation_steps`` > 1 only the
     first step evaluates, the losses are averaged over the steps and the
     EMA blend happens on the last;
  4. the GT panoptic map of the frame is fused on the device (the
     grouping kernel's second launch of the frame);
  5. the meters (losses, depth, per-class depth, confusion matrix, mIoU,
     PQ) take the previous frame's results, in frame order;
  6. the previous frame joins the diversity buffer (the add is deferred
     by one frame).

The orderings that decide the numbers are the JAX runner's: one frame of
prefetch and the deferred add, so frame it+1 is sampled after the add of
frame it-2 and before that of frame it-1; ``mixup_rng`` draws the cut
cells and class tables in canonical strategy order (during batch assembly
on the fused path, inside ``Mixup`` on the host path). Where the JAX runner
starts asynchronous device-to-host copies, this one makes non-blocking
copies right after a frame's work is queued and waits on an event for
them once the next frame's work is queued, so the host reads the meters
while the card runs the next frame.

Without the camera warp (``geom_augment: false``) the host path labels the
stack with ``make_plabel_step`` and composes each item with
``Mixup.do_mixup``, as the JAX runner does.

Spatial sharding (``cfg.tpu.spatial_shard`` in a process group of N > 1
ranks, ``parallel/spatial.py``) splits each frame's step by image rows
over the ranks. Rank 0 alone runs the host pipeline above, as the JAX
runner's single process does; before each step (and each eval of the
eval-only mode) it broadcasts the assembled batch, and every rank runs
the step on its rows. The other ranks follow (``run`` calls ``follow``,
their loop of receive and step) until rank 0's stop message. The host mixup path's
pseudo-labels run on rank 0 alone, whole, as the JAX runner leaves that
call unplaced.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from codeps_torch import parallel
from codeps_torch.data.mixup import Mixup
from codeps_torch.evaluation import (AverageMeter, ConfusionMatrixMeter,
                                     ConstantMeter, PanopticEvaluator,
                                     compute_sem_miou)
from codeps_torch.parallel import spatial
from codeps_torch.tasks.adapt import (batch_to_device, build_eval_forward,
                                      make_adapt_step, make_eval_step,
                                      make_gt_panoptic_step,
                                      make_plabel_step)
from codeps_torch.tasks.mixup_prep import c2c_prewarp, make_plabel_prep_step
from codeps_torch.tasks.state import AdaptState, make_adapt_state

MIXUP_KEYS = ("cut_mixup", "class_mixup", "conf_instance_mixup")


def frames_from_sample(sample, offsets=(1,)) -> np.ndarray:
    """rgb {0, -1, 1, ...} -> (1, F, H, W, 3) in the order [t, t-1, t+1,
    ...]; uint8 frames stay uint8, others become float32."""
    order = [0]
    for offset in offsets:
        order += [-offset, offset]
    stacked = np.stack([np.asarray(sample["rgb"][o]) for o in order])
    if stacked.dtype != np.uint8:
        stacked = stacked.astype(np.float32)
    return stacked[None]


def adapt_module_lists(cfg, names: Sequence[str]):
    """(frozen, EMA-filtered) module names from the adapt flags, as
    ``scripts/adapt.py:123-145`` derives them."""
    flags = cfg.adapt.model
    frozen = [name for name, live in (
        ("backbone_po_depth", flags.backbone_po_depth),
        ("backbone_pose_sflow", flags.backbone_pose_sflow),
        ("depth_head", flags.depth), ("pose_head", flags.pose),
        ("flow_head", flags.sflow), ("semantic_head", flags.semantic),
        ("instance_head", flags.instance)) if not live and name in names]
    ema = []
    if cfg.adapt.ema.semantic and flags.semantic:
        ema.append("semantic_head")
    if cfg.adapt.ema.instance and flags.instance:
        ema.append("instance_head")
    return tuple(frozen), tuple(m for m in ema if m in names)


def _host(tree):
    """Non-blocking copies to the host of every tensor in ``tree``."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", non_blocking=True)
    return tree


def _queue_host(tree, device):
    """(the host copies of ``tree``, the event to wait on before reading
    them; None on the CPU)."""
    host = _host(tree)
    if device.type != "cuda":
        return host, None
    event = torch.cuda.Event()
    event.record()
    return host, event


def _phase_clock(phases: Dict[str, List[float]], start: float):
    """``mark(name)`` appends the seconds since the last mark (or
    ``start``) to ``phases[name]``."""
    last = [start]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phases.setdefault(name, []).append(now - last[0])
        last[0] = now
    return mark


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


class AdaptationRunner:
    """Streams the adaptation split of ``replay_buffer`` through the
    adaptation step on ``device`` (``cuda`` unless given).

    ``modules`` become the student of a fresh ``AdaptState`` (frozen and
    EMA-filtered modules from the config's adapt flags; ``seed`` seeds the
    automask noise). ``noise``, a callable ``shape ->
    tensor``, replaces that generator in every step (the hook the parity
    tests use to inject the JAX package's draws). ``wandb_logger`` (an
    enabled ``io/logging.WandbLogger``) takes the meters, the per-class
    depth series and panels of the latest teacher eval every
    ``logging.log_step_interval`` frames.
    """

    def __init__(self, cfg, modules, replay_buffer, seed: int = 0,
                 device=None, verbose: bool = True, noise=None,
                 wandb_logger=None):
        # spatial sharding: rank 0 leads, the other ranks follow
        self.row_split = bool(cfg.tpu.spatial_shard) \
            and parallel.world_size() > 1
        if self.row_split and modules.flow_head is not None:
            raise NotImplementedError(
                "spatial sharding (tpu.spatial_shard) over several ranks "
                "does not run the flow head (model.make_sflow) yet")
        # host seconds of each broadcast of a batch, and (on the ranks that
        # follow) of each step
        self.row_times: Dict[str, List[float]] = {"broadcast": [],
                                                  "step": []}
        self.cfg = cfg
        self.buffer = replay_buffer
        self.verbose = verbose
        self.noise = noise
        self.wandb_logger = wandb_logger
        self.offsets = tuple(cfg.dataset.offsets)

        dataset = replay_buffer.target_data
        self.thing_list = tuple(dataset.thing_classes)
        self.stuff_list = tuple(dataset.stuff_classes)
        self.ignore_classes = tuple(dataset.ignore_classes)
        self.num_classes = dataset.num_classes

        frozen, ema = adapt_module_lists(cfg, modules.module_names())
        if cfg.adapt.mode == "off":
            ema = ()
        elif cfg.adapt.ema.depth:
            raise NotImplementedError(
                "the consistency loss for depth is not implemented (as in "
                "the reference)")
        # float64 modules (the exactness mode) stream float64 batches
        self.float_dtype = (torch.float64 if next(modules.parameters())
                            .dtype == torch.float64 else None)
        self.state: AdaptState = make_adapt_state(
            modules, cfg.train.optimizer.learning_rate, ema_modules=ema,
            frozen_modules=frozen, ema_alpha=cfg.adapt.ema.alpha, seed=seed,
            device=device)
        self.device = self.state.device

        class_weights = [w for i, w in enumerate(cfg.semantics.class_weights)
                         if i not in cfg.dataset.remove_classes]
        do_class_wise = cfg.model.make_depth and cfg.model.make_semantic
        self.eval_step = make_eval_step(cfg, self.thing_list,
                                        self.num_classes,
                                        self.ignore_classes,
                                        class_wise_depth_stats=do_class_wise)
        self.gt_panoptic = make_gt_panoptic_step(self.thing_list,
                                                 self.num_classes)

        self.mixup_active = cfg.adapt.mixup.general.active
        num_mixup = (cfg.adapt.mixup.general.nof_samples
                     if self.mixup_active else 0)
        strategies = list(cfg.adapt.mixup.general.mixup_strategies)
        # one sub-batch per strategy, in canonical order; each gets one
        # pooled CE (the reference's per-key loss)
        mixup_groups = tuple(
            (name, strategies.count(name)) for name in MIXUP_KEYS
            if name in strategies) if num_mixup else ()
        # the step composes cut and class mixup itself; conf_instance_mixup
        # (the sequential instance paste) composes on the host
        self.fused_mixup = num_mixup > 0 and all(
            s in ("cut_mixup", "class_mixup") for s in strategies)
        self.disable_adaptation = cfg.adapt.mode == "off"
        self._norm_mean = tuple(cfg.dataset.normalization.rgb_mean)
        self._norm_std = tuple(cfg.dataset.normalization.rgb_std)
        self.plabel_step = make_plabel_step(self._norm_mean, self._norm_std)
        self.plabel_prep = make_plabel_prep_step(
            self.thing_list, self.num_classes, self._norm_mean,
            self._norm_std)
        self._mixup_src_size = tuple(cfg.adapt.source_dataset.feed_img_size)
        if (num_mixup and "cut_mixup" in strategies
                and not cfg.adapt.mixup.general.geom_augment
                and tuple(cfg.dataset.feed_img_size) != self._mixup_src_size):
            raise ValueError(
                "cut_mixup with geom_augment=false requires equal "
                f"target/source feed sizes, got "
                f"{tuple(cfg.dataset.feed_img_size)} vs "
                f"{self._mixup_src_size}")
        self._prewarp_cache: Dict[Any, Any] = {}

        eval_forward = build_eval_forward(
            cfg, self.thing_list, self.num_classes, self.ignore_classes,
            class_wise_depth_stats=do_class_wise)
        common = dict(cfg=cfg, class_weights=class_weights,
                      num_mixup=num_mixup, mixup_groups=mixup_groups,
                      fused_mixup=self.fused_mixup,
                      sem_ignore_classes=list(self.ignore_classes) or None)
        # steps after the first of a frame do not evaluate the teacher
        self.steps = {(replay, evaluate): make_adapt_step(
            has_replay=replay,
            eval_forward=eval_forward if evaluate else None, **common)
            for replay in (True, False) for evaluate in (True, False)}
        self.adaptation_steps = (0 if self.disable_adaptation
                                 else cfg.train.nof_adaptation_steps)

        self.panoptic_eval = PanopticEvaluator(list(self.stuff_list),
                                               list(self.thing_list))
        self.meters = self._make_meters()
        self.mixup_rng = np.random.default_rng(cfg.adapt.replay_sampler.seed)
        self.step_times: List[float] = []
        # host seconds of each buffer.__getitem__ (worker thread) and add
        self.host_times: Dict[str, List[float]] = {"getitem": [], "add": []}
        # host seconds of each part of an adapted frame on the main thread
        # (the previous frame's meters wait for its device work)
        self.frame_phases: Dict[str, List[float]] = {}
        # on the host mixup path with the camera warp: host seconds of its
        # parts (prep, readback, then each strategy's composition) and the
        # instances each conf_instance_mixup item pasted
        self.mixup_phases: Dict[str, List[float]] = {}
        self.pasted_instances: List[int] = []

    # ------------------------------------------------------------------

    def _make_meters(self):
        loss_names = ["loss", "depth_recon", "depth_smth", "flow_smth",
                      "flow_sparsity", "semantic_source",
                      "semantic_cut_mixup", "semantic_class_mixup",
                      "semantic_conf_instance_mixup",
                      "center_source", "offset_source", "thing_mask_source"]
        metric_names = ["d_abs_rel", "d_a1", "d_a2", "d_a3", "d_rmse",
                        "d_rmse_log", "d_sq_rel"]
        if self.cfg.model.make_depth and self.cfg.model.make_semantic:
            for i in range(self.num_classes):
                metric_names += [f"d_abs_rel_c{i}", f"d_a1_c{i}",
                                 f"d_a2_c{i}", f"d_a3_c{i}", f"d_rmse_c{i}",
                                 f"d_rmse_log_c{i}", f"d_sq_rel_c{i}"]
        meters = {
            "losses": {name: AverageMeter(()) for name in loss_names},
            "metrics": {name: AverageMeter(()) for name in metric_names},
        }
        meters["metrics"]["sem_conf"] = ConfusionMatrixMeter(
            self.num_classes)
        meters["metrics"]["sem_conf_interval"] = ConfusionMatrixMeter(
            self.num_classes)
        for name in ("sem_miou", "sem_miou_pixels", "sem_miou_interval",
                     "sem_miou_pixels_interval", "p_pq", "p_sq", "p_rq"):
            meters["metrics"][name] = ConstantMeter(())
        return meters

    # ------------------------------------------------------------------

    def _target_gt(self, target) -> Dict[str, np.ndarray]:
        gt: Dict[str, np.ndarray] = {}
        if "semantic" in target:
            gt["semantic"] = np.asarray(target["semantic"], np.int32)[None]
            if "semantic_eval" in target:
                gt["semantic_eval"] = np.asarray(target["semantic_eval"],
                                                 np.int32)[None]
        if "depth" in target:
            gt["depth_gt"] = np.asarray(target["depth"], np.float32)[None]
        return gt

    def _adapt_batch(self, sample, mixup_samples=()) -> Dict[str, Any]:
        def stack_domain(items, keys):
            domain = {
                "frames": np.concatenate([frames_from_sample(item,
                                                             self.offsets)
                                          for item in items]),
                "camera": np.stack([np.asarray(item["camera_model"],
                                               np.float32)
                                    for item in items])}
            for key, dtype in keys:
                if key in items[0]:
                    domain[key] = np.stack(
                        [np.asarray(item[key]) for item in items]).astype(
                            dtype)
            return domain

        target = sample["target"]
        batch: Dict[str, Any] = {
            "target": {
                "frames": frames_from_sample(target, self.offsets),
                "camera": np.asarray(target["camera_model"],
                                     np.float32)[None]},
            "source": stack_domain(sample["source"], [
                ("semantic", np.int32), ("semantic_weights", np.float32),
                ("center", np.float32), ("offset", np.float32),
                ("thing_mask", np.int32)]),
        }
        if "target_replay" in sample:
            batch["target_replay"] = stack_domain(sample["target_replay"],
                                                  [])

        def stack_images(images):
            stacked = np.stack([np.asarray(im) for im in images])
            return (stacked if stacked.dtype == np.uint8
                    else stacked.astype(np.float32))

        fused_items = [(key, item) for key in ("cut_mixup", "class_mixup")
                       for item in sample.get(key, [])]
        if self.fused_mixup and fused_items:
            # the mask materials, drawn in canonical strategy order from
            # the runner's generator
            items = [item for _, item in fused_items]
            cut_cfg = self.cfg.adapt.mixup.cut_mix
            nof_splits = cut_cfg.nof_vert_splits * cut_cfg.nof_hor_splits
            cut_cells, class_replace = [], []
            for key, item in fused_items:
                if key == "cut_mixup":
                    cut_cells.append(self.mixup_rng.choice(
                        nof_splits, cut_cfg.nof_segments, replace=False))
                else:
                    # a random half (rounded up) of the classes in the
                    # source labels comes from the target
                    all_classes = np.unique(np.asarray(item["semantic_src"]))
                    num = all_classes.shape[0]
                    chosen = all_classes[self.mixup_rng.choice(
                        num, (num + num % 2) // 2, replace=False)]
                    table = np.zeros((256,), bool)
                    table[chosen] = True
                    class_replace.append(table)
            mixup = {
                "rgb_src": stack_images([m["rgb_src"][0] for m in items]),
                "semantic_src": np.stack(
                    [np.asarray(m["semantic_src"]) for m in items]).astype(
                        np.int32),
                "rgb_tgt": stack_images([m["rgb_tgt"][0] for m in items]),
            }
            if self.cfg.adapt.mixup.general.geom_augment:
                mixup["prewarp"] = self._c2c_prewarp_cached(
                    np.stack([np.asarray(m["camera_model_tgt"], np.float32)
                              for m in items]),
                    np.stack([np.asarray(m["camera_model_src"], np.float32)
                              for m in items]),
                    np.asarray(items[0]["rgb_tgt"][0]).shape[:2])
            if cut_cells:
                mixup["cut_cells"] = np.stack(cut_cells).astype(np.int32)
            if class_replace:
                mixup["class_replace"] = np.stack(class_replace)
            batch["mixup"] = mixup
        elif mixup_samples:
            # composed on the host, in canonical strategy order; no loss
            # reads their center/offset
            batch["mixup"] = {
                "rgb": np.stack([np.asarray(m["rgb"][0], np.float32)
                                 for m in mixup_samples]),
                "semantic": np.stack([np.asarray(m["semantic"], np.int32)
                                      for m in mixup_samples])}
        return batch

    def _host_normalize(self, img) -> np.ndarray:
        """The host's twin of ``maybe_normalize``: the composed images are
        float, which the step takes as normalized, so uint8 frames are
        normalized here before they are mixed with the teacher's
        normalized warps."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            return img.astype(np.float32)
        mean = np.asarray(self._norm_mean, np.float32)
        std = np.asarray(self._norm_std, np.float32)
        return (img.astype(np.float32) / 255.0 - mean) / std

    def _compose_mixups(self, sample) -> List[Dict[str, Any]]:
        """The frame's mixup samples on the host path
        (``adapt_loop.py:407-474``): one pseudo-label call on the teacher
        for the whole stack (fusion and warp on the device), the readback,
        then numpy composition per item in canonical strategy order."""
        items = [(key, item) for key in MIXUP_KEYS
                 for item in sample.get(key, [])]
        if not items:
            return []
        cfg_mixup = self.cfg.adapt.mixup
        if not cfg_mixup.general.geom_augment:
            return self._compose_mixups_unfused(items)

        mark = _phase_clock(self.mixup_phases, time.perf_counter())
        rgb_tgt = np.stack([np.asarray(item["rgb_tgt"][0])
                            for _, item in items])
        if rgb_tgt.dtype != np.uint8:
            rgb_tgt = rgb_tgt.astype(np.float32)
        intr_src = np.stack([np.asarray(item["camera_model_src"], np.float32)
                             for _, item in items])
        intr_tgt = np.stack([np.asarray(item["camera_model_tgt"], np.float32)
                             for _, item in items])
        warped = self.plabel_prep(
            self.state.teacher, self._to_device(rgb_tgt),
            self._c2c_prewarp_cached(intr_tgt, intr_src, rgb_tgt.shape[1:3]))
        mark("prep")
        rgb_w, sem_w, inst_w = (t.cpu().numpy() for t in warped)
        mark("readback")

        composed = []
        for i, (strategy, item) in enumerate(items):
            # rgb_w is normalized; the source frame must match its scale
            img_src = self._host_normalize(item["rgb_src"][0])
            semantic_src = np.asarray(item["semantic_src"])
            instance_src = np.asarray(item["instance_src"])
            if strategy == "cut_mixup":
                rgb, semantic, instance = Mixup.cut_mixup(
                    self.mixup_rng, img_src, rgb_w[i], instance_src,
                    semantic_src, sem_w[i], inst_w[i],
                    cfg_mixup.cut_mix.nof_vert_splits,
                    cfg_mixup.cut_mix.nof_hor_splits,
                    cfg_mixup.cut_mix.nof_segments)
            elif strategy == "class_mixup":
                rgb, semantic, instance = Mixup.class_mixup(
                    self.mixup_rng, img_src, rgb_w[i], instance_src,
                    semantic_src, sem_w[i], inst_w[i])
            else:
                stats: Dict[str, int] = {}
                rgb, semantic, instance = Mixup.conf_instance_mixup(
                    img_src, rgb_w[i], instance_src, semantic_src,
                    sem_w[i], inst_w[i],
                    cfg_mixup.conf_instance_mix.min_inst_size,
                    thing_list=self.thing_list,
                    num_classes=self.num_classes,
                    conf_thresh=cfg_mixup.conf_instance_mix.conf_thresh,
                    device=self.device, stats=stats)
                self.pasted_instances.append(stats["pasted"])
            composed.append({"rgb": {0: rgb},
                             "camera_model": item["camera_model_src"],
                             "semantic": semantic, "instance": instance,
                             "strategy": strategy})
            mark(strategy)
        return composed

    def _compose_mixups_unfused(self, items) -> List[Dict[str, Any]]:
        """The host path without the camera warp
        (``adapt_loop.py:476-508``): the teacher's predictions for the
        stack, then ``Mixup.do_mixup`` per item. The frames are normalized
        on the host once, so the teacher and the composition see the same
        floats."""
        rgb_tgt = np.stack([self._host_normalize(item["rgb_tgt"][0])
                            for _, item in items])
        sem, center, offset = (t.cpu().numpy() for t in self.plabel_step(
            self.state.teacher, self._to_device(rgb_tgt)))
        composed = []
        for i, (strategy, item) in enumerate(items):
            data = dict(item)
            data["rgb_tgt"] = {0: rgb_tgt[i]}
            data["rgb_src"] = {0: self._host_normalize(item["rgb_src"][0])}
            data["semantic_pred_tgt_ema"] = sem[i]
            data["center_pred_tgt_ema"] = center[i]
            data["offset_pred_tgt_ema"] = offset[i]
            out = Mixup.do_mixup(strategy, data, self.thing_list,
                                 self.cfg.adapt.mixup, rng=self.mixup_rng,
                                 num_classes=self.num_classes,
                                 get_off_cen=False, device=self.device)
            out["strategy"] = strategy
            composed.append(out)
        return composed

    def _c2c_prewarp_cached(self, intr_sampled, intr_out, sampled_size):
        """The warp's taps on the device, cached by the camera pair: a
        stream keeps its cameras, so the float64 host work and its upload
        happen once."""
        key = (intr_sampled.tobytes(), intr_out.tobytes(),
               tuple(sampled_size))
        pre = self._prewarp_cache.get(key)
        if pre is None:
            pre = batch_to_device(c2c_prewarp(
                intr_sampled, intr_out, tuple(sampled_size),
                self._mixup_src_size), self.device)
            if len(self._prewarp_cache) >= 8:
                self._prewarp_cache.clear()
            self._prewarp_cache[key] = pre
        return pre

    def _gt_panoptic(self, sample, eval_gt, results):
        """The frame's GT panoptic map, queued on the device; the GT
        offsets go up as (2, H, W) planes and the grouping kernel reads
        their NHWC view in place."""
        if results is None or "panoptic" not in results \
                or "semantic" not in eval_gt:
            return None
        target = sample["target"]
        center = torch.from_numpy(np.asarray(
            target["center"], np.float32)[None]).to(self.device)
        planes = np.ascontiguousarray(
            np.asarray(target["offset"], np.float32).transpose(2, 0, 1))
        offset = torch.from_numpy(planes[None]).to(self.device) \
            .permute(0, 2, 3, 1)
        return self.gt_panoptic(eval_gt.get("semantic_eval",
                                            eval_gt["semantic"]),
                                center, offset)

    def _update_metrics(self, stats, results, pan_gt) -> None:
        metrics = self.meters["metrics"]
        for name, value in stats.items():
            if name in metrics and name != "sem_conf":
                value = np.asarray(value)
                if np.isnan(value).any():
                    continue  # class absent in this frame
                metrics[name].update(value)
        if "sem_conf" in stats:
            conf = np.asarray(stats["sem_conf"])
            metrics["sem_conf"].update(conf)
            metrics["sem_conf_interval"].update(conf)
            keep = [i for i in range(self.num_classes)
                    if i not in self.ignore_classes]
            for prefix, meter_name in (("", "sem_conf"),
                                       ("_interval", "sem_conf_interval")):
                mat = metrics[meter_name].sum
                per_class = compute_sem_miou(mat, self.num_classes,
                                             self.ignore_classes)
                has_gt = np.asarray(mat)[keep][:, keep].sum(axis=1) != 0
                miou = per_class[has_gt].mean() if has_gt.any() else 0.0
                metrics[f"sem_miou{prefix}"].update(miou)
                metrics[f"sem_miou_pixels{prefix}"].update(
                    compute_sem_miou(mat, self.num_classes,
                                     self.ignore_classes, sum_pixels=True))
        if pan_gt is not None:
            self.panoptic_eval.update(pan_gt, results["panoptic"])
            scores = self.panoptic_eval.evaluate()
            metrics["p_pq"].update(scores["All"]["pq"])
            metrics["p_sq"].update(scores["All"]["sq"])
            metrics["p_rq"].update(scores["All"]["rq"])

    # ------------------------------------------------------------------

    def _logs_to_wandb(self) -> bool:
        return bool(getattr(self.wandb_logger, "enabled", False))

    def _log_wandb_interval(self, step: int, sample, results) -> None:
        """The stream's scalars, the per-class depth series and the panels
        of the latest teacher eval (``adapt_loop.py:584``, the reference's
        ``adapt_codeps.py:311-337``)."""
        if not self._logs_to_wandb():
            return
        logger = self.wandb_logger
        remove_classes = tuple(self.cfg.dataset.remove_classes)
        label_mode = self.cfg.dataset.label_mode
        scalar_metrics = {name: float(m.value) for name, m in
                          self.meters["metrics"].items()
                          if np.ndim(m.value) == 0}
        logger.log_scalars(
            "adapt", losses={name: float(m.value) for name, m in
                             self.meters["losses"].items()},
            metrics=scalar_metrics, step=step)
        logger.log_depth_per_class(scalar_metrics, remove_classes,
                                   label_mode, step=step)
        if results:
            from codeps_torch.io.visualizations import (
                gen_visualizations, plot_confusion_matrix)
            norm = self.cfg.dataset.normalization
            mean = norm.rgb_mean if norm.active else (0.0, 0.0, 0.0)
            std = norm.rgb_std if norm.active else (1.0, 1.0, 1.0)
            panels = gen_visualizations(
                {"frames": frames_from_sample(sample["target"],
                                              self.offsets)},
                results, mean, std, remove_classes=remove_classes,
                label_mode=label_mode)
            conf = self.meters["metrics"]["sem_conf"].sum
            if np.asarray(conf).sum() > 0:
                panels["conf_mat"] = plot_confusion_matrix(
                    np.asarray(conf), remove_classes, label_mode)
            logger.log_images("adapt/batch", panels, step=step)

    def _host_results(self, it: int, log_interval: int, results):
        """What of the teacher eval's results goes to the host: the
        panoptic map, and on a frame whose panels are logged every map
        but the soft semantics."""
        if self._logs_to_wandb() and (it + 1) % log_interval == 0:
            return {k: v for k, v in results.items()
                    if v is not None and k != "semantic_soft"}
        return {"panoptic": results["panoptic"]}

    def _to_device(self, tree):
        return batch_to_device(tree, self.device, self.float_dtype)

    def _broadcast(self, message: Optional[Dict[str, Any]]):
        t0 = time.perf_counter()
        message = spatial.broadcast_message(message, self.device)
        self.row_times["broadcast"].append(time.perf_counter() - t0)
        return message

    def _call_step(self, replay: bool, evaluate: bool, batch):
        """One adaptation step; in a row split, broadcast first (the eval
        GT stays on rank 0, which alone scores)."""
        if not self.row_split:
            return self.steps[(replay, evaluate)](self.state, batch,
                                                  noise=self.noise)
        self._broadcast({"op": "step", "replay": replay,
                         "evaluate": evaluate,
                         "batch": {k: v for k, v in batch.items()
                                   if k != "eval_gt"}})
        with spatial.rows():
            return self.steps[(replay, evaluate)](self.state, batch,
                                                  noise=self.noise)

    def _call_eval(self, batch):
        """The eval-only mode's teacher eval; in a row split, broadcast
        first."""
        if not self.row_split:
            return self.eval_step(self.state.teacher, batch)
        self._broadcast({"op": "eval", "batch": {
            "frames": batch["frames"]}})
        with spatial.rows():
            return self.eval_step(self.state.teacher, batch)

    def follow(self) -> Dict[str, Any]:
        """A rank other than 0 of a row split: receive rank 0's batches
        and run each step (or eval) on this rank's rows, until rank 0's
        stop message. Returns the (empty) meters."""
        while True:
            message = self._broadcast(None)
            if message["op"] == "stop":
                return self.meters
            t0 = time.perf_counter()
            with spatial.rows():
                if message["op"] == "step":
                    self.steps[(message["replay"], message["evaluate"])](
                        self.state, message["batch"], noise=self.noise)
                else:
                    self.eval_step(self.state.teacher, message["batch"])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.row_times["step"].append(time.perf_counter() - t0)

    def _timed_getitem(self, index: int):
        t0 = time.perf_counter()
        sample = self.buffer[index]
        self.host_times["getitem"].append(time.perf_counter() - t0)
        return sample

    def run(self, max_frames: Optional[int] = None,
            log_interval: Optional[int] = None,
            on_frame: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        """Stream the adaptation split; returns the meters. ``on_frame(it)``
        is called as the host's work on frame ``it`` ends (a profiler's
        ``step``, for one). In a row split rank 0 streams and the other
        ranks ``follow``."""
        if self.row_split and not parallel.is_lead():
            return self.follow()
        try:
            return self._run(max_frames, log_interval, on_frame)
        finally:
            if self.row_split:
                self._broadcast({"op": "stop"})

    def _run(self, max_frames, log_interval, on_frame):
        log_interval = log_interval or self.cfg.logging.log_step_interval
        num_frames = len(self.buffer)
        if max_frames is not None:
            num_frames = min(num_frames, max_frames)

        executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        pending = executor.submit(self._timed_getitem, 0)
        pending_add = None
        pending_frame: Optional[Dict[str, Any]] = None

        def consume(ctx) -> None:
            if ctx["event"] is not None:
                ctx["event"].synchronize()
            host = _numpy(ctx["host"])
            self._update_metrics(host["stats"], host["results"],
                                 host.get("pan_gt"))
            accum, nsteps = host.get("accum"), ctx["nsteps"]
            if accum is not None:
                for name, value in accum.items():
                    if name in self.meters["losses"]:
                        self.meters["losses"][name].update(value / nsteps)
                self.meters["losses"]["loss"].update(
                    accum["loss_total"] / nsteps)
            done = ctx["it"] + 1
            if done % log_interval == 0:
                if self.verbose:
                    recent = self.step_times[-log_interval:]
                    metrics = self.meters["metrics"]
                    print(f"adapt {done}/{num_frames}: miou "
                          f"{float(metrics['sem_miou'].value):.4f} pq "
                          f"{float(metrics['p_pq'].value):.4f} loss "
                          f"{float(self.meters['losses']['loss'].value):.4f}"
                          f" ({np.mean(recent) if recent else 0.0:.3f} s a "
                          "frame)", flush=True)
                self._log_wandb_interval(done, ctx["sample"],
                                         host["results"])
                self.meters["metrics"]["sem_conf_interval"] = \
                    ConfusionMatrixMeter(self.num_classes)

        def add(index, features) -> None:
            t0 = time.perf_counter()
            self.buffer.add(index, features.numpy())
            self.host_times["add"].append(time.perf_counter() - t0)

        try:
            for it in range(num_frames):
                sample = pending.result()
                if it + 1 < num_frames:
                    pending = executor.submit(self._timed_getitem, it + 1)
                if "target" not in sample:
                    continue
                start = time.perf_counter()
                eval_gt = self._to_device(self._target_gt(sample["target"]))
                if self.disable_adaptation:
                    eval_batch = dict(eval_gt, frames=self._to_device(
                        frames_from_sample(sample["target"], self.offsets)))
                    results, stats = self._call_eval(eval_batch)
                    pan_gt = self._gt_panoptic(sample, eval_gt, results)
                    host, event = _queue_host(
                        {"stats": stats, "pan_gt": pan_gt,
                         "results": self._host_results(it, log_interval,
                                                       results)},
                        self.device)
                    consume({"event": event, "host": host, "nsteps": 1,
                             "it": it, "sample": sample})
                    self.step_times.append(time.perf_counter() - start)
                    if on_frame is not None:
                        on_frame(it)
                    continue

                mark = _phase_clock(self.frame_phases, start)
                mixup_samples = []
                if self.mixup_active and not self.fused_mixup:
                    mixup_samples = self._compose_mixups(sample)
                    mark("mixup")
                batch = self._to_device(self._adapt_batch(sample,
                                                          mixup_samples))
                batch["eval_gt"] = eval_gt
                mark("batch")
                replay = "target_replay" in batch
                results = stats = features = accum = None
                nsteps = self.adaptation_steps
                for step_i in range(nsteps):
                    batch["do_ema"] = step_i == nsteps - 1
                    out = self._call_step(replay, step_i == 0, batch)
                    if step_i == 0:
                        metrics, features, results, stats = out
                    else:
                        metrics, features = out
                    metrics = {k: v for k, v in metrics.items()
                               if k != "target_skipped"}
                    accum = metrics if accum is None else {
                        k: accum[k] + metrics[k] for k in accum}

                mark("step")
                pan_gt = self._gt_panoptic(sample, eval_gt, results)
                host, event = _queue_host(
                    {"stats": stats, "accum": accum, "pan_gt": pan_gt,
                     "features": features,
                     "results": self._host_results(it, log_interval,
                                                   results)},
                    self.device)
                mark("gt_map")
                # the previous frame's meters and add while this frame runs;
                # its successor is sampled before the previous frame's add
                if pending_frame is not None:
                    consume(pending_frame)
                pending_frame = {"event": event, "host": host,
                                 "nsteps": nsteps, "it": it,
                                 "sample": sample}
                mark("meters")
                if it + 1 < num_frames:
                    concurrent.futures.wait([pending])
                mark("prefetch_wait")
                if pending_add is not None:
                    add(*pending_add)
                pending_add = (sample["index"], host["features"])
                mark("add")
                self.step_times.append(time.perf_counter() - start)
                if on_frame is not None:
                    on_frame(it)

            if pending_frame is not None:
                consume(pending_frame)
            if pending_add is not None:
                add(*pending_add)
        finally:
            executor.shutdown(wait=True, cancel_futures=True)
        return self.meters
