"""Validation over a dataset split.

Counterpart of ``codeps_tpu/tasks/validate.py:21 run_validation`` (the
reference's ``validate()``, ``scripts/train_codeps.py:204-415``) on one
card: per batch, the eval forward (depth, semantic, center, offset and
the panoptic fusion of the prediction), the confusion matrix and depth
metrics, the panoptic fusion of the ground truth, and the PQ stream. The
grouping kernel runs twice a batch, for the prediction and for the GT map;
the GT offsets go to the device as (2, H, W) planes, which the kernel
reads in place. With ``compute_loss`` each batch also goes through the
pretraining loss with running statistics (``tasks/train.make_loss_fn``,
``train=False``), as ``codeps_tpu/tasks/validate.py:105-116`` does.

Inside a process group (``parallel/dist.py``) every rank reads the same
global batch and evaluates its contiguous rows, as the JAX package's
processes do (``validate.py:52-104``); a batch that does not divide over
the ranks (the last, with ``drop_last=False``) is evaluated whole on
every rank and counted once. Each batch's statistics are those of the
global batch (the confusion matrix and depth metrics sum over the ranks,
the losses are the means of the ranks' equal shares, the top-k is
global), and the PQ statistics of the ranks are merged at the end. The
visual panels show rank 0's rows of the first batch.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

from codeps_torch import parallel
from codeps_torch.evaluation import PanopticEvaluator, compute_sem_miou
from codeps_torch.tasks.adapt import make_eval_step, make_gt_panoptic_step

# what the eval forward and the GT map read of a batch
_EVAL_KEYS = ("frames", "depth_gt", "semantic", "semantic_eval", "center")


def _to_device(batch_np: Dict[str, np.ndarray], device,
               keys=_EVAL_KEYS) -> Dict[str, Any]:
    batch = {key: torch.from_numpy(np.asarray(batch_np[key])).to(device)
             for key in keys if key in batch_np and key != "offset"}
    if "offset" in batch_np:
        planes = np.ascontiguousarray(
            np.asarray(batch_np["offset"], np.float32).transpose(0, 3, 1, 2))
        batch["offset"] = torch.from_numpy(planes).to(device) \
            .permute(0, 2, 3, 1)
    return batch


def run_validation(cfg, modules, loader, thing_list, stuff_list,
                   ignore_classes=(), max_batches=None,
                   compute_loss: bool = False, class_weights=None,
                   gen_visuals: bool = False,
                   label_mode: str = "codeps") -> Dict[str, Any]:
    """Evaluate ``modules`` (a ``CodepsModules`` in eval mode, on its
    device) over the batches of ``loader`` (numpy batch dicts, as
    ``data/loader.py`` collates them); returns the aggregate metrics:

      - ``sem_conf`` (the summed confusion matrix), ``sem_miou`` (mean
        over the classes with GT pixels) and ``sem_miou_pixels``;
      - the depth metrics ``d_*`` averaged over the batches;
      - ``p_{pq,sq,rq}``, ``p_stuff_*`` and ``p_things_*``;
      - with ``gen_visuals``, ``visual_panels``: colorized panels of the
        first batch;
      - with ``compute_loss``, the unweighted losses ``val_loss_<name>``
        and the weighted total ``val_loss``, averaged over the batches
        (``class_weights`` default to ``cfg.semantics.class_weights``).
        The automask noise of every batch comes from a generator seeded
        0, as the JAX package draws it from one fixed key.
    """
    training = [name for name, m in modules.named_modules() if m.training]
    if training:
        raise ValueError(f"validation runs modules in eval mode; in train "
                         f"mode: {training[:3]}")
    device = next(modules.parameters()).device
    num_classes = modules.num_classes
    eval_step = make_eval_step(cfg, thing_list, num_classes, ignore_classes)
    gt_panoptic = make_gt_panoptic_step(thing_list, num_classes)
    loss_fn = None
    if compute_loss:
        from codeps_torch.tasks.train import make_loss_fn
        if class_weights is None:
            class_weights = list(cfg.semantics.class_weights)
        loss_fn = make_loss_fn(cfg, class_weights, train=False)
        generator = torch.Generator(device=device)

        def noise(shape):
            return parallel.global_normal(shape, generator, device)
    loss_sums: Dict[str, float] = {}
    loss_count = 0

    conf_total = np.zeros((num_classes, num_classes), np.int64)
    depth_sums: Dict[str, float] = {}
    depth_count = 0
    panoptic_eval = PanopticEvaluator(list(stuff_list), list(thing_list))
    first_visuals = None

    for batch_index, batch_np in enumerate(loader):
        if max_batches is not None and batch_index >= max_batches:
            break
        rows = len(next(iter(batch_np.values())))
        divides = rows % parallel.group_size() == 0
        if divides:
            batch_np = {key: value[parallel.shard_rows(rows)]
                        for key, value in batch_np.items()}
        with (contextlib.nullcontext() if divides
              else parallel.replicated()):
            batch = _to_device(batch_np, device, tuple(batch_np)
                               if compute_loss else _EVAL_KEYS)
            results, stats = eval_step(modules, batch)
            if loss_fn is not None:
                generator.manual_seed(0)
                with torch.no_grad():
                    total, losses, _ = loss_fn(modules, batch, noise)
                    names = ["val_loss", *(f"val_loss_{k}" for k in losses)]
                    values = parallel.mean_over_ranks(
                        torch.stack([total, *losses.values()]))
                for key, value in zip(names, values.tolist()):
                    loss_sums[key] = loss_sums.get(key, 0.0) + value
                loss_count += 1
        pan_gt = None
        gt_sem = batch.get("semantic_eval", batch.get("semantic"))
        if "panoptic" in results and "center" in batch \
                and gt_sem is not None and (divides or parallel.is_lead()):
            pan_gt = gt_panoptic(gt_sem, batch["center"], batch["offset"])
        stats = {key: value.cpu().numpy() for key, value in stats.items()}

        if "sem_conf" in stats:
            conf_total += stats["sem_conf"].astype(np.int64)
        depth = {key: value for key, value in stats.items()
                 if key.startswith("d_")}
        for key, value in depth.items():
            depth_sums[key] = depth_sums.get(key, 0.0) + float(value)
        depth_count += bool(depth)

        if gen_visuals and batch_index == 0:
            first_visuals = (batch_np,
                             {k: v.cpu().numpy() for k, v in results.items()
                              if isinstance(v, torch.Tensor)})
        if pan_gt is not None:
            panoptic_eval.update(pan_gt.cpu().numpy(),
                                 results["panoptic"].cpu().numpy())

    if parallel.active():
        parts = parallel.gather_objects(panoptic_eval.pq_stats)
        panoptic_eval.pq_stats = parts[0]
        for part in parts[1:]:
            panoptic_eval.pq_stats += part
    metrics: Dict[str, Any] = {}
    if first_visuals is not None:
        from codeps_torch.io.visualizations import gen_visualizations
        sample_np, results_np = first_visuals
        norm = cfg.dataset.normalization
        mean = norm.rgb_mean if norm.active else (0.0, 0.0, 0.0)
        std = norm.rgb_std if norm.active else (1.0, 1.0, 1.0)
        metrics["visual_panels"] = gen_visualizations(
            sample_np, results_np, mean, std,
            remove_classes=tuple(cfg.dataset.remove_classes),
            label_mode=label_mode)
    for key, value in loss_sums.items():
        metrics[key] = value / loss_count
    if conf_total.sum() > 0:
        per_class = compute_sem_miou(conf_total, num_classes,
                                     ignore_classes)
        keep = [i for i in range(num_classes) if i not in ignore_classes]
        has_gt = conf_total[keep][:, keep].sum(axis=1) != 0
        metrics["sem_miou"] = float(per_class[has_gt].mean()) \
            if has_gt.any() else 0.0
        metrics["sem_miou_pixels"] = float(compute_sem_miou(
            conf_total, num_classes, ignore_classes, sum_pixels=True))
        metrics["sem_conf"] = conf_total
    if depth_count:
        for key, value in depth_sums.items():
            metrics[key] = value / depth_count
    if panoptic_eval.pq_stats.pq_per_cat:
        scores = panoptic_eval.evaluate()
        for group, prefix in (("All", "p"), ("Stuff", "p_stuff"),
                              ("Things", "p_things")):
            for key in ("pq", "sq", "rq"):
                metrics[f"{prefix}_{key}"] = float(scores[group][key])
    return metrics
