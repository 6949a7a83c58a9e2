"""The pretraining step: multi-task forward, weighted loss sum, backward
and Adam.

Counterpart of ``codeps_tpu/tasks/train.py`` (the reference's train
iteration, ``codeps/online_adap.py:76-139`` and
``scripts/train_codeps.py:98-108``), on one card or, data-parallel,
on several (``parallel/dist.py``). As there, without a
flow head the depth encoder runs on frame t only (the reference also
encodes t-1 and t+1 but consumes neither, ``train.py:14-18``); with one,
the three frames go through it in one 3B pass
(``tasks/forward.encode_frames``), whose batch statistics move the
running ones; the pose pairs run as one 2B batch
(``tasks/forward.depth_forward``).

The GUDA semantic loss is computed on the head's plain full-resolution
output, where the JAX package evaluates it in block-phase space: that
view is a permutation of the pixels, so the CE and its top-k mean are
the same.

Batch layout (NHWC, numpy or tensors, as ``data/loader.py`` collates;
uint8 frames are normalized here, floats are taken as normalized):
frames (B, 3, H, W, 3) [t, t-1, t+1] (or image (B, H, W, 3) without the
depth head), camera (B, 4), semantic and semantic_weights (B, H, W),
center (B, H, W, 1), offset (B, H, W, 2), thing_mask (B, H, W), and
optionally depth_gt (B, H, W) and semantic_eval (B, H, W).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from codeps_torch import parallel
from codeps_torch.evaluation.depth_metrics import compute_depth_metrics
from codeps_torch.evaluation.semantic_metrics import compute_confusion_matrix
from codeps_torch.losses import (binary_mask_loss, center_loss,
                                 edge_aware_smoothness_loss,
                                 flow_smoothness_loss, flow_sparsity_loss,
                                 offset_loss, reconstruction_loss,
                                 semantic_loss)
from codeps_torch.models.precision import compute_dtype
from codeps_torch.ops.normalize import maybe_normalize
from codeps_torch.tasks.adapt import batch_to_device
from codeps_torch.tasks.forward import depth_forward, encode_frames
from codeps_torch.tasks.optim import set_learning_rate
from codeps_torch.tasks.state import TrainState


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def make_loss_fn(cfg, class_weights, sem_ignore_classes=None,
                 train: bool = True):
    """The pretraining loss (``train.py:43 make_loss_fn``).

    Returns ``loss_fn(modules, batch, noise) -> (total, losses, preds)``
    on a batch already on the modules' device. ``loss_fn`` puts every
    module in train mode (``train``: batch statistics, running statistics
    updated) or eval mode (running statistics, the validation losses).
    ``noise`` is a callable ``shape -> tensor`` giving the automask noise.

    Args:
      class_weights: per-class semantic CE weights, removed classes
        already dropped.
      sem_ignore_classes: classes left out of the semantic loss and masked
        to -inf before the argmax.
    """
    weights = dict(cfg.losses.weights.items())
    num_scales = cfg.depth.num_recon_scales
    top_k = cfg.semantics.top_k
    loss_dtype = compute_dtype(cfg)
    mean = tuple(cfg.dataset.normalization.rgb_mean)
    std = tuple(cfg.dataset.normalization.rgb_std)

    def loss_fn(modules, batch: Dict[str, Any], noise):
        modules.train(train)
        losses: Dict[str, torch.Tensor] = {}
        preds: Dict[str, torch.Tensor] = {}
        if "frames" in batch:
            frames = maybe_normalize(batch["frames"], mean, std)
            images = [frames[:, i].permute(0, 3, 1, 2).contiguous()
                      for i in range(3)]
        else:
            images = [maybe_normalize(batch["image"], mean, std)
                      .permute(0, 3, 1, 2).contiguous()]
        use_flow = modules.flow_head is not None
        if use_flow:
            feats_t, *feats_nb = encode_frames(modules.backbone_po_depth,
                                               images)
        else:
            feats_t = modules.backbone_po_depth(images[0])
            feats_nb = None

        if modules.depth_head is not None:
            fwd = depth_forward(modules, images, feats_t, feats_nb)
            motion = fwd["object_motion_maps"]
            losses["depth_recon"] = reconstruction_loss(
                batch["camera"], images, fwd["depth"],
                fwd["transformations"], motion, num_scales=num_scales,
                noise=noise, dtype=loss_dtype)
            losses["depth_smth"] = edge_aware_smoothness_loss(
                images[0], fwd["disparity"])
            if use_flow:
                losses["flow_smth"] = flow_smoothness_loss(motion)
                losses["flow_sparsity"] = flow_sparsity_loss(motion)
            preds["depth"] = _nhwc(fwd["depth"])

        if modules.semantic_head is not None:
            sem_probs = modules.semantic_head(feats_t)
            losses["semantic"] = semantic_loss(
                sem_probs, batch["semantic"], batch["semantic_weights"],
                class_weights=class_weights,
                ignore_labels=sem_ignore_classes, top_k_percent_pixels=top_k,
                dtype=loss_dtype)
            masked = sem_probs.detach()
            if sem_ignore_classes:
                masked = masked.clone()
                masked[:, list(sem_ignore_classes)] = -torch.inf
            preds["semantic"] = masked.argmax(dim=1).to(torch.int32)

        if modules.instance_head is not None:
            center, offset, thing_mask = modules.instance_head(feats_t)
            losses["center"] = center_loss(_nhwc(center), batch["center"])
            losses["offset"] = offset_loss(_nhwc(offset), batch["offset"])
            if thing_mask is not None:
                losses["thing_mask"] = binary_mask_loss(thing_mask,
                                                        batch["thing_mask"])

        total = torch.zeros((), device=images[0].device)
        for key, value in losses.items():
            weight = weights.get(key)
            if weight is not None:
                total = total + weight * value
        return total, losses, preds

    return loss_fn


def make_train_step(cfg, class_weights, sem_ignore_classes=None,
                    num_classes: int | None = None, eval_ignore_classes=()):
    """The pretraining step (``train.py:196 make_train_step``).

    Returns ``train_step(state, batch, noise=None) -> metrics``, which
    updates ``state`` in place: backward through the live modules, Adam at
    the schedule's rate for ``state.step``, the step count. ``noise``
    replaces the state's generator as the source of the automask noise.
    The metrics are the unweighted losses, ``loss_total``, ``sem_conf``
    (the confusion matrix against ``semantic_eval`` or ``semantic``,
    without ``eval_ignore_classes``) and, when the batch has ``depth_gt``,
    the depth metrics; tensors on the device.

    Inside a process group (``parallel/dist.py``) ``batch`` is this rank's
    share of the global batch: the gradients are averaged over the ranks
    before Adam, the automask noise is this rank's rows of the global
    batch's draw from the generator (in the same state on every rank),
    and the metrics are the global batch's.
    """
    loss_fn = make_loss_fn(cfg, class_weights, sem_ignore_classes)
    use_gt_scale = cfg.eval.depth.use_gt_scale
    depth_ranges = tuple(cfg.eval.depth.depth_ranges)

    def train_step(state: TrainState, batch, noise=None):
        batch = batch_to_device(dict(batch), state.device)
        if noise is None:
            def noise(shape):
                return parallel.global_normal(shape, state.generator,
                                              state.device)
        state.optimizer.zero_grad(set_to_none=True)
        total, losses, preds = loss_fn(state.modules, batch, noise)
        total.backward()
        parallel.average_gradients(
            p for group in state.optimizer.param_groups
            for p in group["params"])
        set_learning_rate(state.optimizer, state.schedule(state.step))
        state.optimizer.step()
        state.step += 1

        scalars = {"loss_total": total, **losses}
        means = parallel.mean_over_ranks(
            torch.stack([v.detach() for v in scalars.values()]))
        metrics = dict(zip(scalars, means.unbind()))
        if "semantic" in preds and "semantic" in batch:
            metrics["sem_conf"] = compute_confusion_matrix(
                preds["semantic"], batch.get("semantic_eval",
                                             batch["semantic"]),
                num_classes or state.modules.num_classes,
                eval_ignore_classes)
        if "depth" in preds and batch.get("depth_gt") is not None:
            metrics.update(compute_depth_metrics(
                batch["depth_gt"], preds["depth"].detach(), use_gt_scale,
                depth_ranges))
        return metrics

    return train_step

