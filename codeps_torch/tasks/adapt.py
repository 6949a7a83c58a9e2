"""The online-adaptation step: teacher eval, multi-domain losses, Adam,
EMA blend and the non-moving-frame skip.

Counterpart of ``codeps_tpu/tasks/adapt.py:53-919``. One call of the
step does, for one streamed frame:

  1. the multi-domain forward with autograd through the live modules
     only: depth and pose losses (and with a flow head the flow
     smoothness and sparsity) on the source triplets and on the target
     triplet, batched with target replay when there is no flow head, the
     top-k CE on source replay and
     on each mixup strategy group, and the frozen instance head's source
     losses; with ``fused_mixup`` the mixup samples are composed here
     from their raw materials (teacher pseudo-labels, the camera warp,
     cut cells and class masks);
  2. backward; the teacher eval of the frame on the weights from before
     the update (panoptic fusion with the grouping kernel, depth metrics,
     per-class depth metrics when asked, confusion matrix);
  3. the skip ring's push, Adam, and the per-module EMA blend.

On one CUDA card, in one process, with the automask noise left to the
state's generator, the losses of part 1 and their backward run as one
CUDA graph (``tasks/step_graph.py``), replayed for every batch of a
signature after a warm-up and a capture; the rest of the step runs
eagerly.

In a frame the runner opens (``tasks/trace.py``) the step's host time
splits into the contiguous spans ``step.forward`` (to the end of the
losses; on the graphed path the inputs' copy, the replay, the
gradients handed to the parameters and the outputs' clones, and in the
warm-up before a capture the backward too), ``step.backward`` (nothing
on the graphed path), ``step.eval`` and ``step.update`` (which holds
``step.optimizer`` and ``step.ema``).

Batch layout (NHWC, frame axis order [t, t-1, t+1]; numpy or tensors,
uint8 frames are normalized here, floats are taken as normalized):
  target: frames (1, 3, Ht, Wt, 3), camera (1, 4)
  source: frames (Ns, 3, Hs, Ws, 3), camera, semantic, semantic_weights,
          center (Ns, Hs, Ws, 1), offset (Ns, Hs, Ws, 2), optional
          thing_mask
  target_replay (with ``has_replay``): frames (Nr, 3, Ht, Wt, 3), camera
  mixup (with ``num_mixup``): composed samples rgb (Nm, Hs, Ws, 3),
          semantic (Nm, Hs, Ws); or with ``fused_mixup`` the raw
          materials rgb_src (Nm, Hs, Ws, 3), semantic_src (Nm, Hs, Ws),
          rgb_tgt (Nm, Ht, Wt, 3), prewarp (``mixup_prep.c2c_prewarp``,
          with ``geom_augment``), cut_cells (N_cut, nof_segments) int and
          class_replace (N_class, 256) bool, rows in the order of
          ``mixup_groups``
  eval_gt (optional): depth_gt, semantic, semantic_eval
  do_ema (optional): False keeps the teacher untouched for this step.
"""

from __future__ import annotations

import contextlib
import types
from typing import Any, Dict

import numpy as np
import torch

from codeps_torch import parallel
from codeps_torch.evaluation.depth_metrics import (
    compute_depth_metrics, compute_depth_metrics_per_class)
from codeps_torch.evaluation.semantic_metrics import compute_confusion_matrix
from codeps_torch.losses import (binary_mask_loss, center_loss,
                                 edge_aware_smoothness_loss,
                                 ema_consistency_loss, flow_smoothness_loss,
                                 flow_sparsity_loss, offset_loss,
                                 reconstruction_loss, semantic_loss)
from codeps_torch.models.codeps_net import MODULE_NAMES
from codeps_torch.models.precision import compute_dtype
from codeps_torch.ops.grid_sample import grid_sample_pair_pre
from codeps_torch.ops.normalize import maybe_normalize
from codeps_torch.ops.panoptic import panoptic_fusion_batch
from codeps_torch.parallel import spatial
from codeps_torch.tasks import trace
from codeps_torch.tasks.forward import (apply_encoder, depth_forward,
                                        encode_frames)
from codeps_torch.tasks.optim import set_learning_rate
from codeps_torch.tasks.state import DIST_BUFFER_LEN, AdaptState
from codeps_torch.tasks.step_graph import StepGraphs, count_step

__all__ = ["DIST_BUFFER_LEN", "batch_to_device", "build_eval_forward",
           "make_eval_step", "make_gt_panoptic_step", "skip_decision",
           "push_ring_buffer", "teacher_labels", "make_plabel_step",
           "compose_mixup", "make_adapt_step"]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# --------------------------------------------------------------- teacher

def build_eval_forward(cfg, thing_list, num_classes: int,
                       eval_ignore_classes=(),
                       class_wise_depth_stats: bool = False):
    """The teacher's evaluation of a target frame: predictions, panoptic
    fusion and the metric ingredients (``adapt.py:53-132``);
    ``class_wise_depth_stats`` adds the per-class depth stats
    (``d_<metric>_c<class>``, NaN for a class absent from the GT).

    Returns ``eval_step(modules, batch, feats=None, sem_probs=None,
    depth=None) -> (results, stats)``. ``modules`` has the attributes of
    ``CodepsModules``, in eval mode; ``batch`` holds ``frames`` (B, 3, H,
    W, 3) or ``image`` (B, H, W, 3) and optionally ``depth_gt``,
    ``semantic`` and ``semantic_eval``. ``feats`` (the encoder's NCHW
    pyramid), ``sem_probs`` and ``depth`` (NCHW) stand in for forwards
    already run. Results are NHWC, as the JAX facade's.

    Inside a row split (``parallel/spatial.py``) the forwards run on this
    rank's rows (``feats``, ``sem_probs`` and ``depth`` are its slabs),
    their maps are gathered whole, and rank 0 alone scores them and fuses
    the panoptic map, with the grouping kernel; the other ranks return
    ``(None, None)``.
    """
    use_gt_scale = cfg.eval.depth.use_gt_scale
    depth_ranges = tuple(cfg.eval.depth.depth_ranges)
    thing_list = tuple(thing_list)
    mean = tuple(cfg.dataset.normalization.rgb_mean)
    std = tuple(cfg.dataset.normalization.rgb_std)

    def predict(modules, batch, feats, sem_probs, depth):
        """The heads' NCHW maps of this rank's rows."""
        if feats is None:
            image = (batch["frames"][:, 0] if "frames" in batch
                     else batch["image"])
            feats = apply_encoder(modules.backbone_po_depth, maybe_normalize(
                spatial.rows_of(image, axis=1), mean, std))
        maps: Dict[str, Any] = {}
        if modules.depth_head is not None:
            maps["depth"] = (modules.depth_head(feats)[0] if depth is None
                             else depth)
        if modules.semantic_head is not None:
            maps["sem_probs"] = (modules.semantic_head(feats)
                                 if sem_probs is None else sem_probs)
        if modules.instance_head is not None:
            maps["center"], maps["offset"], maps["thing_mask"] = \
                modules.instance_head(feats)
        return maps

    def score(maps, batch):
        results: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        if "depth" in maps:
            results["depth"] = _nhwc(maps["depth"])
            if batch.get("depth_gt") is not None:
                stats.update(compute_depth_metrics(
                    batch["depth_gt"], results["depth"], use_gt_scale,
                    depth_ranges))
                if class_wise_depth_stats \
                        and batch.get("semantic") is not None:
                    stats.update(compute_depth_metrics_per_class(
                        batch["depth_gt"], results["depth"],
                        batch["semantic"], num_classes, use_gt_scale,
                        depth_ranges))
        if "sem_probs" in maps:
            sem_soft = _nhwc(maps["sem_probs"])
            sem_pred = sem_soft.argmax(dim=-1).to(torch.int32)
            results["semantic"] = sem_pred
            results["semantic_soft"] = sem_soft
            if batch.get("semantic") is not None:
                gt = batch.get("semantic_eval", batch["semantic"])
                stats["sem_conf"] = compute_confusion_matrix(
                    sem_pred, gt, num_classes, eval_ignore_classes)
        if "center" in maps:
            results["center"] = _nhwc(maps["center"])
            results["offset"] = _nhwc(maps["offset"])
            results["thing_mask"] = (None if maps["thing_mask"] is None
                                     else _nhwc(maps["thing_mask"]))
        if "sem_probs" in maps and "center" in maps:
            pan, inst, _ = panoptic_fusion_batch(
                results["semantic_soft"], results["center"],
                results["offset"], thing_list)
            results["panoptic"] = pan
            results["instance"] = inst
        return results, stats

    @torch.no_grad()
    def eval_step(modules, batch, feats=None, sem_probs=None, depth=None):
        size = (batch["frames"].shape[2:4] if "frames" in batch
                else batch["image"].shape[1:3])
        with spatial.image(*size):
            maps = predict(modules, batch, feats, sem_probs, depth)
            if not spatial.active():
                return score(maps, batch)
            # the slabs' maps, whole, scored on rank 0: the fusion's votes
            # and center NMS are global
            maps = {key: None if value is None
                    else spatial.gather_rows(value)
                    for key, value in maps.items()}
        if not parallel.is_lead():
            return None, None
        with parallel.replicated():
            return score(maps, batch)

    return eval_step


def make_eval_step(cfg, thing_list, num_classes: int,
                   eval_ignore_classes=(),
                   class_wise_depth_stats: bool = False):
    """The standalone teacher eval (``adapt.py:135``, the runner's
    eval-only mode): ``eval_step(modules, batch) -> (results, stats)``
    with the batch moved to the modules' device."""
    forward = build_eval_forward(cfg, thing_list, num_classes,
                                 eval_ignore_classes,
                                 class_wise_depth_stats)

    def eval_step(modules, batch):
        device = next(modules.parameters()).device
        return forward(modules, batch_to_device(batch, device))

    return eval_step


def make_gt_panoptic_step(thing_list, num_classes: int):
    """Panoptic ids of the ground truth (``adapt.py:175``): integer labels
    (B, H, W), center heatmaps (B, H, W, 1) and offsets (B, H, W, 2) ->
    (B, H, W) int32, grouped by the same kernel as the teacher's maps."""
    thing_list = tuple(thing_list)

    @torch.no_grad()
    def gt_panoptic(semantic_gt, center_gt, offset_gt):
        pan, _, _ = panoptic_fusion_batch(semantic_gt, center_gt, offset_gt,
                                          thing_list,
                                          num_classes=num_classes)
        return pan

    return gt_panoptic


# ------------------------------------------------------------- skip ring

def skip_decision(dist_buffer: torch.Tensor, dist_count: torch.Tensor,
                  dist: torch.Tensor) -> torch.Tensor:
    """Skip a non-moving frame: the ring is full and its mean exceeds ten
    times the current camera translation (``algos/depth.py:543-548``)."""
    capacity = dist_buffer.shape[0]
    full = dist_count >= capacity
    return full & (dist_buffer.sum() / capacity > 10.0 * dist)


def push_ring_buffer(dist_buffer: torch.Tensor, dist_count: torch.Tensor,
                     dist_head: torch.Tensor, dist: torch.Tensor,
                     skip: torch.Tensor):
    """Appends ``dist`` unless the frame was skipped, written into
    ``dist_buffer``, ``dist_count`` and ``dist_head`` in place on the
    device without a host wait (a captured step graph reads these very
    tensors); returns them."""
    capacity = dist_buffer.shape[0]
    pushed = dist_buffer.index_put((dist_head.reshape(1),),
                                   dist.reshape(1).to(dist_buffer.dtype))
    dist_buffer.copy_(torch.where(skip, dist_buffer, pushed))
    dist_count.copy_(torch.where(skip, dist_count,
                                 torch.clamp(dist_count + 1, max=capacity)))
    dist_head.copy_(torch.where(skip, dist_head,
                                (dist_head + 1) % capacity))
    return dist_buffer, dist_count, dist_head


# ------------------------------------------------------------------ mixup

@torch.no_grad()
def teacher_labels(teacher, images: torch.Tensor, with_instance=False):
    """The teacher's pseudo-labels of normalized NHWC ``images``: the
    argmax of its semantic head (B, H, W) int64, and with
    ``with_instance`` the instance head's center (B, H, W, 1) and offsets
    (B, H, W, 2), NHWC views of its NCHW output (the layout the grouping
    kernel reads in place)."""
    feats = apply_encoder(teacher.backbone_po_depth, images)
    sem_pred = teacher.semantic_head(feats).argmax(dim=1)
    if not with_instance:
        return sem_pred
    center, offset, _ = teacher.instance_head(feats)
    return sem_pred, _nhwc(center), _nhwc(offset)


def make_plabel_step(mean, std):
    """The teacher's predictions on a stack of mixup target images
    (``adapt.py:145-172``): ``plabel_step(teacher, images (B, H, W, 3)
    uint8 or normalized float) -> (semantic (B, H, W) int32, center (B, H,
    W, 1), offset (B, H, W, 2))``."""
    mean, std = tuple(mean), tuple(std)

    def plabel_step(teacher, images):
        sem_pred, center, offset = teacher_labels(
            teacher, maybe_normalize(images, mean, std), with_instance=True)
        return sem_pred.to(torch.int32), center, offset

    return plabel_step


@torch.no_grad()
def compose_mixup(teacher, mixup, mixup_groups, cut_cfg,
                  geom_augment: bool, mean, std):
    """The fused mixup samples of a batch's raw materials
    (``adapt.py:359-443``): (rgb (Nm, Hs, Ws, 3) normalized, semantic
    (Nm, Hs, Ws) int32).

    The teacher labels ``rgb_tgt`` (argmax of its semantic head), the
    camera warp carries image and labels into the source frame (with
    ``geom_augment``), and each row of ``mixup_groups`` takes the target
    where its mask holds: cut cells ``cut_cells`` of the
    ``cut_cfg`` grid, each ending one pixel short of the next cell, or the
    source pixels whose class ``class_replace`` marks.

    Inside a row split (``parallel/spatial.py``) the teacher labels this
    rank's rows of ``rgb_tgt`` and the labels are gathered: the warp reads
    any row. The (cheap, elementwise) composition runs on whole images,
    which every rank returns. Inside ``spatial.images()`` ``mixup`` holds
    this rank's samples (``spatial.place_images``) and ``mixup_groups``
    their counts: the teacher labels each whole, nothing is gathered.
    """
    rgb_tgt = maybe_normalize(mixup["rgb_tgt"], mean, std)
    rgb_src = maybe_normalize(mixup["rgb_src"], mean, std)
    semantic_src = mixup["semantic_src"].long()
    with spatial.image(*rgb_tgt.shape[1:3]):
        sem_pred = spatial.gather_rows(teacher_labels(
            teacher, spatial.rows_of(rgb_tgt, axis=1)), axis=1)
    if geom_augment:
        rgb_w, sem_w = grid_sample_pair_pre(rgb_tgt, sem_pred[..., None],
                                            mixup["prewarp"])
        sem_w = sem_w[..., 0]
    else:
        rgb_w, sem_w = rgb_tgt, sem_pred

    height, width = rgb_src.shape[1:3]
    device = rgb_src.device
    masks, start = [], 0
    for strategy, count in mixup_groups:
        rows = slice(start, start + count)
        start += count
        if strategy == "cut_mixup":
            crop_h = height // cut_cfg.nof_vert_splits
            crop_w = width // cut_cfg.nof_hor_splits
            yy = torch.arange(height, device=device)[:, None]
            xx = torch.arange(width, device=device)[None, :]
            cells = mixup["cut_cells"].long()          # (N_cut, segments)
            mul_x = (cells % cut_cfg.nof_hor_splits)[:, :, None, None]
            mul_y = (cells // cut_cfg.nof_hor_splits)[:, :, None, None]
            in_cell = ((yy >= mul_y * crop_h)
                       & (yy < (mul_y + 1) * crop_h - 1)
                       & (xx >= mul_x * crop_w)
                       & (xx < (mul_x + 1) * crop_w - 1))
            masks.append(in_cell.any(dim=1))
        else:
            table = mixup["class_replace"]             # (N_class, 256)
            labels = semantic_src[rows].clamp(0, table.shape[1] - 1)
            masks.append(torch.gather(table, 1, labels.reshape(
                count, -1)).reshape(labels.shape))
    mask = torch.cat(masks) if len(masks) > 1 else masks[0]
    rgb_mix = torch.where(mask[..., None], rgb_w, rgb_src)
    sem_mix = torch.where(mask, sem_w.long(), semantic_src)
    return rgb_mix, sem_mix.to(torch.int32)


# --------------------------------------------------------- student update

def batch_to_device(tree, device, float_dtype=None):
    """A batch (nested dicts of numpy arrays or tensors) on ``device``;
    with ``float_dtype`` its floating-point leaves in that type. Leaves
    copied from the host count in the open frame (``trace.upload``)."""
    if isinstance(tree, dict):
        return {k: batch_to_device(v, device, float_dtype)
                for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        tree = torch.from_numpy(np.asarray(tree))
    if isinstance(tree, torch.Tensor):
        if float_dtype is not None and tree.is_floating_point():
            return trace.upload(tree, device, float_dtype)
        return trace.upload(tree, device)
    return tree


def _triplets(frames: torch.Tensor, mean, std) -> list[torch.Tensor]:
    """(B, 3, H, W, 3) NHWC frames -> [t, t-1, t+1], each (B, 3, H, W)."""
    frames = maybe_normalize(frames, mean, std).permute(0, 1, 4, 2, 3)
    return [frames[:, i].contiguous() for i in range(3)]


def _nchw_images(images: torch.Tensor, mean, std) -> torch.Tensor:
    return maybe_normalize(images, mean, std).permute(0, 3, 1, 2) \
        .contiguous()


def _blend_ema(state: AdaptState, do_ema: bool) -> None:
    """``teacher = alpha * teacher + (1 - alpha) * student`` per module,
    written as such so that alpha 0 copies and alpha 1 keeps exactly.
    Modules kept (alpha 1, or every module when ``do_ema`` is false) are
    left alone: the formula would return them unchanged. BatchNorm
    buffers are never blended."""
    if not do_ema:
        return
    for name in state.student.module_names():
        alpha = state.ema_alpha[name]
        if alpha == 1.0:
            continue
        for e, p in zip(getattr(state.teacher, name).parameters(),
                        getattr(state.student, name).parameters()):
            e.copy_(alpha * e + (1.0 - alpha) * p)


def _check_row_split(batch, by_images=()) -> None:
    """Raises ValueError, on every rank before any collective, where a
    height of a domain placed by rows (not in ``by_images``) does not
    split into slabs of whole 32-row blocks: any multiple of 32 splits,
    and with fewer blocks than ranks the last ranks' slabs are empty
    (``spatial.slab_rows``); they run every collective of the step with
    no rows of that domain, and their share of its losses is 0."""
    for domain in ("target", "source", "target_replay"):
        if domain in batch and domain not in by_images:
            spatial.check_height(batch[domain]["frames"].shape[2])
    if "mixup" not in by_images:
        for key in ("rgb", "rgb_src", "rgb_tgt"):
            if key in batch.get("mixup", {}):
                spatial.check_height(batch["mixup"][key].shape[1])


def _split_noise(noise, count: int, total: int):
    """Two noise callables over one draw a scale at the merged shape of
    ``total`` samples: the first (the target's) is asked for the first
    ``count`` samples and draws, the second (the replay's) takes the rest
    of each draw in turn. The draws come in one process's order."""
    rest = []

    def first(shape):
        draw = noise((total, *shape[1:]))
        rest.append(draw[count:])
        return draw[:count]

    def second(shape):
        draw = rest.pop(0)
        if tuple(draw.shape) != tuple(shape):
            raise ValueError(f"the replay's noise is {tuple(draw.shape)}, "
                             f"asked for {tuple(shape)}")
        return draw
    return first, second


def make_adapt_step(cfg, class_weights, has_replay: bool = True,
                    num_mixup: int = 0, mixup_groups=None,
                    fused_mixup: bool = False,
                    sem_ignore_classes=None, eval_forward=None):
    """Build the adaptation step (``adapt.py:233 make_adapt_step``).

    Returns ``adapt_step(state, batch, noise=None)``, which updates
    ``state`` in place and returns ``(metrics, image_features)``, or with
    ``eval_forward`` (from ``build_eval_forward``) ``(metrics,
    image_features, eval_results, eval_stats)``. ``noise`` replaces the
    state's generator as the source of the automask noise
    (``losses/photometric.py``): a callable ``shape -> tensor`` asked for
    the source domain's scales, then the target domain's (target and
    replay merged; with a flow head the target's, then the replay's).
    With a flow head the eval results also hold ``object_motion_map``,
    the student's target motion pair (2, B, H, W, 3).

    The step keeps its own CUDA graphs (``tasks/step_graph.py``): on a
    CUDA device, in one process and with ``noise`` None, the first call
    of a batch signature runs eagerly on a side stream, the second
    captures the losses and their backward, and every later one replays
    them; any other call runs eagerly. The returned tensors are the
    caller's own either way.

    ``mixup_groups`` = ((strategy, count), ...) partitions the mixup
    samples; each group gets ONE pooled top-k CE with unit pixel weights,
    weighted once by ``cfg.losses.weights[f"semantic_{strategy}"]`` (the
    reference's per-key loss, ``adapt.py:686-708``).

    With ``fused_mixup`` the step composes ``cut_mixup`` and
    ``class_mixup`` samples itself (``adapt.py:359-443``): the teacher's
    argmax over ``rgb_tgt`` on the weights from before the update, the
    camera warp into the source frame (``geom_augment``), then the masks
    -- cut cells ending at ``(k+1)*crop - 1`` (exclusive, so a 1-px seam)
    or the source pixels whose class the (N, 256) table marks. The
    composed images are constants for autograd.

    With a frozen depth encoder, the teacher eval takes the target frame's
    encoder features and, when the depth head is not EMA-filtered, its
    depth from the student's loss forward: frozen and copy-class teacher
    modules equal the student's at the start of a frame
    (``adapt.py:255-273``; one step per frame, as the published config
    runs), so only EMA-filtered modules are read from the teacher.
    Otherwise the teacher evaluates the frame with all of its own
    modules.

    Called inside a row split (``parallel/spatial.py``: ``spatial.rows()``
    in a process group of N ranks, each holding the whole batch) every
    rank computes its slab of the rows of every image tensor of the step
    and its share of every loss; the pose net runs whole on every rank;
    the gradients are summed over the ranks before Adam; the metrics are
    the global values on every rank; rank 0 alone gets the eval results
    and stats (the others None). Every height must be a multiple of 32
    rows (else ValueError); with fewer 32-row blocks than ranks the last
    ranks hold empty slabs of that domain. With a
    flow head the triplets' rows go through the encoder in one pass, and
    the pose net and the flow head run on the whole frames on every rank:
    the motion maps are whole everywhere, the photometric loss takes its
    rows of them, and the flow regularizers enter as shares.

    Called inside ``spatial.hybrid()`` (the JAX runner's placement in
    spatial mode, ``shard_adapt_batch_hybrid``) the target and its eval
    go by rows as above, and each side domain -- source, target replay,
    mixup -- by images where its sample count divides N, by rows where
    it does not (``spatial.hybrid_placement``; the JAX package tests the
    leading axis of a domain's first leaf in sorted key order, for a
    fused mixup with ``class_replace`` the class mixups' count, where the
    port tests the sample count: placement changes no number). A domain
    by images runs its encoder, depth and semantic heads, teacher labels
    and losses whole on this rank's images, any height, with no halo
    exchange and no gather; the pose net (and flow head) still runs
    replicated on the domain's whole frames, so its train-mode BatchNorm
    sees the one-process batch, and the photometric loss takes this
    rank's images of the poses; batch statistics reduce over the ranks;
    every term enters as the rank's share, so the summed gradient stays
    right. The automask noise is this rank's images of the draw at the
    whole batch's shape. Without a flow head and with the replay by
    images the merged target-plus-replay pass splits: the pose net takes
    the merged whole frames, the encoder and the depth head two calls
    (the target's rows, then this rank's replay images), and the noise is
    drawn once a scale at the merged shape. Where the depth encoder is
    live its train-mode BatchNorm would see other batches in two calls:
    there target and replay both stay by rows. A mixup strategy group's
    top-k CE is global over the group's samples on all ranks, and every
    rank runs its collectives, also one that holds none of the group.
    Only the domains placed by rows need whole 32-row blocks.
    """
    weights = {k: v for k, v in cfg.losses.weights.items()}
    num_scales = cfg.depth.num_recon_scales
    # the image-space loss math follows the modules' compute dtype
    # (adapt.py:300-305); geometry stays float32
    loss_dtype = compute_dtype(cfg)
    top_k = cfg.semantics.top_k
    mean = tuple(cfg.dataset.normalization.rgb_mean)
    std = tuple(cfg.dataset.normalization.rgb_std)
    if mixup_groups is None:
        mixup_groups = (("cut_mixup", num_mixup),) if num_mixup else ()
    mixup_groups = tuple((str(n), int(c)) for n, c in mixup_groups if c)
    if sum(c for _, c in mixup_groups) != num_mixup:
        raise ValueError(f"mixup_groups {mixup_groups} do not add up to "
                         f"{num_mixup} samples")
    if fused_mixup and any(s not in ("cut_mixup", "class_mixup")
                           for s, _ in mixup_groups):
        raise ValueError(f"fused mixup composes cut_mixup and class_mixup, "
                         f"got {mixup_groups}")
    cut_cfg = cfg.adapt.mixup.cut_mix
    geom_augment = cfg.adapt.mixup.general.geom_augment

    def sem_loss(prediction, target, pixel_weights):
        return semantic_loss(prediction, target, pixel_weights,
                             class_weights=class_weights,
                             ignore_labels=sem_ignore_classes,
                             top_k_percent_pixels=top_k, dtype=loss_dtype)

    def merges(student, batch) -> bool:
        """Whether target and target replay take ONE pass (no flow head and
        the same frame size, ``adapt.py:514``)."""
        return (has_replay and student.flow_head is None
                and batch["target"]["frames"].shape[2:]
                == batch["target_replay"]["frames"].shape[2:])

    def depth_domain(student, images, camera, noise, per_sample=False):
        """Depth losses of one domain: a dict of recon, smth, flow (the
        flow smoothness and sparsity, or None without a flow head),
        transformations, feats (the frame-t encoder pyramid), depth (of
        frame t) and motion (the object-motion pair, or None). ``images``
        and ``camera`` are the domain's whole triplet and cameras. In a
        row split the triplet's rows go through the encoder (frame t's
        alone without a flow head) and frame t's through the losses; the
        whole frames, with their gathered depth, go through the pose net,
        the flow head and the warp on every rank. Inside
        ``spatial.images()`` this rank's images go through the encoder,
        the depth head and the losses, and every image through the pose
        net and the flow head; the transformations and the motion come
        back whole."""
        mine = [spatial.images_of(image) for image in images]
        with spatial.image(*images[0].shape[-2:]):
            if student.flow_head is not None:
                feats_t, *feats_nb = encode_frames(
                    student.backbone_po_depth,
                    [spatial.rows_of(image) for image in mine])
            else:
                feats_t = student.backbone_po_depth(
                    spatial.rows_of(mine[0]))
                feats_nb = None
            fwd = depth_forward(student, images, feats_t, feats_nb)
            # the motion maps are whole on every rank: the flow losses
            # enter each rank's loss as its share
            motion = fwd["object_motion_maps"]
            return {
                "recon": reconstruction_loss(
                    spatial.images_of(camera), mine, fwd["depth"],
                    [spatial.images_of(t) for t in fwd["transformations"]],
                    None if motion is None
                    else [spatial.images_of(m) for m in motion],
                    num_scales=num_scales, per_sample=per_sample,
                    noise=noise, dtype=loss_dtype),
                "smth": edge_aware_smoothness_loss(
                    mine[0], fwd["disparity"], per_sample=per_sample),
                "flow": None if motion is None else (
                    spatial.share(flow_smoothness_loss(motion)),
                    spatial.share(flow_sparsity_loss(motion))),
                "transformations": fwd["transformations"],
                "feats": feats_t, "depth": fwd["depth"], "motion": motion}

    def split_merged(student, images, camera, count, noise):
        """The merged target and replay pass with the target's ``count``
        samples by rows and the replay by images: (target losses, replay
        losses, the merged transformations, the target's features and
        depth). The pose net takes the merged whole frames; the encoder
        and the depth head take the target's rows, then this rank's
        replay images (a frozen encoder, in eval mode, and heads without
        normalization: two calls change nothing); the noise is drawn once
        a scale at the merged shape."""
        target_noise, replay_noise = _split_noise(noise, count,
                                                  images[0].shape[0])
        with spatial.image(*images[0].shape[-2:]):
            feats = student.backbone_po_depth(
                spatial.rows_of(images[0][:count]))
            # the depth head on the target's rows, the pose net on all
            fwd = depth_forward(student, images, feats)
            poses = fwd["transformations"]
            target_dom = {
                "recon": reconstruction_loss(
                    camera[:count], [im[:count] for im in images],
                    fwd["depth"], [p[:count] for p in poses],
                    num_scales=num_scales, per_sample=True,
                    noise=target_noise, dtype=loss_dtype).mean(),
                "smth": edge_aware_smoothness_loss(
                    images[0][:count], fwd["disparity"],
                    per_sample=True).mean()}
        with spatial.images():
            replay = [spatial.images_of(im[count:]) for im in images]
            depth, disparity = student.depth_head(
                student.backbone_po_depth(replay[0]))
            replay_dom = {
                "recon": spatial.mean(reconstruction_loss(
                    spatial.images_of(camera[count:]), replay, depth,
                    [spatial.images_of(p[count:]) for p in poses],
                    num_scales=num_scales, per_sample=True,
                    noise=replay_noise, dtype=loss_dtype)),
                "smth": spatial.mean(edge_aware_smoothness_loss(
                    replay[0], disparity, per_sample=True))}
        return target_dom, replay_dom, poses, feats, fwd["depth"]

    def mixup_forward(state, mixup):
        """This rank's mixup samples through the student's encoder:
        (features, semantic labels, (height, width), groups), groups as
        ``spatial.group_slices``. With ``fused_mixup`` the samples are
        composed here. Inside ``spatial.images()`` they are this rank's
        images, the teacher labelling each whole; by rows, this rank's
        rows of the whole samples."""
        groups = spatial.group_slices(mixup_groups, num_mixup)
        if spatial.images_active():
            mixup = spatial.place_images(mixup, mixup_groups)
        if fused_mixup:
            rgb, semantic = compose_mixup(
                state.teacher, mixup,
                tuple((strategy, part.stop - part.start)
                      for strategy, _, part in groups
                      if part.stop > part.start),
                cut_cfg, geom_augment, mean, std)
        else:
            rgb, semantic = mixup["rgb"], mixup["semantic"]
        size = tuple(rgb.shape[1:3])
        with spatial.image(*size):
            rgb, semantic = (spatial.rows_of(x, axis=1)
                             for x in (rgb, semantic))
            feats = state.student.backbone_po_depth(
                _nchw_images(rgb, mean, std))
        return feats, semantic, size, groups

    def semantic_losses(state, batch, source, source_feats, losses,
                        placed, by_images):
        """The source and mixup semantic losses into ``losses``, each
        domain under its placement (``placed(domain)``)."""
        student = state.student
        source_size = tuple(batch["source"]["frames"].shape[2:4])
        num_source = source_feats[0].shape[0]
        mix_feats = None
        if num_mixup > 0:
            with placed("mixup"):
                mix_feats, mix_semantic, mix_size, groups = mixup_forward(
                    state, batch["mixup"])
        if mix_feats is not None and mix_size == source_size \
                and ("mixup" in by_images) == ("source" in by_images) \
                and mix_feats[0].shape[1:] == source_feats[0].shape[1:]:
            # One semantic-head pass over source and mixup: the head has
            # no normalization layer, so batching changes nothing.
            with placed("source"), spatial.image(*source_size):
                sem_cat = student.semantic_head(
                    [torch.cat([fs, fm]) for fs, fm in zip(source_feats,
                                                           mix_feats)])
            sem_src, sem_mix = sem_cat[:num_source], sem_cat[num_source:]
        else:
            with placed("source"), spatial.image(*source_size):
                sem_src = student.semantic_head(source_feats)
            sem_mix = None
            if mix_feats is not None:
                with placed("mixup"), spatial.image(*mix_size):
                    sem_mix = student.semantic_head(mix_feats)
        with placed("source"), spatial.image(*source_size):
            losses["semantic_source"] = sem_loss(
                sem_src, source["semantic"], source["semantic_weights"])
        if sem_mix is None:
            return
        # every rank runs each group's collectives, also one that holds
        # none of its samples
        with placed("mixup"), spatial.image(*mix_size):
            for strategy, count, part in groups:
                if weights.get(f"semantic_{strategy}") is None:
                    continue
                with spatial.samples(count):
                    losses[f"semantic_{strategy}"] = sem_loss(
                        sem_mix[part], mix_semantic[part],
                        torch.ones(mix_semantic[part].shape,
                                   device=sem_mix.device))

    def loss_fn(state: AdaptState, batch, noise, reuse_feats, reuse_depth,
                by_images):
        student = state.student
        use_flow = student.flow_head is not None
        losses: Dict[str, torch.Tensor] = {}
        aux: Dict[str, Any] = {}

        def placed(domain):
            """The context of a domain's work: this rank's images, or (at
            the step's own level) its rows."""
            return spatial.images() if domain in by_images \
                else contextlib.nullcontext()

        source_size = tuple(batch["source"]["frames"].shape[2:4])
        target_size = tuple(batch["target"]["frames"].shape[2:4])
        with placed("source"):
            if "source" in by_images:
                source = spatial.place_images(batch["source"])
            else:
                with spatial.image(*source_size):
                    source = spatial.place_rows(batch["source"])
        source_images = _triplets(batch["source"]["frames"], mean, std)
        num_source = source_images[0].shape[0]

        # Frozen modules hold no parameter that requires a gradient, so
        # autograd records nothing through them.
        source_feats = None
        if student.depth_head is not None:
            # ---- depth over domains (algos/depth.py:507-595)
            with placed("source"):
                source_dom = depth_domain(student, source_images,
                                          batch["source"]["camera"], noise)
            # The frame-t pyramid of the source triplets serves the
            # panoptic losses too, unless it came out of the flow path's
            # 3B pass through a train-mode encoder: the JAX package's
            # separate pass over frame t has its own batch statistics.
            if not (use_flow and student.backbone_po_depth.training):
                source_feats = source_dom["feats"]
            domains = [(source_dom, float(num_source))]

            target = batch["target"]
            nt = target["frames"].shape[0]
            # With a flow head, target and replay take separate passes
            # (adapt.py:514): separate pose-net batches and auto-mask means.
            merge_tr = merges(student, batch)
            if merge_tr:
                # Target and target replay: ONE batch through the pose
                # net's train-mode BatchNorm, per-sample loss reduction,
                # split by domain (adapt.py:514-548).
                frames = torch.cat([target["frames"],
                                    batch["target_replay"]["frames"]])
                camera = torch.cat([target["camera"],
                                    batch["target_replay"]["camera"]])
                if "target_replay" in by_images:
                    target_dom, replay_dom, transforms, target_feats, \
                        target_depth = split_merged(
                            student, _triplets(frames, mean, std), camera,
                            nt, noise)
                else:
                    merged = depth_domain(student,
                                          _triplets(frames, mean, std),
                                          camera, noise, per_sample=True)
                    target_dom = {key: merged[key][:nt].mean()
                                  for key in ("recon", "smth")}
                    replay_dom = {key: merged[key][nt:].mean()
                                  for key in ("recon", "smth")}
                    transforms = merged["transformations"]
                    target_feats = [f[:nt] for f in merged["feats"]]
                    target_depth = merged["depth"][:nt]
                transforms_t = [t[:nt] for t in transforms]
            else:
                target_dom = depth_domain(
                    student, _triplets(target["frames"], mean, std),
                    target["camera"], noise)
                transforms_t = target_dom["transformations"]
                target_feats = target_dom["feats"]
                target_depth = target_dom["depth"]
                if use_flow:
                    # the student's target motion pair, for the motion
                    # panel (adapt.py:555-560)
                    aux["object_motion_map"] = torch.stack(
                        [_nhwc(m) for m in target_dom["motion"]]).detach()
            # Non-moving-frame check on this forward's poses: a skipped
            # target counts 0 images in the weighted average.
            dist = (torch.linalg.vector_norm(transforms_t[0][0, :3, 3])
                    + torch.linalg.vector_norm(
                        transforms_t[1][0, :3, 3])).detach() / 2.0
            skip = skip_decision(state.dist_buffer, state.dist_count, dist)
            aux["dist"] = dist
            aux["target_skipped"] = skip
            domains.append((target_dom,
                            torch.where(skip, 0.0, float(nt))))
            if has_replay:
                if not merge_tr:
                    replay = batch["target_replay"]
                    with placed("target_replay"):
                        replay_dom = depth_domain(
                            student, _triplets(replay["frames"], mean, std),
                            replay["camera"], noise)
                domains.append(
                    (replay_dom,
                     float(batch["target_replay"]["frames"].shape[0])))
            total_images = sum(c for _, c in domains)
            losses["depth_recon"] = sum(
                d["recon"] * c for d, c in domains) / total_images
            losses["depth_smth"] = sum(
                d["smth"] * c for d, c in domains) / total_images
            if use_flow:
                losses["flow_smth"] = sum(
                    d["flow"][0] * c for d, c in domains) / total_images
                losses["flow_sparsity"] = sum(
                    d["flow"][1] * c for d, c in domains) / total_images
        else:
            with spatial.image(*target_size):
                target_feats = apply_encoder(
                    student.backbone_po_depth, maybe_normalize(
                        spatial.rows_of(batch["target"]["frames"][:, 0],
                                        axis=1), mean, std))
            target_depth = None

        if reuse_feats:
            aux["eval_feats"] = [f.detach() for f in target_feats]
            if reuse_depth and target_depth is not None:
                aux["eval_depth"] = target_depth.detach()

        # ---- source supervised panoptic
        with placed("source"), spatial.image(*source_size):
            if source_feats is None:
                source_feats = student.backbone_po_depth(spatial.rows_of(
                    spatial.images_of(source_images[0])))
        if student.semantic_head is not None:
            semantic_losses(state, batch, source, source_feats, losses,
                            placed, by_images)
        if student.instance_head is not None:
            with placed("source"), spatial.image(*source_size):
                center_src, offset_src, thing_mask_src = \
                    student.instance_head(source_feats)
                losses["center_source"] = center_loss(_nhwc(center_src),
                                                      source["center"])
                losses["offset_source"] = offset_loss(_nhwc(offset_src),
                                                      source["offset"])
                if thing_mask_src is not None \
                        and source.get("thing_mask") is not None:
                    losses["thing_mask_source"] = binary_mask_loss(
                        thing_mask_src, source["thing_mask"])
        if student.instance_head is not None \
                and "instance_head" in state.ema_modules \
                and batch["target"].get("center_ema") is not None:
            with spatial.image(*target_size):
                target_rows = spatial.place_rows(batch["target"])
                center_t, offset_t, _ = student.instance_head(target_feats)
                losses["center_ema"] = ema_consistency_loss(
                    _nhwc(center_t), target_rows["center_ema"])
                losses["offset_ema"] = ema_consistency_loss(
                    _nhwc(offset_t), target_rows["offset_ema"])

        total = torch.zeros((), device=state.device)
        for key, value in losses.items():
            weight = weights.get(key)
            if weight is not None:
                total = total + weight * value

        # Replay-buffer features: the target frame's last-stage features,
        # mean-pooled and L2-normalized (adapt.py:756-765).
        with spatial.image(*target_size):
            pooled = spatial.gather_rows(target_feats[-1].detach()).float() \
                .mean(dim=(2, 3))
        aux["image_features"] = pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=1, keepdim=True),
            min=1e-12)
        return total, losses, aux

    graphs = StepGraphs()

    def adapt_step(state: AdaptState, batch, noise=None):
        with trace.span("step.forward"):
            student = state.student
            frozen = state.frozen_modules
            batch = batch_to_device(dict(batch), state.device)
            reuse_feats = (eval_forward is not None
                           and "backbone_po_depth" in frozen)
            reuse_depth = (reuse_feats and student.depth_head is not None
                           and "depth_head" not in state.ema_modules)
            for name in student.module_names():
                getattr(student, name).train(name not in frozen)
            # the side domains this rank holds by images
            by_images = set()
            if spatial.hybrid_active():
                by_images = {domain for domain, how in
                             spatial.hybrid_placement(
                                 batch, parallel.world_size()).items()
                             if how == "images"}
                if student.backbone_po_depth.training and merges(student,
                                                                 batch):
                    # one pass of the live encoder's train-mode BatchNorm
                    # over target and replay: both by rows
                    by_images.discard("target_replay")
            if spatial.active():
                _check_row_split(batch, by_images)

            graphed = graphs.engages(state, noise)
            if noise is None:
                def noise(shape):
                    return torch.randn(shape, generator=state.generator,
                                       device=state.device)

            def forward(batch):
                return loss_fn(state, batch, noise, reuse_feats, reuse_depth,
                               by_images)

            if graphed:
                # the backward too: the gradients are in place on return
                total, losses, aux = graphs.run(state, batch, forward)
            else:
                count_step(eager=1)
                state.optimizer.zero_grad(set_to_none=True)
                total, losses, aux = forward(batch)
        with trace.span("step.backward"):
            if not graphed:
                total.backward()
            if spatial.active():
                # each rank's loss is its rows' or images' share: the sum
                # is the gradient
                parallel.sum_gradients(student.parameters())

        eval_out = None
        if eval_forward is not None:
            with trace.span("step.eval"):
                # The teacher eval reads the weights from before the update.
                student.eval()
                eval_batch = {"frames": batch["target"]["frames"],
                              **batch.get("eval_gt", {})}
                if reuse_feats:
                    view = types.SimpleNamespace(**{
                        name: getattr(state.teacher
                                      if name in state.ema_modules
                                      else student, name)
                        for name in MODULE_NAMES})
                    eval_out = eval_forward(view, eval_batch,
                                            feats=aux["eval_feats"],
                                            depth=aux.get("eval_depth"))
                else:
                    eval_out = eval_forward(state.teacher, eval_batch)

        with trace.span("step.update"):
            if student.depth_head is not None:
                skip = aux["target_skipped"]
                push_ring_buffer(state.dist_buffer, state.dist_count,
                                 state.dist_head, aux["dist"], skip)
            else:
                skip = torch.zeros((), dtype=torch.bool, device=state.device)

            with trace.span("step.optimizer"):
                set_learning_rate(state.optimizer,
                                  state.schedule(state.step))
                state.optimizer.step()
            with trace.span("step.ema"), torch.no_grad():
                _blend_ema(state, bool(batch.get("do_ema", True)))
            state.step += 1

            values = {"loss_total": total.detach(),
                      **{k: v.detach() for k, v in losses.items()}}
            if spatial.active():
                # the shares of the ranks add up to the global values
                values = dict(zip(values, parallel.all_reduce(
                    torch.stack(list(values.values()))).unbind()))
            metrics = {"loss_total": values.pop("loss_total"),
                       "target_skipped": skip, **values}
            if eval_forward is not None:
                results = eval_out[0]
                if results is not None and "object_motion_map" in aux:
                    # (2, B, H, W, 3), the pair [-flow(t-1, t),
                    # flow(t, t+1)]
                    results["object_motion_map"] = aux["object_motion_map"]
                return metrics, aux["image_features"], results, eval_out[1]
            return metrics, aux["image_features"]

    return adapt_step
