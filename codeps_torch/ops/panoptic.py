"""Panoptic post-processing (Panoptic-DeepLab fusion).

Counterpart of ``codeps_tpu/ops/panoptic.py:40-391``, written plainly for
PyTorch with the batch dimension written out where the JAX package uses
``vmap``. The rules are the JAX package's:

  - centers: threshold, max-pool NMS, then the survivors are the scores
    strictly above the k-th largest of the 0-sentineled score map, in
    raster order, padded to K = top_k with ``valid=False``;
  - instance id 0 = stuff/background; ids 1..K index the centers;
  - panoptic id = class * label_divisor + instance id, void = -1 (int32);
  - the majority vote breaks ties toward the smallest class id (the first
    maximum of ``argmax``), and instances are renumbered per class in
    ascending original id.

Nothing here waits for the device: the center compaction and the vote
counts are scatters, not boolean indexing.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from codeps_torch.ops.grouping import group_pixels
from codeps_torch.ops.topk import kth_largest


class Centers(NamedTuple):
    yx: torch.Tensor      # (..., K, 2) float32 center coordinates (y, x)
    score: torch.Tensor   # (..., K) heatmap score, -1 where invalid
    valid: torch.Tensor   # (..., K) bool


def find_instance_centers_batch(center_heatmap: torch.Tensor,
                                threshold: float = 0.1,
                                nms_kernel: int = 7,
                                top_k: int = 200) -> Centers:
    """Centers of a (B, H, W) heatmap batch: yx (B, K, 2), score and
    valid (B, K)."""
    batch, height, width = center_heatmap.shape
    hm = torch.where(center_heatmap > threshold, center_heatmap,
                     torch.tensor(-1.0, device=center_heatmap.device))
    pad = (nms_kernel - 1) // 2
    # max_pool2d pads with -inf, as reduce_window does in the JAX version.
    pooled = F.max_pool2d(hm[:, None], nms_kernel, stride=1,
                          padding=pad)[:, 0]
    keep = (hm == pooled) & (hm > 0)
    scores = torch.where(keep, hm, 0.0).reshape(batch, -1)

    t = kth_largest(scores, top_k)
    mask = scores > t[:, None]                     # at most top_k - 1 set
    # Raster-order compaction: survivor j goes to slot j, the others to a
    # spill slot top_k that is dropped.
    rank = torch.cumsum(mask, dim=1) - 1
    slot = torch.where(mask, rank, top_k)
    flat = torch.arange(scores.shape[1], device=scores.device)
    top_idx = torch.zeros((batch, top_k + 1), dtype=torch.int64,
                          device=scores.device)
    top_idx.scatter_(1, slot, flat.expand(batch, -1))
    top_idx = top_idx[:, :top_k]
    valid = (torch.arange(top_k, device=scores.device)[None, :]
             < mask.sum(dim=1, keepdim=True))
    top_idx = torch.where(valid, top_idx, 0)
    top_scores = torch.where(valid, torch.gather(scores, 1, top_idx), -1.0)
    yx = torch.stack([top_idx // width, top_idx % width], dim=-1).float()
    return Centers(yx=yx, score=top_scores, valid=valid)


def find_instance_centers(center_heatmap: torch.Tensor,
                          threshold: float = 0.1, nms_kernel: int = 7,
                          top_k: int = 200) -> Centers:
    """Centers of one (H, W) heatmap: yx (K, 2), score and valid (K,)."""
    centers = find_instance_centers_batch(center_heatmap[None], threshold,
                                          nms_kernel, top_k)
    return Centers(*(field[0] for field in centers))


def _thing_mask(semantic: torch.Tensor,
                thing_list: Sequence[int]) -> torch.Tensor:
    mask = torch.zeros_like(semantic, dtype=torch.bool)
    for thing_class in thing_list:
        mask |= semantic == thing_class
    return mask


def merge_semantic_and_instance_batch(semantic: torch.Tensor,
                                      instance: torch.Tensor,
                                      num_centers: int,
                                      thing_list: Sequence[int],
                                      label_divisor: int = 1000,
                                      stuff_area: int = 0,
                                      void_label: int = 255,
                                      num_classes: int | None = None
                                      ) -> torch.Tensor:
    """(B, H, W) int32 panoptic ids from semantic classes and instance ids
    in 0..num_centers, both (B, H, W)."""
    if num_classes is None:
        raise ValueError("num_classes is required")
    batch, height, width = semantic.shape
    device = semantic.device
    k1 = num_centers + 1
    semantic = semantic.long()
    pix_inst = instance.long()

    thing_seg = pix_inst > 0
    votes = _thing_mask(semantic, thing_list) & thing_seg
    # Void pixels get their own class slot C, never a valid class id.
    class_idx = torch.where(semantic == void_label, num_classes, semantic)
    num_slots = num_classes + 1

    # Majority vote: counts[b, inst, class] over the voting pixels.
    key = ((torch.arange(batch, device=device)[:, None, None] * k1
            + pix_inst) * num_slots + class_idx)
    counts = torch.zeros(batch * k1 * num_slots, dtype=torch.int64,
                         device=device)
    counts.scatter_add_(0, key.reshape(-1), votes.reshape(-1).long())
    counts = counts.reshape(batch, k1, num_slots)
    inst_exists = counts.sum(dim=2) > 0                      # (B, K+1)
    inst_class = counts.argmax(dim=2)                        # first max

    # Per-class renumbering: rank among existing instances of the same
    # class, in ascending original id.
    ids = torch.arange(k1, device=device)
    same_class = inst_class[:, None, :] == inst_class[:, :, None]
    earlier = (ids[None, :] <= ids[:, None])[None] & inst_exists[:, None, :]
    new_inst_id = (same_class & earlier).sum(dim=2)          # 1-based

    # Stuff area per class over the non-instance pixels.
    stuff_votes = ~thing_seg
    stuff_key = (torch.arange(batch, device=device)[:, None, None]
                 * num_slots + class_idx)
    stuff_counts = torch.zeros(batch * num_slots, dtype=torch.int64,
                               device=device)
    stuff_counts.scatter_add_(0, stuff_key.reshape(-1),
                              stuff_votes.reshape(-1).long())
    stuff_counts = stuff_counts.reshape(batch, num_slots)
    is_thing_class = torch.zeros(num_slots, dtype=torch.bool, device=device)
    is_thing_class[list(thing_list)] = True

    thing_pan = torch.gather(inst_class * label_divisor + new_inst_id, 1,
                             pix_inst.reshape(batch, -1))
    thing_valid = votes & torch.gather(
        inst_exists, 1, pix_inst.reshape(batch, -1)).reshape(
            batch, height, width)
    stuff_class_ok = (~is_thing_class)[None] & (stuff_counts >= stuff_area)
    stuff_ok = (torch.gather(stuff_class_ok, 1, class_idx.reshape(batch, -1))
                .reshape(batch, height, width)
                & (semantic != void_label) & stuff_votes)
    stuff_pan = torch.where(semantic == void_label, -1,
                            semantic * label_divisor)

    pan = torch.full((batch, height, width), -1, dtype=torch.int64,
                     device=device)
    pan = torch.where(stuff_ok, stuff_pan, pan)
    pan = torch.where(thing_valid, thing_pan.reshape(batch, height, width),
                      pan)
    return pan.to(torch.int32)


def merge_semantic_and_instance(semantic: torch.Tensor,
                                instance: torch.Tensor,
                                centers_valid: torch.Tensor,
                                thing_list: Sequence[int],
                                label_divisor: int = 1000,
                                stuff_area: int = 0,
                                void_label: int = 255,
                                num_classes: int | None = None
                                ) -> torch.Tensor:
    """One image: (H, W) semantic and instance maps -> (H, W) panoptic.
    ``centers_valid`` contributes only its length K, as in the JAX
    version; instance existence comes from the votes."""
    return merge_semantic_and_instance_batch(
        semantic[None], instance[None], centers_valid.shape[-1], thing_list,
        label_divisor, stuff_area, void_label, num_classes)[0]


def panoptic_fusion_batch(semantic_probs: torch.Tensor,
                          center: torch.Tensor, offsets: torch.Tensor,
                          thing_list: Sequence[int],
                          threshold: float = 0.1, nms_kernel: int = 7,
                          top_k: int = 200, label_divisor: int = 1000,
                          stuff_area: int = 0, void_label: int = 255,
                          thing_mask: torch.Tensor | None = None,
                          num_classes: int | None = None,
                          do_merge: bool = True):
    """Batched fusion.

    Args:
      semantic_probs: (B, H, W, C) probabilities, or (B, H, W) integer
        labels (then ``num_classes`` is required).
      center: (B, H, W, 1) heatmaps.
      offsets: (B, H, W, 2), channels (dy, dx).
      thing_mask: optional (B, H, W) binary, or the raw (B, H, W, 2)
        thing-mask head output (argmaxed).

    Returns:
      (panoptic (B, H, W) int32 or None, instance (B, H, W) int32,
       Centers with (B, K, ...) fields)
    """
    if semantic_probs.ndim == 4:
        semantic = semantic_probs.argmax(dim=-1)
        if num_classes is None:
            num_classes = semantic_probs.shape[-1]
    else:
        semantic = semantic_probs.long()
        if num_classes is None:
            raise ValueError("num_classes is required with integer labels")

    centers = find_instance_centers_batch(center[..., 0], threshold,
                                          nms_kernel, top_k)
    # the grouping reads float32 offsets (float64 ones of float64
    # modules are cast, their NCHW planes kept)
    raw_instance = group_pixels(centers.yx, centers.valid,
                                offsets.to(torch.float32))
    if thing_mask is not None:
        if thing_mask.ndim == 4:
            thing_mask = thing_mask.argmax(dim=-1)
        thing_seg = thing_mask.to(torch.int32)
    else:
        thing_seg = _thing_mask(semantic, thing_list).to(torch.int32)
    instance = thing_seg * raw_instance

    panoptic = None
    if do_merge:
        panoptic = merge_semantic_and_instance_batch(
            semantic, instance, top_k, thing_list, label_divisor,
            stuff_area, void_label, num_classes)
    return panoptic, instance, centers


def get_panoptic_segmentation(semantic_probs: torch.Tensor,
                              center_heatmap: torch.Tensor,
                              offsets: torch.Tensor,
                              thing_list: Sequence[int],
                              label_divisor: int = 1000,
                              stuff_area: int = 0,
                              void_label: int = 255,
                              threshold: float = 0.1,
                              nms_kernel: int = 7,
                              top_k: int = 200,
                              foreground_mask: torch.Tensor | None = None,
                              num_classes: int | None = None,
                              do_merge: bool = True):
    """Single-image fusion: semantic (H, W, C) probabilities or (H, W)
    labels, center heatmap (H, W), offsets (H, W, 2).

    Returns (panoptic (H, W) int32 or None, instance (H, W) int32,
    Centers with (K, ...) fields)."""
    fg = None if foreground_mask is None else foreground_mask[None]
    pan, inst, centers = panoptic_fusion_batch(
        semantic_probs[None], center_heatmap[None, ..., None], offsets[None],
        thing_list, threshold=threshold, nms_kernel=nms_kernel, top_k=top_k,
        label_divisor=label_divisor, stuff_area=stuff_area,
        void_label=void_label, thing_mask=fg, num_classes=num_classes,
        do_merge=do_merge)
    return (None if pan is None else pan[0], inst[0],
            Centers(*(field[0] for field in centers)))
