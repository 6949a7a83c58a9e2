"""Cross-domain mixup of pseudo-labelled target data into source frames.

Counterpart of ``codeps_tpu/data/mixup.py``:

  - ``Mixup.cut_mixup``: ``nof_segments`` random cells of a grid over the
    target replace the source's pixels; each cell ends one pixel short of
    the next (the reference's one-pixel seams);
  - ``Mixup.class_mixup``: a random half of the source's classes keep
    their pixels, the rest come from the target;
  - ``Mixup.conf_instance_mixup``: whole target instances are pasted at
    the source column farthest from the source's things (kornia's
    distance transform on one row); a later instance crops an earlier one
    where they overlap. With a ``thing_list`` the warped pseudo instance
    map is first re-fused at ``conf_thresh`` (``refuse_instances``), which
    renumbers the ids and so sets the paste order;
  - ``Mixup.do_mixup``: pseudo instance labels by panoptic fusion of the
    teacher's predictions, the optional camera-to-camera warp
    (``warp_c2c``), then one strategy.

Arrays are channel-last and unbatched. The composition is numpy on the
host; the fusions run on the ``device`` the caller names (on a card, the
grouping kernel) and only their instance maps come back to the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from codeps_torch.data.dataset import get_offset_center
from codeps_torch.device import resolve_device
from codeps_torch.ops.grid_sample import grid_sample
from codeps_torch.ops.panoptic import get_panoptic_segmentation


def kornia_dist_row(mask: np.ndarray, row: int) -> np.ndarray:
    """Row ``row`` of ``kornia.contrib.distance_transform(mask)``, exactly
    and in float64 (``codeps_tpu/data/mixup.py:36-98``).

    kornia grows the reached set by one 3x3 dilation an iteration, so a
    pixel p is reached at iteration cheb(p) - 1, cheb being its Chebyshev
    distance to the mask, and gets

        (cheb(p) - 1) - h * log(sum over its 3x3 taps q of
                                exp(-hypot(dy, dx) / h) * [cheb(q) < cheb(p)])

    with h = 0.35 and the taps clamped at the border. The Chebyshev
    distances come from a (W, W) lower envelope per needed row. Mask
    pixels and an all-zero mask give 0, as in kornia.
    """
    height, width = mask.shape
    if not (mask > 0).any():
        return np.zeros(width, np.float64)
    binary = mask > 0
    rows = np.arange(height, dtype=np.float64)[:, None]
    cols = np.arange(width, dtype=np.float64)
    col_gap = np.abs(cols[:, None] - cols[None, :])

    def cheb_row(y: int) -> np.ndarray:
        # cheb[y, x] = min_j max(|x - j|, min over mask rows r of col j
        # of |r - y|)
        gcol = np.where(binary, np.abs(rows - float(y)), np.inf).min(axis=0)
        return np.maximum(col_gap, gcol[None, :]).min(axis=1)

    r0 = cheb_row(row)
    cheb3 = np.stack([cheb_row(max(row - 1, 0)), r0,
                      cheb_row(min(row + 1, height - 1))])
    h = 0.35
    w_axis = math.exp(-1.0 / h)
    w_diag = math.exp(-math.hypot(1.0, 1.0) / h)
    conv = np.zeros(width, np.float64)
    for dy in (-1, 0, 1):
        src = cheb3[dy + 1]
        for dx, weight in ((-1, w_diag if dy else w_axis),
                           (0, 1.0 if dy == 0 else w_axis),
                           (1, w_diag if dy else w_axis)):
            if dy == 0 and dx == 0:
                continue  # p is never in its own reached set
            qx = np.clip(np.arange(width) + dx, 0, width - 1)
            conv += weight * (src[qx] < r0)
    with np.errstate(divide="ignore"):
        cdt = -h * np.log(conv)
    return np.where(r0 > 0, (r0 - 1.0) + cdt, 0.0)


def distance_transform_manhattan(mask: np.ndarray) -> np.ndarray:
    """Manhattan distance to the nearest non-zero pixel, exact, float32
    (``codeps_tpu/data/mixup.py:101``); an all-zero mask gives H + W.
    Separable min-plus: two ``minimum.accumulate`` scans per axis."""
    height, width = mask.shape
    d = np.where(mask > 0, 0, height + width).astype(np.int32)
    ri = np.arange(height, dtype=np.int32)[:, None]
    down = np.minimum.accumulate(d - ri, axis=0) + ri
    up = np.minimum.accumulate((d + ri)[::-1], axis=0)[::-1] - ri
    d = np.minimum(down, up)
    ci = np.arange(width, dtype=np.int32)[None, :]
    left = np.minimum.accumulate(d - ci, axis=1) + ci
    right = np.minimum.accumulate((d + ci)[:, ::-1], axis=1)[:, ::-1] - ci
    return np.minimum(left, right).astype(np.float32)


def warp_c2c(intr_src, intr_tgt, in_src: np.ndarray, out_shape,
             depth_val: float = 1.0, interp_mode: str = "bilinear",
             padding_mode: str = "border", device=None) -> np.ndarray:
    """Camera-to-camera warp by unit-depth reprojection
    (``codeps_tpu/data/mixup.py:131-170``): the ``out_shape`` (H, W)
    lattice is backprojected at ``depth_val`` through ``intr_tgt``,
    projected through ``intr_src``, and ``in_src`` ((H_s, W_s) or (H_s,
    W_s, C)) is sampled there on ``device``. The grid is float32 numpy,
    as the JAX package builds it."""
    squeeze = in_src.ndim == 2
    if squeeze:
        in_src = in_src[..., None]
    h_out, w_out = out_shape
    h_src, w_src = in_src.shape[:2]
    fx_t, fy_t, cx_t, cy_t = [float(v) for v in np.asarray(intr_tgt)]
    fx_s, fy_s, cx_s, cy_s = [float(v) for v in np.asarray(intr_src)]

    u = np.arange(w_out, dtype=np.float32)[None, :]
    v = np.arange(h_out, dtype=np.float32)[:, None]
    x3d = depth_val * (u - cx_t) / fx_t
    y3d = depth_val * (v - cy_t) / fy_t
    z3d = max(depth_val, 1e-5)
    u2d = x3d / z3d * fx_s + cx_s
    v2d = y3d / z3d * fy_s + cy_s
    u2d = np.broadcast_to(u2d, (h_out, w_out))
    v2d = np.broadcast_to(v2d, (h_out, w_out))
    grid = np.stack([(u2d / (w_src - 1) - 0.5) * 2.0,
                     (v2d / (h_src - 1) - 0.5) * 2.0], axis=-1)

    device = resolve_device(device)
    image = torch.from_numpy(np.ascontiguousarray(
        in_src, np.float32).transpose(2, 0, 1)[None]).to(device)
    out = grid_sample(image, torch.from_numpy(
        grid.astype(np.float32)[None]).to(device), mode=interp_mode,
        padding_mode=padding_mode)
    out = out[0].permute(1, 2, 0).cpu().numpy()
    return out[..., 0] if squeeze else out


def _fuse_on(device, semantic, center, offset, thing_list, num_classes,
             **kwargs) -> np.ndarray:
    """The instance map (H, W) int32 of one fusion on ``device`` of host
    labels (H, W), a center heatmap (H, W) and offsets (H, W, 2). The
    offsets go up as (2, H, W) planes, which the grouping kernel reads in
    place; the instance map comes back to the host."""
    planes = torch.from_numpy(np.ascontiguousarray(
        np.asarray(offset, np.float32).transpose(2, 0, 1))).to(device)
    _, instance, _ = get_panoptic_segmentation(
        torch.from_numpy(np.asarray(semantic, np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(center, np.float32)).to(
            device), planes.permute(1, 2, 0), tuple(thing_list),
        num_classes=num_classes, do_merge=False, **kwargs)
    return instance.cpu().numpy()


def refuse_instances(instance_map, semantic, thing_list, num_classes: int,
                     conf_thresh: float, device) -> np.ndarray:
    """``instance_map`` re-fused at ``conf_thresh``
    (``codeps_tpu/data/mixup.py:250-258``): the exact center heatmap and
    offsets of the map (``get_offset_center``, every instance a peak of
    1.0) go through panoptic fusion with ``semantic``'s thing mask, so the
    ids come back in the raster order of the surviving centers."""
    offset, center = get_offset_center(np.asarray(instance_map, np.int32))
    return _fuse_on(device, semantic, center[..., 0], offset, thing_list,
                    num_classes, threshold=float(conf_thresh))


class Mixup:
    """Mixup composition of single unbatched samples."""

    @staticmethod
    def cut_mixup(rng: np.random.Generator, img_src, img_tgt, instance_src,
                  semantic_src, semantic_pred_tgt, instance_pred_tgt,
                  nof_vert_splits: int, nof_hor_splits: int,
                  nof_segments: int):
        """Grid-cell paste (``codeps_tpu/data/mixup.py:179``); a cell's
        slices end at ``(k+1)*crop - 1`` exclusive, a one-pixel seam."""
        height, width = img_tgt.shape[:2]
        nof_splits = nof_vert_splits * nof_hor_splits
        crop_h = height // nof_vert_splits
        crop_w = width // nof_hor_splits

        mask = np.zeros((height, width), bool)
        for split_id in rng.choice(nof_splits, nof_segments, replace=False):
            mul_x = split_id % nof_hor_splits
            mul_y = split_id // nof_hor_splits
            mask[mul_y * crop_h:(mul_y + 1) * crop_h - 1,
                 mul_x * crop_w:(mul_x + 1) * crop_w - 1] = True
        return Mixup._paste(mask, img_src, img_tgt, instance_src,
                            semantic_src, semantic_pred_tgt,
                            instance_pred_tgt)

    @staticmethod
    def class_mixup(rng: np.random.Generator, img_src, img_tgt,
                    instance_src, semantic_src, semantic_pred_tgt,
                    instance_pred_tgt):
        """A random half (rounded up) of the source's classes replaced by
        the target (``codeps_tpu/data/mixup.py:210``)."""
        all_classes = np.unique(semantic_src)
        num = all_classes.shape[0]
        chosen = all_classes[rng.choice(num, (num + num % 2) // 2,
                                        replace=False)]
        return Mixup._paste(np.isin(semantic_src, chosen), img_src, img_tgt,
                            instance_src, semantic_src, semantic_pred_tgt,
                            instance_pred_tgt)

    @staticmethod
    def _paste(mask, img_src, img_tgt, instance_src, semantic_src,
               semantic_pred_tgt, instance_pred_tgt):
        rgb = img_src.astype(np.float32).copy()
        rgb[mask] = img_tgt[mask].astype(np.float32)
        semantic = semantic_src.copy()
        semantic[mask] = semantic_pred_tgt[mask]
        instance = instance_src.astype(np.int32).copy()
        instance[mask] = instance_pred_tgt[mask].astype(np.int32)
        return rgb, semantic, instance

    @staticmethod
    def conf_instance_mixup(img_src, img_tgt, instance_src, semantic_src,
                            semantic_pred_tgt, instance_pred_tgt,
                            min_inst_size: int, thing_list=None,
                            num_classes: int = 14,
                            conf_thresh: float = 0.0, device=None,
                            stats: Optional[Dict[str, int]] = None):
        """Paste whole target instances at the source column with the
        largest distance to the source's things
        (``codeps_tpu/data/mixup.py:230-335``); on overlap the new
        instance wins and the earlier one is cropped.

        With ``thing_list`` the pseudo instance map is first re-fused at
        ``conf_thresh`` on ``device`` (``refuse_instances``). ``stats``,
        when given, receives the number of pasted instances and of
        conflicts resolved."""
        if thing_list is not None:
            instance_pred_tgt = refuse_instances(
                instance_pred_tgt, semantic_pred_tgt, thing_list,
                num_classes, conf_thresh, resolve_device(device))
        height, width = semantic_pred_tgt.shape
        thing_msk = (instance_src != 0).astype(np.float32)

        rgb = img_src.astype(np.float32).copy()
        semantic = semantic_src.copy()
        instance = instance_src.astype(np.int32).copy()

        msk_src_accum = np.zeros((height, width), np.int32)
        instance_id_mask = np.zeros((height, width), np.int32)
        pasted = []  # (conf_id, source pixels, target pixels)
        conflicts = 0

        for conf_id in np.unique(instance_pred_tgt):
            conf_id = int(conf_id)
            if conf_id == 0:
                continue
            inst_mask = instance_pred_tgt == conf_id
            if inst_mask.sum() < min_inst_size:
                continue
            idxs_tgt = np.argwhere(inst_mask)
            center = np.round(idxs_tgt.astype(np.float64).mean(0)).astype(int)

            offset_x = int(np.argmax(kornia_dist_row(thing_msk,
                                                     int(center[0])))) \
                - center[1]
            idxs_src = idxs_tgt.copy()
            idxs_src[:, 1] += offset_x
            min_x = idxs_src[:, 1].min()
            max_x = idxs_src[:, 1].max()
            if min_x < 0:
                idxs_src[:, 1] -= min_x
                offset_x -= min_x
            if max_x > width - 1:
                idxs_src[:, 1] -= max_x - (width - 1)
                offset_x -= max_x - (width - 1)

            msk_src_accum[idxs_src[:, 0], idxs_src[:, 1]] += 1
            if np.any(msk_src_accum > 1):
                conflicts += 1
                for conflicting in np.unique(
                        instance_id_mask[msk_src_accum > 1]):
                    if conflicting == 0:
                        continue
                    conflict_idx = np.argwhere(
                        (msk_src_accum > 1)
                        & (instance_id_mask == conflicting))
                    tgt_idx = conflict_idx.copy()
                    tgt_idx[:, 1] -= offset_x
                    valid = (tgt_idx[:, 1] >= 0) & (tgt_idx[:, 1] < width)
                    inst_mask[tgt_idx[valid, 0], tgt_idx[valid, 1]] = False
                surviving = (msk_src_accum == 1) & (instance_id_mask == 0)
                instance_id_mask[surviving] = conf_id
            else:
                instance_id_mask[idxs_src[:, 0], idxs_src[:, 1]] = conf_id
            msk_src_accum = np.clip(msk_src_accum, 0, 1)

            src_idx = np.argwhere(instance_id_mask == conf_id)
            tgt_idx = src_idx.copy()
            tgt_idx[:, 1] -= offset_x
            valid = (tgt_idx[:, 1] >= 0) & (tgt_idx[:, 1] < width)
            src_idx, tgt_idx = src_idx[valid], tgt_idx[valid]
            pasted.append((src_idx, tgt_idx))
            thing_msk[src_idx[:, 0], src_idx[:, 1]] = 1

        for src_idx, tgt_idx in pasted:
            rgb[src_idx[:, 0], src_idx[:, 1]] = \
                img_tgt[tgt_idx[:, 0], tgt_idx[:, 1]].astype(np.float32)
            semantic[src_idx[:, 0], src_idx[:, 1]] = \
                semantic_pred_tgt[tgt_idx[:, 0], tgt_idx[:, 1]]
            instance[src_idx[:, 0], src_idx[:, 1]] = \
                instance_pred_tgt[tgt_idx[:, 0], tgt_idx[:, 1]].astype(
                    np.int32)
        if stats is not None:
            stats["pasted"] = len(pasted)
            stats["conflicts"] = conflicts
        return rgb, semantic, instance

    @staticmethod
    def do_mixup(mixup_strategy: str, mixup_data: Dict[str, Any],
                 thing_list, cfg_mixup,
                 rng: Optional[np.random.Generator] = None,
                 num_classes: int = 14, get_off_cen: bool = True,
                 device=None) -> Dict[str, Any]:
        """One mixup sample from its raw materials and the teacher's
        predictions (``codeps_tpu/data/mixup.py:340-429``). ``mixup_data``
        holds rgb_src/rgb_tgt {0: (H, W, 3)}, semantic_src, instance_src,
        camera_model_src/tgt (4,), semantic_pred_tgt_ema (H, W) labels,
        center_pred_tgt_ema (H, W, 1) and offset_pred_tgt_ema (H, W, 2).
        The fusions and the warp run on ``device``."""
        device = resolve_device(device)
        if rng is None:
            rng = np.random.default_rng()
        strategy = mixup_strategy.split("/")[-1]
        for suffix in ("cut_mixup", "class_mixup", "conf_instance_mixup"):
            if mixup_strategy.endswith(suffix):
                strategy = suffix

        img_src = np.asarray(mixup_data["rgb_src"][0], np.float32)
        img_tgt = np.asarray(mixup_data["rgb_tgt"][0], np.float32)
        semantic_src = np.asarray(mixup_data["semantic_src"])
        instance_src = np.asarray(mixup_data["instance_src"])
        semantic_pred = np.asarray(mixup_data["semantic_pred_tgt_ema"])
        center_pred = np.asarray(mixup_data["center_pred_tgt_ema"])
        offset_pred = np.asarray(mixup_data["offset_pred_tgt_ema"])

        # the teacher's pseudo instance labels (mixup.py:415-417)
        instance_pred = _fuse_on(device, semantic_pred, center_pred[..., 0],
                                 offset_pred, thing_list, num_classes)

        if cfg_mixup.general.geom_augment:
            intr_src = np.asarray(mixup_data["camera_model_src"])
            intr_tgt = np.asarray(mixup_data["camera_model_tgt"])
            out_shape = img_src.shape[:2]
            img_tgt = warp_c2c(intr_tgt, intr_src, img_tgt, out_shape,
                               interp_mode="bilinear", padding_mode="zeros",
                               device=device)
            instance_pred = warp_c2c(
                intr_tgt, intr_src, instance_pred.astype(np.float32),
                out_shape, interp_mode="nearest", padding_mode="zeros",
                device=device).astype(instance_pred.dtype)
            semantic_pred = warp_c2c(
                intr_tgt, intr_src, semantic_pred.astype(np.float32),
                out_shape, interp_mode="nearest", padding_mode="border",
                device=device).astype(semantic_pred.dtype)

        if strategy == "class_mixup":
            rgb, semantic, instance = Mixup.class_mixup(
                rng, img_src, img_tgt, instance_src, semantic_src,
                semantic_pred, instance_pred)
        elif strategy == "cut_mixup":
            rgb, semantic, instance = Mixup.cut_mixup(
                rng, img_src, img_tgt, instance_src, semantic_src,
                semantic_pred, instance_pred,
                cfg_mixup.cut_mix.nof_vert_splits,
                cfg_mixup.cut_mix.nof_hor_splits,
                cfg_mixup.cut_mix.nof_segments)
        elif strategy == "conf_instance_mixup":
            rgb, semantic, instance = Mixup.conf_instance_mixup(
                img_src, img_tgt, instance_src, semantic_src,
                semantic_pred, instance_pred,
                cfg_mixup.conf_instance_mix.min_inst_size,
                thing_list=thing_list, num_classes=num_classes,
                conf_thresh=cfg_mixup.conf_instance_mix.conf_thresh,
                device=device)
        else:
            raise NotImplementedError(
                f"Mixup strategy not implemented: {mixup_strategy}")

        out = {"rgb": {0: rgb}, "camera_model": mixup_data["camera_model_src"],
               "semantic": semantic, "instance": instance}
        if get_off_cen:
            # no adaptation loss reads these (the runner passes False)
            out["offset"], out["center"] = get_offset_center(instance)
        return out
