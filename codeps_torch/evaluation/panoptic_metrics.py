"""Panoptic Quality (PQ) on the host (numpy).

Counterpart of ``codeps_tpu/evaluation/panoptic_metrics.py``: COCO-style
matching through the gt * OFFSET + pred unique-count trick, a match at
IoU > 0.5, and predicted segments mostly on void not counted as false
positives. The runner calls it once per frame on the maps it fetched.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

_OFFSET = 256 * 256 * 256


class PQStatCat:
    __slots__ = ("iou", "tp", "fp", "fn")

    def __init__(self):
        self.iou = 0.0
        self.tp = 0
        self.fp = 0
        self.fn = 0

    def __iadd__(self, other: "PQStatCat") -> "PQStatCat":
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


class PQStat:
    """Accumulator over categories."""

    def __init__(self):
        self.pq_per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def __getitem__(self, cat: int) -> PQStatCat:
        return self.pq_per_cat[cat]

    def __iadd__(self, other: "PQStat") -> "PQStat":
        for label, stat in other.pq_per_cat.items():
            self.pq_per_cat[label] += stat
        return self

    def pq_average(self, categories: List[int]):
        pq = sq = rq = 0.0
        n = 0
        per_class = {}
        for label in categories:
            stat = self.pq_per_cat[label]
            denom = stat.tp + 0.5 * stat.fp + 0.5 * stat.fn
            if denom == 0:
                per_class[label] = {"pq": 0.0, "sq": 0.0, "rq": 0.0}
                continue
            n += 1
            pq_c = stat.iou / denom
            sq_c = stat.iou / stat.tp if stat.tp != 0 else 0.0
            rq_c = stat.tp / denom
            per_class[label] = {"pq": pq_c, "sq": sq_c, "rq": rq_c}
            pq += pq_c
            sq += sq_c
            rq += rq_c
        if n == 0:
            return {"pq": 0, "sq": 0, "rq": 0, "n": n}, per_class
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}, per_class


def compute_panoptic_stats(pan_gt: np.ndarray, pan_pred: np.ndarray,
                           void_label: int = -1,
                           label_divisor: int = 1000) -> PQStat:
    """PQ statistics of a batch (or one) of panoptic id maps."""
    pq_stat = PQStat()
    pan_gt = np.asarray(pan_gt)
    pan_pred = np.asarray(pan_pred)
    if pan_gt.ndim == 2:
        pan_gt = pan_gt[None]
        pan_pred = pan_pred[None]

    for b in range(pan_gt.shape[0]):
        gt = pan_gt[b].astype(np.int64)
        pred = pan_pred[b].astype(np.int64)

        gt_ids, gt_areas = np.unique(gt, return_counts=True)
        pred_ids, pred_areas = np.unique(pred, return_counts=True)
        gt_segms = {int(i): int(a) for i, a in zip(gt_ids, gt_areas)
                    if i != void_label}
        pred_segms = {int(i): int(a) for i, a in zip(pred_ids, pred_areas)
                      if i != void_label}

        # intersection table through the OFFSET trick; a positive
        # stand-in for the void label keeps the combined key ordered
        tmp_void = (max(gt_ids.max(initial=0), pred_ids.max(initial=0),
                        19 * label_divisor) + 1)
        gt_pos = np.where(gt == void_label, tmp_void, gt)
        pred_pos = np.where(pred == void_label, tmp_void, pred)
        combined = gt_pos * _OFFSET + pred_pos
        pairs, intersections = np.unique(combined, return_counts=True)
        gt_pred_map = {}
        for pair, intersection in zip(pairs, intersections):
            gt_id = int(pair // _OFFSET)
            pred_id = int(pair % _OFFSET)
            if gt_id == tmp_void:
                gt_id = void_label
            if pred_id == tmp_void:
                pred_id = void_label
            gt_pred_map[(gt_id, pred_id)] = int(intersection)

        gt_matched, pred_matched = set(), set()
        for (gt_id, pred_id), intersection in gt_pred_map.items():
            if gt_id == void_label or pred_id == void_label:
                continue
            gt_cat = gt_id // label_divisor
            pred_cat = pred_id // label_divisor
            if gt_cat != pred_cat:
                continue
            union = (pred_segms[pred_id] + gt_segms[gt_id] - intersection
                     - gt_pred_map.get((void_label, pred_id), 0))
            iou = intersection / union
            if iou > 0.5:
                pq_stat[gt_cat].tp += 1
                pq_stat[gt_cat].iou += iou
                gt_matched.add(gt_id)
                pred_matched.add(pred_id)

        for gt_id in gt_segms:
            if gt_id in gt_matched:
                continue
            pq_stat[gt_id // label_divisor].fn += 1

        for pred_id, area in pred_segms.items():
            if pred_id in pred_matched:
                continue
            intersection = gt_pred_map.get((void_label, pred_id), 0)
            if intersection / area > 0.5:
                continue
            pq_stat[pred_id // label_divisor].fp += 1
    return pq_stat


class PanopticEvaluator:
    """Streaming PQ accumulator."""

    def __init__(self, stuff_list: List[int], thing_list: List[int],
                 label_divisor: int = 1000, void_label: int = -1):
        self.stuff_list = list(stuff_list)
        self.thing_list = list(thing_list)
        self.label_divisor = label_divisor
        self.void_label = void_label
        self.pq_stats = PQStat()

    def update(self, pan_gt, pan_pred) -> None:
        self.pq_stats += compute_panoptic_stats(
            pan_gt, pan_pred, self.void_label, self.label_divisor)

    def evaluate(self) -> Dict[str, dict]:
        results = {
            "Things": self.pq_stats.pq_average(self.thing_list)[0],
            "Stuff": self.pq_stats.pq_average(self.stuff_list)[0],
        }
        all_list = self.stuff_list + self.thing_list
        results["All"], results["per_class"] = self.pq_stats.pq_average(
            all_list)
        return results

    def reset(self) -> None:
        self.pq_stats = PQStat()
