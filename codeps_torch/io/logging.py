"""Console and file logging, and an optional wandb sink.

Counterpart of ``codeps_tpu/io/logging.py``: Python logging to the console
and a file (``init_logging``), the ``log_iter`` console line, scalar,
image, panoptic-table and per-class depth logging to wandb behind an
availability check (``WandbLogger``, off when ``wandb`` is not installed)
and the ``Timer`` behind data and batch times. Metrics arrive as host
values.
"""

from __future__ import annotations

import importlib
import logging as _logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

from codeps_torch import parallel

_LOGGER = _logging.getLogger("codeps_torch")


def init_logging(log_dir: Optional[str] = None, debug: bool = False) -> None:
    """Console handler, and a ``run.log`` file handler under ``log_dir``
    on rank 0 of a process group (``parallel/dist.py``): the other ranks
    log to the console only, as one file shared by processes would
    interleave their lines."""
    _LOGGER.setLevel(_logging.DEBUG if debug else _logging.INFO)
    _LOGGER.propagate = False  # no second line through the root logger
    _LOGGER.handlers.clear()
    console = _logging.StreamHandler(sys.stdout)
    console.setFormatter(_logging.Formatter(
        "%(asctime)s %(levelname)s: %(message)s", "%H:%M:%S"))
    _LOGGER.addHandler(console)
    if log_dir is not None and parallel.is_lead():
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        handler = _logging.FileHandler(str(Path(log_dir) / "run.log"))
        handler.setFormatter(_logging.Formatter(
            "%(asctime)s %(levelname)s: %(message)s"))
        _LOGGER.addHandler(handler)


def log_info(message: str, *args, **kwargs) -> None:
    _LOGGER.info(message, *args, **kwargs)


def log_iter(step: int, total_steps: int, metrics: Dict[str, Any],
             prefix: str = "train", lr: Optional[float] = None,
             elapsed: Optional[float] = None) -> None:
    """One console line per log interval."""
    parts = [f"[{prefix}] {step}/{total_steps}"]
    if lr is not None:
        parts.append(f"lr={lr:.6f}")
    for key, value in metrics.items():
        try:
            parts.append(f"{key}={float(value):.4f}")
        except (TypeError, ValueError):
            continue
    if elapsed is not None:
        parts.append(f"{elapsed:.2f}s/it")
    _LOGGER.info(" ".join(parts))


def _id2name(remove_classes, label_mode: str) -> Dict[int, str]:
    from codeps_torch.data.labels import get_labels
    return {label.trainId: label.name
            for label in get_labels(remove_classes, label_mode)}


class WandbLogger:
    """A thin wandb sink; every method does nothing unless ``enabled`` was
    asked for, ``wandb`` imports and this process is rank 0 of its process
    group (``parallel/dist.py``), if it is in one."""

    def __init__(self, project: Optional[str] = None,
                 entity: Optional[str] = None,
                 run_name: Optional[str] = None, enabled: bool = False,
                 config: Optional[dict] = None):
        self._wandb = None
        if enabled and parallel.is_lead():
            try:
                self._wandb = importlib.import_module("wandb")
            except ImportError:
                pass
        self.enabled = self._wandb is not None
        self.run = None
        self._depth_series: Dict = {}
        if self.enabled:
            self.run = self._wandb.init(project=project, entity=entity,
                                        name=run_name, config=config)

    def log_scalars(self, mode: str, losses: Optional[Dict] = None,
                    metrics: Optional[Dict] = None, step: int = 0) -> None:
        if not self.enabled:
            return
        payload = {}
        for group, values in (("losses", losses), ("metrics", metrics)):
            for key, value in (values or {}).items():
                try:
                    payload[f"{mode}_{group}/{key}"] = float(value)
                except (TypeError, ValueError):
                    continue
        self.run.log(payload, step=step)

    def log_images(self, prefix: str, images: Dict[str, Any],
                   step: int = 0) -> None:
        if not self.enabled:
            return
        self.run.log({f"{prefix}/{k}": self._wandb.Image(v)
                      for k, v in images.items()}, step=step)

    def log_panoptic_table(self, mode: str, panoptic_scores: Dict,
                           remove_classes, label_mode: str,
                           step: int = 0) -> None:
        """Per-class PQ/SQ/RQ table."""
        if not self.enabled:
            return
        id2name = _id2name(remove_classes, label_mode)
        columns, pq, sq, rq = [""], ["PQ"], ["SQ"], ["RQ"]
        for category, scores in panoptic_scores.get("per_class",
                                                    {}).items():
            columns.append(id2name.get(category, str(category)))
            pq.append(scores["pq"])
            sq.append(scores["sq"])
            rq.append(scores["rq"])
        table = self._wandb.Table(data=[pq, sq, rq], columns=columns)
        self.run.log({f"{mode}_metrics/panoptic": table}, step=step)

    def log_depth_per_class(self, metrics: Dict[str, float],
                            remove_classes, label_mode: str,
                            step: int = 0) -> None:
        """Line series of the per-class depth metrics ``d_<metric>_c<i>``,
        accumulated across calls and keyed by class name. A step logged
        twice replaces its point; a class that appears late is back-filled
        with its first value, so every series stays as long as the steps."""
        if not self.enabled:
            return
        id2name = _id2name(remove_classes, label_mode)
        series = self._depth_series
        for key, value in metrics.items():
            if not key.startswith("d_") or "_c" not in key:
                continue
            metric, _, cls = key.rpartition("_c")
            try:
                name = id2name.get(int(cls), f"c{cls}")
                value = float(value)
            except (TypeError, ValueError):
                continue
            entry = series.setdefault(metric, {"xs": [], "ys": {}})
            if step not in entry["xs"]:
                entry["xs"].append(step)
            points = entry["ys"].setdefault(name, [])
            while len(points) < len(entry["xs"]) - 1:
                points.append(value)
            if len(points) == len(entry["xs"]):
                points[-1] = value
            else:
                points.append(value)
        payload = {}
        for metric, entry in series.items():
            keys = list(entry["ys"])
            payload[metric] = self._wandb.plot.line_series(
                xs=entry["xs"], ys=[entry["ys"][k] for k in keys],
                keys=keys, title=metric)
        if payload:
            self.run.log(payload, step=step)

    def finish(self) -> None:
        if self.enabled and self.run is not None:
            self.run.finish()


class Timer:
    """Seconds since the last call (data and batch times)."""

    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        now = time.time()
        delta = now - self.start
        self.start = now
        return delta
