"""Online adaptation from the command line, with the port.

Counterpart of ``scripts/adapt.py`` (the reference's
``scripts/adapt_codeps.py``): loads a pretrained checkpoint, streams the
target sequence frame by frame, adapting the model online with source
and target replay and mixup, then validates the adapted EMA teacher on
the held-out part of the target sequence and on Cityscapes val (the
forgetting eval).

``main`` parses the arguments, reads the YAML, builds the dataset readers
from files and writes ``config.yaml``; ``run_adaptation`` does everything
after that on datasets it is handed, so in-memory datasets run the same
path.

With ``tpu.spatial_shard: true`` under ``torch.distributed.run`` each
frame's step is split by image rows over the N ranks
(``parallel/spatial.py``): rank 0 streams and writes (the run directory,
``config.yaml``, the logs, the buffer state, wandb), the other ranks
follow its steps; validation runs over every rank (``tasks/validate.py``).
Several ranks without ``tpu.spatial_shard`` raise: the stream adapts one
frame at a time.

Example:
    python -m codeps_torch.scripts.adapt --run_name a1 \
        --filename_config cfg/adapt_cityscapes_kitti_360.yaml \
        --checkpoint /path/to/pretrain.pth
    python -m torch.distributed.run --nproc_per_node 4 \
        -m codeps_torch.scripts.adapt --run_name a4 \
        --filename_config spatial.yaml --checkpoint /path/to/pretrain.pth
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from codeps_torch import parallel
from codeps_torch.data.loader import DataLoader
from codeps_torch.data.replay_buffer import ReplayBuffer
from codeps_torch.device import resolve_device
from codeps_torch.io.checkpoint import pretrained_from_checkpoints
from codeps_torch.io.logging import WandbLogger, init_logging, log_info
from codeps_torch.models import build_modules, init_params
from codeps_torch.tasks.adapt_loop import AdaptationRunner
from codeps_torch.tasks.validate import run_validation


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="CoDEPS adaptation")
    parser.add_argument("--run_name", required=True)
    parser.add_argument("--filename_config", required=True)
    parser.add_argument("--comment", default="",
                        help="Accepted for the JAX CLI's command lines; "
                             "unused")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--checkpoint", action="append", default=[],
                        help="Pretraining checkpoint: a path (every module "
                             "it holds) or module:path; repeatable. "
                             "Reference .pth or the JAX package's .pkl")
    parser.add_argument("--mode", default="adapt",
                        help="Accepted for the JAX CLI's command lines; "
                             "unused")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--buffer_state", default=None,
                        help="Previous-domain buffer state for continual "
                             "chains (written by --save_buffer_state)")
    parser.add_argument("--save_buffer_state", default=None)
    parser.add_argument("--experiments_dir", default="experiments")
    parser.add_argument("--wandb", action="store_true",
                        help="Enable wandb logging (if installed)")
    parser.add_argument("--wandb_project", default="codeps_torch")
    parser.add_argument("--wandb_entity", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def read_datasets(cfg):
    """(target stream, held-out target, source, source val) readers of
    the config's datasets, from files. The held-out KITTI-360 reader takes
    only annotated frames; the replay buffer's split accounts for the
    skipped ones (``misc/adapt_utils.py:69``,
    ``datasets/replay_buffer.py:32-39``)."""
    from codeps_torch.data.cityscapes import Cityscapes
    label_mode = cfg.dataset.label_mode
    sequences = list(cfg.dataset.sequences)
    if cfg.dataset.name == "sem_kitti_dvps":
        from codeps_torch.data.sem_kitti_dvps import SemKittiDvps
        target, val_target = (
            SemKittiDvps("sequence", cfg.dataset, return_depth=True,
                         sequences=sequences, label_mode=label_mode)
            for _ in range(2))
    elif cfg.dataset.name == "kitti_360":
        from codeps_torch.data.kitti_360 import Kitti360
        target, val_target = (
            Kitti360("sequence", cfg.dataset, return_depth=True,
                     sequences=sequences, sequence_reference_mode=mode,
                     label_mode=label_mode)
            for mode in ("rgb", "semantic"))
    else:
        raise NotImplementedError(
            f"Dataset {cfg.dataset.name} is not implemented")
    if cfg.adapt.source_dataset.name != "cityscapes":
        raise NotImplementedError(
            "Only Cityscapes is supported as the adaptation source")
    source, source_val = (Cityscapes(split, cfg.adapt.source_dataset,
                                     label_mode=label_mode)
                          for split in ("train", "val"))
    return target, val_target, source, source_val


def _validate(cfg, teacher, dataset, offsets, runner, ignore_classes,
              max_frames, name) -> Optional[Dict[str, Any]]:
    if len(dataset) == 0:
        return None
    loader = DataLoader(dataset, batch_size=1, offsets=offsets,
                        shuffle=False)
    metrics = run_validation(
        cfg, teacher, loader, runner.thing_list, runner.stuff_list,
        ignore_classes,
        max_batches=max(1, max_frames) if max_frames else None)
    log_info("%s: %s", name, {k: round(float(v), 4)
                              for k, v in metrics.items()
                              if np.ndim(v) == 0})
    return metrics


def run_adaptation(cfg, target, val_target, source, source_val, *,
                   seed: int = 42, checkpoints: Sequence[str] = (),
                   max_frames: Optional[int] = None,
                   buffer_state: Optional[str] = None,
                   save_buffer_state: Optional[str] = None,
                   device=None,
                   wandb_logger: Optional[WandbLogger] = None
                   ) -> Dict[str, Any]:
    """Stream ``target`` through the adaptation runner on ``device``
    (``cuda`` unless given) from seeded modules with ``checkpoints``
    loaded, then validate the EMA teacher on the held-out part of
    ``val_target`` and on ``source_val``, each capped at ``max_frames``
    batches. ``source`` fills the source buffer; ``buffer_state`` adds a
    previous domain's buffer, ``save_buffer_state`` writes this one's.

    Returns ``{"meters": the stream's meters, "target_val": metrics,
    "source_val": metrics}`` (None for an empty split). In a process group
    of several ranks (``tpu.spatial_shard``) rank 0's meters hold the
    stream, the other ranks' are empty.
    """
    device = resolve_device(device)
    if parallel.world_size() > 1 and not cfg.tpu.spatial_shard:
        raise ValueError(
            f"adaptation over {parallel.world_size()} ranks splits each "
            "frame's rows and needs tpu.spatial_shard: true")
    lead = parallel.is_lead()
    wandb_logger = wandb_logger or WandbLogger()
    if cfg.adapt.mode == "off":
        log_info("WARNING: disabled adaptation")

    # ---------------- datasets and replay buffer (misc/adapt_utils.py)
    replay_buffer = ReplayBuffer(target, cfg.adapt, mode="train")
    replay_buffer.initialize_source_buffer(
        source, cfg.adapt.replay_buffer.source_size)
    if buffer_state and lead:
        # the previous domain's dataset travels in the state and may be of
        # another type (a KITTI-360 buffer in a SemKITTI-DVPS stream)
        replay_buffer.load_state(path=buffer_state)
    log_info("Adaptation frames: %d | Source buffer: %d",
             len(replay_buffer), len(replay_buffer.source_samples_indices))

    # ---------------- model: seeded, then the checkpoints
    modules = init_params(build_modules(cfg, replay_buffer.num_classes,
                                        device=device),
                          seed=seed, device=device)
    if checkpoints:
        loaded = pretrained_from_checkpoints(checkpoints, modules, cfg)
        log_info("Loaded %s from %s", ", ".join(loaded) or "no modules",
                 ", ".join(checkpoints))
    runner = AdaptationRunner(cfg, modules, replay_buffer, seed=seed,
                              device=device, wandb_logger=wandb_logger)
    log_info("Frozen modules: %s | EMA modules: %s",
             list(runner.state.frozen_modules),
             list(runner.state.ema_modules))

    # ---------------- the stream
    meters = runner.run(max_frames=max_frames)
    if lead:
        _log_stream(cfg, runner, meters, wandb_logger)
    if save_buffer_state and lead:
        replay_buffer.save_state(save_buffer_state)
        log_info("Saved buffer state to %s", save_buffer_state)
    parallel.barrier()

    # ---------------- the adapted EMA teacher on the held-out target and
    # on the source (adapt_codeps.py:449-458)
    teacher = runner.state.teacher
    target_val = _validate(
        cfg, teacher, ReplayBuffer(val_target, cfg.adapt, mode="val"),
        cfg.dataset.offsets, runner, runner.ignore_classes, max_frames,
        "Target val")
    source_val = _validate(cfg, teacher, source_val,
                           cfg.adapt.source_dataset.offsets, runner, (),
                           max_frames, "Source val (forgetting)")
    return {"meters": meters, "target_val": target_val,
            "source_val": source_val}


def _log_stream(cfg, runner, meters, wandb_logger) -> None:
    """The stream's rate and final metrics to the log and wandb."""
    times = runner.step_times[3:] or runner.step_times
    if times:
        log_info("Adaptation done: %.2f steps/s (mean over %d frames)",
                 1.0 / max(float(np.mean(times)), 1e-9), len(times))
        if runner.frame_phases:
            # the main thread's parts and spans of a frame (tasks/trace.py)
            log_info("Host ms a frame (mean over the same frames): %s",
                     ", ".join(f"{name} {np.mean(v[3:] or v) * 1e3:.1f}"
                               for name, v in runner.frame_phases.items()))
        counts = {k: v[3:] or v for k, v in runner.frame_counters.items()}
        if sum(counts.get("h2d_bytes", ())):
            log_info("Host to device a frame: %.2f MB in %.1f copies, "
                     "%.1f%% from pageable memory",
                     np.mean(counts["h2d_bytes"]) / 1e6,
                     np.mean(counts["h2d_copies"]),
                     100.0 * sum(counts["h2d_pageable_bytes"])
                     / sum(counts["h2d_bytes"]))
        if "step.eager_steps" in runner.frame_counters:
            # the steps of the whole stream (tasks/step_graph.py)
            log_info("Adaptation steps: %d eager, %d graph capture(s), "
                     "%d graph replay(s)", *(
                         sum(runner.frame_counters[f"step.{name}"])
                         for name in ("eager_steps", "graph_captures",
                                      "graph_replays")))
    else:
        log_info("Adaptation done: 0 frames processed (empty stream?)")
    metrics = meters["metrics"]
    log_info("Final mIoU: %.4f | PQ: %.4f",
             float(metrics["sem_miou"].value), float(metrics["p_pq"].value))
    scalars = {k: m.value for k, m in metrics.items()
               if np.ndim(m.value) == 0}
    steps = len(runner.step_times)
    wandb_logger.log_scalars(
        "adapt", losses={k: m.value for k, m in meters["losses"].items()},
        metrics=scalars, step=steps)
    if runner.panoptic_eval.pq_stats.pq_per_cat:
        wandb_logger.log_panoptic_table(
            "adapt", runner.panoptic_eval.evaluate(),
            cfg.dataset.remove_classes, cfg.dataset.label_mode, step=steps)
    wandb_logger.log_depth_per_class(scalars, cfg.dataset.remove_classes,
                                     cfg.dataset.label_mode, step=steps)


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    resolve_device(args.device)
    np.random.seed(args.seed)
    from codeps_torch.config import gen_config

    cfg = gen_config(args.filename_config, adapt=True)
    run_dir = Path(args.experiments_dir) / f"adapt_{args.run_name}"
    with parallel.process_group(args.device) as device:
        if parallel.is_lead():
            run_dir.mkdir(parents=True, exist_ok=True)
            (run_dir / "config.yaml").write_text(cfg.dump())
        parallel.barrier()
        init_logging(str(run_dir / "logs"), debug=args.debug)
        wandb_logger = WandbLogger(project=args.wandb_project,
                                   entity=args.wandb_entity,
                                   run_name=args.run_name,
                                   enabled=args.wandb, config=cfg.to_dict())
        result = run_adaptation(
            cfg, *read_datasets(cfg), seed=args.seed,
            checkpoints=args.checkpoint, max_frames=args.max_frames,
            buffer_state=args.buffer_state,
            save_buffer_state=args.save_buffer_state, device=device,
            wandb_logger=wandb_logger)
        wandb_logger.finish()
        log_info("End of adaptation script!")
    return result


if __name__ == "__main__":
    main()
