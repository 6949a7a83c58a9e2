"""Pretraining from the command line, with the port, on one card or
data-parallel on several.

Counterpart of ``scripts/train.py`` (the reference's
``scripts/train_codeps.py``): supervised panoptic and self-supervised
depth pretraining on a source dataset, a checkpoint each epoch and
validation with losses every ``logging.val_epoch_interval`` epochs.

``main`` parses the arguments, reads the YAML, builds the dataset readers
from files and writes ``config.yaml``; ``run_training`` does everything
after that on datasets it is handed, so in-memory datasets run the same
path.

Started by ``python -m torch.distributed.run --nproc_per_node N``, the
processes form a process group (``parallel/dist.py``, the counterpart of
``codeps_tpu/parallel/mesh.py``): ``--device cuda`` puts rank r on card
``cuda:LOCAL_RANK`` over NCCL, an explicit ``cuda:K`` puts every rank on
card K over gloo (NCCL refuses two ranks on one card), ``cpu`` runs gloo.
The global batch is ``train.batch_size_per_gpu`` times the ranks, each
rank loading its shard; the step takes the global batch's gradient,
BatchNorm statistics and top-k (the JAX package's mesh semantics), and
validation reads the global val batch on every rank and evaluates its
rows. Rank 0 alone writes the run directory, the log file, wandb and the
checkpoints. Alone, the process runs on one card with the global batch
``train.batch_size_per_gpu``.

``tpu.remat`` is not acted on: the JAX package recomputes the encoder's
activations to fit batch 6 at 512x1024 into a 16 GB chip, and one H100
holds that batch with its activations kept (measured by ``chip_smoke.py``
phase 9).

Example:
    python -m codeps_torch.scripts.train --run_name r1 \\
        --filename_config cfg/train_cityscapes.yaml
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m codeps_torch.scripts.train --run_name r4 \\
        --filename_config cfg/train_cityscapes.yaml
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from codeps_torch import parallel
from codeps_torch.data.loader import DataLoader
from codeps_torch.device import resolve_device
from codeps_torch.evaluation.meters import AverageMeter
from codeps_torch.io.checkpoint import (checkpoint_state_dicts,
                                        load_checkpoint,
                                        pretrained_from_checkpoints,
                                        restore_meters, restore_opt_state,
                                        restore_rng, resume_from_checkpoint,
                                        save_checkpoint)
from codeps_torch.io.logging import (WandbLogger, init_logging, log_info,
                                     log_iter)
from codeps_torch.models import build_modules, init_params
from codeps_torch.tasks.optim import build_schedule
from codeps_torch.tasks.state import match_prefixes, make_train_state
from codeps_torch.tasks.train import make_train_step
from codeps_torch.tasks.validate import run_validation


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="CoDEPS pretraining")
    parser.add_argument("--run_name", required=True)
    parser.add_argument("--filename_config", required=True,
                        help="Path to the YAML config (cfg/*.yaml)")
    parser.add_argument("--comment", default="",
                        help="Accepted for the JAX CLI's command lines; "
                             "unused")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--checkpoint", default=None,
                        help="Resume from this checkpoint: the port's "
                             ".pth or the JAX package's .pkl")
    parser.add_argument("--pre_train_checkpoint", nargs="*", default=[],
                        help="Pretrained weights, a path or module:path")
    parser.add_argument("--eval", action="store_true",
                        help="Validate the checkpoint once and exit")
    parser.add_argument("--freeze_modules", nargs="+", default=[],
                        help="Module-name prefixes to freeze")
    parser.add_argument("--mode", default="train",
                        help="Accepted for the JAX CLI's command lines; "
                             "unused")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="Stop after N optimizer steps")
    parser.add_argument("--experiments_dir", default="experiments")
    parser.add_argument("--wandb", action="store_true",
                        help="Enable wandb logging (if installed)")
    parser.add_argument("--wandb_project", default="codeps_torch")
    parser.add_argument("--wandb_entity", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; "
                             "under torchrun cuda:LOCAL_RANK)")
    return parser.parse_args(argv)


def build_dataset(cfg, split: str, return_depth: bool):
    """The reader of ``cfg.dataset`` for ``split``, from files."""
    name = cfg.dataset.name
    label_mode = cfg.dataset.label_mode
    if name == "cityscapes":
        from codeps_torch.data.cityscapes import Cityscapes
        return Cityscapes(split, cfg.dataset, return_depth=return_depth,
                          return_only_rgb=cfg.dataset.return_only_rgb,
                          label_mode=label_mode)
    if name == "kitti_360":
        from codeps_torch.data.kitti_360 import Kitti360
        return Kitti360(split, cfg.dataset, return_depth=return_depth,
                        return_only_rgb=cfg.dataset.return_only_rgb,
                        label_mode=label_mode)
    if name == "sem_kitti_dvps":
        from codeps_torch.data.sem_kitti_dvps import SemKittiDvps
        return SemKittiDvps(split, cfg.dataset, return_depth=return_depth,
                            label_mode=label_mode)
    raise NotImplementedError(f"Dataset {name} is not implemented")


def _scalars(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


def run_training(cfg, train_dataset, val_dataset, *, seed: int = 42,
                 checkpoint: Optional[str] = None,
                 pre_train_checkpoints: Sequence[str] = (),
                 eval_only: bool = False,
                 freeze_modules: Sequence[str] = (),
                 max_steps: Optional[int] = None,
                 run_dir: Optional[str] = None, device=None,
                 wandb_logger: Optional[WandbLogger] = None,
                 noise=None) -> Dict[str, Any]:
    """Pretrain on ``train_dataset`` on ``device`` (``cuda`` unless given)
    and validate on ``val_dataset``; inside a process group
    (``parallel.process_group``, which ``main`` enters) data-parallel over
    its ranks, on the rank's ``device``.

    Seeded modules, then ``pre_train_checkpoints`` (paths or
    ``module:path``), then, with ``checkpoint``, the run resumes: modules,
    optimizer, generator (the port's checkpoints only), step, meters and
    the epoch after the saved one. ``eval_only`` validates once and
    returns. Otherwise each epoch of the shuffled loader (seeded by
    ``seed``) steps until ``max_steps`` optimizer steps in all, meters take
    the scalar metrics every ``logging.log_step_interval`` steps, a
    checkpoint goes to ``run_dir/saved_models/epoch_<n>.pth`` and every
    ``logging.val_epoch_interval`` epochs validation runs with losses.
    ``noise`` (a callable ``shape -> tensor``) replaces the state's
    generator as the source of the automask noise.

    Returns ``{"state", "meters", "metrics" (each step's scalars),
    "val" (each validation's metrics), "global_step", "step_times",
    "checkpoints"}``.
    """
    device = resolve_device(device)
    wandb_logger = wandb_logger or WandbLogger()
    run_dir = Path(run_dir) if run_dir is not None else None
    ranks = parallel.world_size()
    log_info("Train samples: %d | Val samples: %d | rank %d of %d on %s",
             len(train_dataset), len(val_dataset), parallel.rank(), ranks,
             device)
    # each rank loads its shard of the global batch; validation reads the
    # global batch whole on every rank (a wrapped shard would count an
    # item twice)
    train_loader = DataLoader(train_dataset, cfg.train.batch_size_per_gpu,
                              cfg.dataset.offsets, shuffle=True, seed=seed,
                              shard_index=parallel.rank(), num_shards=ranks,
                              num_workers=cfg.train.nof_workers_per_gpu)
    val_loader = DataLoader(val_dataset, cfg.val.batch_size_per_gpu * ranks,
                            cfg.dataset.offsets, shuffle=False,
                            drop_last=False)

    num_classes = train_dataset.num_classes
    modules = init_params(build_modules(cfg, num_classes, device=device),
                          seed=seed, device=device)
    if pre_train_checkpoints:
        loaded = pretrained_from_checkpoints(pre_train_checkpoints, modules,
                                             cfg)
        log_info("Loaded %s from %s", ", ".join(loaded) or "no modules",
                 ", ".join(pre_train_checkpoints))
    steps_per_epoch = max(len(train_loader), 1)
    frozen = match_prefixes(modules.module_names(), freeze_modules)
    if frozen:
        log_info("Frozen modules: %s", list(frozen))
    state = make_train_state(modules, build_schedule(cfg, steps_per_epoch),
                             frozen_modules=frozen, seed=seed, device=device)

    train_meters: Dict[str, AverageMeter] = {}
    start_epoch = global_step = 0
    if checkpoint:
        saved = load_checkpoint(checkpoint)
        resume_from_checkpoint(checkpoint_state_dicts(saved, cfg), modules)
        if not eval_only:
            restore_opt_state(saved, state.optimizer, modules, cfg, frozen)
            rng = restore_rng(saved)
            if rng is not None:
                state.generator.set_state(rng)
            global_step = int(saved["training_meta"].get("global_step", 0))
            state.step = global_step
            train_meters = {name: AverageMeter(()) for name in
                            saved["state_dict"].get("meters") or {}}
            restore_meters(saved, train_meters)
            start_epoch = int(saved["training_meta"]["epoch"]) + 1
        log_info("Resumed from %s at epoch %d (global_step %d)", checkpoint,
                 start_epoch, global_step)

    class_weights = [w for i, w in enumerate(cfg.semantics.class_weights)
                     if i not in cfg.dataset.remove_classes]
    if cfg.model.make_semantic and len(class_weights) != num_classes:
        raise ValueError(
            f"semantics.class_weights has {len(class_weights)} entries "
            f"after remove_classes, the {cfg.dataset.label_mode!r} labels "
            f"{num_classes} classes")
    ignore_classes = list(train_dataset.ignore_classes)
    train_step = make_train_step(cfg, class_weights,
                                 sem_ignore_classes=ignore_classes or None,
                                 num_classes=num_classes,
                                 eval_ignore_classes=ignore_classes)

    def validate() -> Dict[str, Any]:
        modules.eval()
        metrics = run_validation(
            cfg, modules, val_loader, train_dataset.thing_classes,
            train_dataset.stuff_classes, train_dataset.ignore_classes,
            compute_loss=True, class_weights=class_weights,
            gen_visuals=wandb_logger.enabled,
            label_mode=cfg.dataset.label_mode)
        log_info("Val (step %d): %s", global_step,
                 {k: round(v, 4) for k, v in _scalars(metrics).items()})
        wandb_logger.log_scalars("val", metrics=_scalars(metrics),
                                 step=global_step)
        if "visual_panels" in metrics:
            wandb_logger.log_images("val", metrics["visual_panels"],
                                    step=global_step)
        return metrics

    result: Dict[str, Any] = {"state": state, "meters": train_meters,
                              "metrics": [], "val": [], "step_times": [],
                              "checkpoints": []}
    if eval_only:
        if not checkpoint:
            raise ValueError("--eval validates a --checkpoint")
        result["val"].append(validate())
        result["global_step"] = global_step
        return result

    total_steps = cfg.train.nof_epochs * steps_per_epoch
    for epoch in range(start_epoch, cfg.train.nof_epochs):
        train_loader.set_epoch(epoch)
        epoch_start = time.perf_counter()
        for batch_np in train_loader:
            start = time.perf_counter()
            step_metrics = {k: v for k, v in train_step(
                state, batch_np, noise=noise).items() if v.ndim == 0}
            # one device-to-host copy of the step's scalars
            values = torch.stack([v.float() for v in step_metrics.values()])
            metrics = dict(zip(step_metrics, values.cpu().tolist()))
            result["step_times"].append(time.perf_counter() - start)
            result["metrics"].append(metrics)
            global_step += 1
            if global_step % cfg.logging.log_step_interval == 0:
                for name, value in metrics.items():
                    train_meters.setdefault(name, AverageMeter(()))
                    train_meters[name].update(value)
                log_iter(global_step, total_steps, metrics,
                         prefix=f"train e{epoch}")
                wandb_logger.log_scalars("train", losses=metrics,
                                         step=global_step)
            if max_steps and global_step >= max_steps:
                break
        log_info("Epoch %d done in %.1fs", epoch,
                 time.perf_counter() - epoch_start)
        if run_dir is not None:
            path = run_dir / "saved_models" / f"epoch_{epoch}.pth"
            save_checkpoint(str(path), cfg, modules, epoch, global_step,
                            optimizer=state.optimizer,
                            generator=state.generator, meters=train_meters)
            result["checkpoints"].append(str(path))
        if (len(val_dataset) > 0
                and (epoch + 1) % cfg.logging.val_epoch_interval == 0):
            result["val"].append(validate())
        if max_steps and global_step >= max_steps:
            break
    result["global_step"] = global_step
    return result


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    resolve_device(args.device)
    np.random.seed(args.seed)
    from codeps_torch.config import gen_config

    cfg = gen_config(args.filename_config)
    run_dir = Path(args.experiments_dir) / f"train_{args.run_name}"
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
        result = run_training(
            cfg, build_dataset(cfg, cfg.dataset.train_split,
                               return_depth=False),
            build_dataset(cfg, cfg.dataset.val_split,
                          return_depth=cfg.model.make_depth),
            seed=args.seed, checkpoint=args.checkpoint,
            pre_train_checkpoints=args.pre_train_checkpoint,
            eval_only=args.eval, freeze_modules=args.freeze_modules,
            max_steps=args.max_steps, run_dir=str(run_dir), device=device,
            wandb_logger=wandb_logger)
        wandb_logger.finish()
        log_info("End of training script!")
    return result


if __name__ == "__main__":
    main()
