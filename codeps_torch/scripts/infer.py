"""Run a CoDEPS checkpoint on a directory of images with the port.

Counterpart of ``scripts/infer.py``: the ``CodepsNet`` facade's eval
forward over every image, writing per-image panels (RGB, depth,
semantic, panoptic) and optionally the raw predictions as ``.npz``.
``--checkpoint`` takes what ``io/checkpoint.pretrained_from_checkpoints``
loads (a reference-layout ``.pth``, the JAX package's ``.pkl``, or
``module:path``); keys it lacks keep their seeded initialization. The
modules compute in ``tpu.compute_dtype`` of the config, bfloat16 by
default, as the port's every entry point does; ``scripts/infer.py`` of the
JAX package builds its modules in float32 whatever the key.

Example:
    python -m codeps_torch.scripts.infer --checkpoint codeps.pth \
        --filename_config cfg/adapt_cityscapes_kitti_360.yaml \
        --images /path/to/frames --output preds/
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint: path or module:path (reference "
                             ".pth or the JAX package's .pkl)")
    parser.add_argument("--filename_config", required=True,
                        help="YAML config (model geometry + label mode)")
    parser.add_argument("--images", required=True,
                        help="Image file, directory, or glob")
    parser.add_argument("--output", required=True)
    parser.add_argument("--save_raw", action="store_true",
                        help="Also write raw predictions as .npz")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def list_images(spec: str) -> list[Path]:
    import glob as globlib
    p = Path(spec)
    if p.is_dir():
        files = sorted(q for q in p.iterdir()
                       if q.suffix.lower() in (".png", ".jpg", ".jpeg"))
    elif p.exists():
        files = [p]
    else:
        files = sorted(Path(m) for m in globlib.glob(spec, recursive=True))
    if not files:
        raise FileNotFoundError(f"No images match {spec!r}")
    return files


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    from codeps_torch.config import load_config
    from codeps_torch.data import get_labels
    from codeps_torch.device import resolve_device
    from codeps_torch.io.checkpoint import pretrained_from_checkpoints
    from codeps_torch.io.visualizations import (colorize_depth,
                                                colorize_panoptic,
                                                colorize_semantic)
    from codeps_torch.models import CodepsNet, build_modules, init_params

    device = resolve_device(args.device)
    cfg = load_config(args.filename_config)
    labels = get_labels(cfg.dataset.remove_classes, cfg.dataset.label_mode)
    thing_list = [i for i, lb in enumerate(labels) if lb.hasInstances]
    feed_h, feed_w = cfg.dataset.feed_img_size

    modules = init_params(build_modules(cfg, len(labels), device=device),
                          seed=0, device=device)
    loaded = pretrained_from_checkpoints([args.checkpoint], modules, cfg)
    print(f"Loaded {', '.join(loaded) or 'no modules'} from "
          f"{args.checkpoint}")
    norm = cfg.dataset.normalization
    net = CodepsNet(modules, thing_list=thing_list,
                    rgb_mean=tuple(norm.rgb_mean),
                    rgb_std=tuple(norm.rgb_std),
                    normalize=bool(norm.active), device=device)

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = list_images(args.images)
    print(f"Running inference on {len(files)} images -> {out_dir}")
    for start in range(0, len(files), args.batch_size):
        chunk = files[start:start + args.batch_size]
        frames = []
        for f in chunk:
            img = Image.open(f).convert("RGB").resize(
                (feed_w, feed_h), Image.LANCZOS)
            frames.append(np.asarray(img, np.uint8))
        result = net(np.stack(frames), mode="eval")
        result = {k: v.cpu().numpy() for k, v in result.items()
                  if v is not None}

        for i, f in enumerate(chunk):
            stem = f.stem
            Image.fromarray(frames[i]).save(out_dir / f"{stem}_rgb.png")
            raw = {}
            if "depth" in result:
                depth = result["depth"][i][..., 0]
                Image.fromarray(colorize_depth(depth)).save(
                    out_dir / f"{stem}_depth.png")
                raw["depth"] = depth
            if "semantic" in result:
                sem = result["semantic"][i]
                Image.fromarray(colorize_semantic(
                    sem, cfg.dataset.remove_classes,
                    cfg.dataset.label_mode)).save(
                    out_dir / f"{stem}_semantic.png")
                raw["semantic"] = sem
            if "panoptic" in result:
                pan = result["panoptic"][i]
                Image.fromarray(colorize_panoptic(
                    pan, cfg.dataset.remove_classes,
                    cfg.dataset.label_mode)).save(
                    out_dir / f"{stem}_panoptic.png")
                raw["panoptic"] = pan
            if args.save_raw:
                np.savez_compressed(out_dir / f"{stem}.npz", **raw)
    print(f"Done: {len(files)} images")


if __name__ == "__main__":
    main()
