"""The per-class pixel distribution that rare-class replay sampling reads,
with the port.

Counterpart of ``scripts/compute_class_distribution.py``, which imports
the JAX package: the replay buffer (``data/replay_buffer.py``) reads
``<dataset>/class_distribution.pkl`` with the keys ``num_pixels``,
``class_images`` and ``images_num_pixels``
(``data/dataset.class_distribution``), and this writes it for any
supported dataset of a config.

Example:
    python -m codeps_torch.scripts.compute_class_distribution \
        --filename_config cfg/train_cityscapes.yaml
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--filename_config", required=True,
                        help="Training YAML (its dataset section is used)")
    parser.add_argument("--split", default="train")
    parser.add_argument("--out", default=None,
                        help="Output path (default: "
                             "<dataset.path>/class_distribution.pkl)")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Writes the distribution; returns its path."""
    args = parse_args(argv)
    from codeps_torch.config import gen_config
    from codeps_torch.data.cityscapes import Cityscapes
    from codeps_torch.data.dataset import class_distribution
    from codeps_torch.data.kitti_360 import Kitti360
    from codeps_torch.data.sem_kitti_dvps import SemKittiDvps

    cfg = gen_config(args.filename_config)
    builders = {"cityscapes": Cityscapes, "kitti_360": Kitti360,
                "sem_kitti_dvps": SemKittiDvps}
    dataset = builders[cfg.dataset.name](args.split, cfg.dataset,
                                         label_mode=cfg.dataset.label_mode)
    distribution = class_distribution(dataset)
    out_path = args.out or str(Path(cfg.dataset.path)
                               / "class_distribution.pkl")
    with open(out_path, "wb") as handle:
        pickle.dump(distribution, handle)
    print(f"Wrote {out_path}: {len(distribution['num_pixels'])} classes, "
          f"{len(distribution['images_num_pixels'])} images")
    return out_path


if __name__ == "__main__":
    main()
