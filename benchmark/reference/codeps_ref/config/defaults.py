"""Default configuration trees.

Key-compatible with the reference's yacs trees so the public YAML override
files keep working verbatim:
  - pretraining defaults: CoDEPS cfg/default_config.py:5-167
  - adaptation  defaults: CoDEPS cfg/default_config_adapt.py:5-214
"""

from benchmark.reference.codeps_ref.config.node import ConfigNode


def get_cfg_defaults() -> ConfigNode:
    """Pretraining config defaults (cfg/default_config.py parity)."""
    cfg = ConfigNode({
        "train": {
            "nof_epochs": 20,
            "nof_workers_per_gpu": 1,
            "batch_size_per_gpu": 1,
            "optimizer": {
                "type": "Adam",
                "learning_rate": 0.0001,
            },
            "scheduler": {
                "type": "StepLR",  # 'StepLR' or 'WarmupPolyLR'
                "step_lr": {"step_size": 20, "gamma": 0.1},
                "warmup": {
                    "max_iters": 90000,
                    "factor": 0.001,
                    "iters": 1000,
                    "method": "linear",
                    "power": 0.9,
                    "constant_ending": 0.0,
                },
            },
        },
        "val": {
            "batch_size_per_gpu": 1,
            "nof_workers_per_gpu": 1,
        },
        "model": _model_defaults(),
        "dataset": {
            "name": "",
            "path": "",
            "feed_img_size": [],  # [height, width]
            "offsets": [1],
            "center_heatmap_sigma": 8,
            "return_only_rgb": False,
            "small_instance_area_full_res": 4096,
            "small_instance_weight": 3,
            "train_split": "train",
            "train_sequences": [],
            "val_split": "val",
            "val_sequences": [],
            "remove_classes": [],
            "label_mode": "codeps",  # 'cityscapes' or 'codeps'
            "augmentation": _augmentation_defaults(horizontal_flipping=True),
            "normalization": _normalization_defaults(),
        },
        "eval": _eval_defaults(),
        "losses": {
            "weights": {
                "depth_recon": 1.0,
                "depth_smth": 0.0001,
                "flow_smth": 1.0,
                "flow_sparsity": 1.0,
                "semantic": 1.0,
                "center": 1.0,
                "offset": 1.0,
                "thing_mask": 1.0,
            },
        },
        "semantics": {
            "class_weights": tuple([1.0] * 19),
            "top_k": 0.2,
        },
        "depth": {"num_recon_scales": 5},
        "visualization": {"scale": 1.0},
        "logging": {
            "log_train_samples": True,
            "val_epoch_interval": 1,
            "log_step_interval": 10,
        },
        "general": {"cudnn_benchmark": False},
        # TPU-specific knobs (not present in the reference; safe additions).
        "tpu": _tpu_defaults(),
    })
    return cfg


def get_cfg_defaults_adapt() -> ConfigNode:
    """Online-adaptation config defaults (cfg/default_config_adapt.py parity)."""
    cfg = ConfigNode({
        "adapt": {
            "mode": "online",  # 'online' or 'off'
            "model": {
                "backbone_po_depth": True,
                "backbone_pose_sflow": True,
                "depth": True,
                "pose": True,
                "sflow": True,
                "semantic": True,
                "instance": True,
            },
            "ema": {
                "alpha": 0.999,
                "depth": False,
                "semantic": False,
                "instance": False,
            },
            "source_dataset": {
                "name": "",
                "path": "",
                "feed_img_size": [],
                "offsets": [1],
            },
            "replay_sampler": {
                "nof_source_samples": 1,
                "nof_target_samples": 0,
                "seed": 42,
            },
            "replay_buffer": {
                "source_size": None,
                "target_size": None,
                "maximize_diversity": False,
                "similarity_threshold": 0.95,
                "seed": 42,
            },
            "target_dataset_adapt_ratio": 0.7,
            "mixup": {
                "general": {
                    "active": True,
                    "mixup_strategies": ["cut_mixup", "conf_instance_mixup"],
                    "nof_samples": 2,
                    "geom_augment": True,
                },
                "cut_mix": {
                    "nof_hor_splits": 4,
                    "nof_vert_splits": 4,
                    "nof_segments": 1,
                },
                "conf_instance_mix": {
                    "conf_thresh": 0.0,
                    "min_inst_size": 0,
                },
                "class_mix": {"conf_thresh": 0.0},
            },
        },
        "train": {
            "nof_adaptation_steps": 1,
            "nof_workers_per_gpu": 10,
            "optimizer": {
                "type": "Adam",
                "learning_rate": 0.0001,
            },
        },
        "val": {
            "batch_size_per_gpu": 2,
            "nof_workers_per_gpu": 10,
        },
        "model": _model_defaults(),
        "dataset": {
            "name": "",
            "path": "",
            "sequences": [],
            "feed_img_size": [],
            "offsets": [1],
            "batch_size_per_gpu": 2,
            "center_heatmap_sigma": 8,
            "return_only_rgb": False,
            "small_instance_area_full_res": 4096,
            "small_instance_weight": 3,
            "remove_classes": [],
            "label_mode": "codeps",
            "augmentation": _augmentation_defaults(horizontal_flipping=False),
            "normalization": _normalization_defaults(),
        },
        "eval": _eval_defaults(),
        "losses": {
            "weights": {
                "depth_recon": 10.0,
                "depth_smth": 0.001,
                "flow_smth": 10.0,
                "flow_sparsity": 10.0,
                "semantic_source": 1.0,
                "semantic_cut_mixup": 1.0,
                "center_source": 20.0,
                "offset_source": 0.1,
            },
        },
        "depth": {"num_recon_scales": 5},
        "semantics": {
            "class_weights": [1.0] * 14,
            "top_k": 0.2,
        },
        "visualization": {"scale": 0.5},
        "logging": {
            "log_train_samples": True,
            "val_epoch_interval": 1,
            "log_step_interval": 10,
        },
        "general": {"cudnn_benchmark": False},
        "tpu": _tpu_defaults(),
    })
    return cfg


def _model_defaults() -> dict:
    return {
        "make_depth": True,
        "make_sflow": False,
        "make_semantic": True,
        "make_instance": True,
        "po_depth_net": {
            "params": {"nof_layers": 101, "weights_init": "pretrained"},
        },
        "pose_sflow_net": {
            "input": "pairs",
            "params": {"nof_layers": 18, "weights_init": "pretrained"},
        },
        "semantic_head": {"use_guda_fusion": True},
        "instance_head": {"use_thing_mask": False},
    }


def _augmentation_defaults(horizontal_flipping: bool) -> dict:
    return {
        "active": True,
        "horizontal_flipping": horizontal_flipping,
        "brightness_jitter": 0.2,
        "contrast_jitter": 0.2,
        "saturation_jitter": 0.2,
        "hue_jitter": 0.1,
    }


def _normalization_defaults() -> dict:
    return {
        "active": True,
        "rgb_mean": (0.485, 0.456, 0.406),
        "rgb_std": (0.229, 0.224, 0.225),
        # Ship raw uint8 to the device and normalize inside the jitted
        # steps (4x less H2D traffic). TPU-specific addition.
        "uint8_transfer": False,
    }


def _eval_defaults() -> dict:
    return {
        "depth": {
            "use_gt_scale": True,
            "depth_ranges": [0.1, 80],
        },
        "semantic": {"ignore_classes": []},
    }


def _tpu_defaults() -> dict:
    """TPU-specific additions (no counterpart in the reference)."""
    return {
        "mesh": {"data_axis": "data"},
        # Compute dtype for the conv stack ('bfloat16' or 'float32');
        # params and loss accumulation stay float32.
        "compute_dtype": "bfloat16",
        "donate_state": True,
        # Rematerialize encoder blocks in backward (activation memory ~
        # O(depth) smaller; needed for train_cityscapes on 16 GB chips).
        "remat": False,
        # Spatially shard the online-adaptation step over all local
        # devices: image tensors partition along their HEIGHT axis, so
        # one stream frame's conv/warp pipeline spreads over the ICI
        # mesh (per-frame latency lever; the reference caps adaptation
        # at 1 GPU, scripts/adapt_codeps.py:391). parallel/spatial.py.
        "spatial_shard": False,
        # Execute encoder conv1 via the exact space-to-depth fold
        # (models/resnet.py _fold_conv1_s2d). Measured REGRESSION on the
        # v5e adapt step (4.43 -> 4.25 steps/s, 384x1280); opt-in for
        # shapes where the 7x7/s2 conv1 dominates.
        "s2d_conv1": False,
    }
