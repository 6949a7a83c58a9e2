"""CoDEPS in PyTorch for NVIDIA Hopper: the port of ``codeps_tpu``.

The JAX package ``codeps_tpu`` is the reference; this package sits beside
it, imports nothing of it and no JAX, and keeps its module layout so each
module's counterpart is found by name:

  config/   config tree + YAML overrides (own copy; YAML read lazily)
  data/     label taxonomies, numpy preprocessing, the KITTI-360,
            Cityscapes and SemKITTI-DVPS readers, the loader, the replay
            buffer (PIL/cv2 read files only)
  ops/      normalize, resize, top-k threshold, grid sampling, panoptic
            fusion and the pixel-grouping kernel (csrc/grouping.cu, built
            at first use)
  geometry/ camera, pose, view-synthesis warp
  losses/   photometric, smoothness, semantic, instance
  models/   ResNet encoders, depth/pose/semantic/instance heads, the facade
  evaluation/ depth, semantic and panoptic metrics, meters
  tasks/    forward helpers, optimizer, states, the pretraining step, the
            adaptation step, the streaming runner, validation
  io/       checkpoints (with the optimizer, generator and meters of a
            run), the weight bridge from the JAX trees, logging,
            visualizations
  scripts/  ``python -m codeps_torch.scripts.infer``, ``...adapt`` and
            ``...train``

Modules are NCHW inside; public functions take and return NHWC images and
maps, as the JAX counterparts do. They compute in ``cfg.tpu.compute_dtype``
(bfloat16 by default, as the JAX package's; ``models/precision.py``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise.
"""

from codeps_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
