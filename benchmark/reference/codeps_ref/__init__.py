"""A frozen copy of the modules of ``codeps_torch`` that the benchmark's
plain reference runs: config, data readers, ops, geometry, losses, models
and the pretraining and adaptation steps, with each import renamed to this
package and the pixel grouping in plain PyTorch (no kernel, no build).

It is the yardstick: later changes to the port do not reach it, and it
imports nothing of the port or of the JAX package. The benchmark runs it
in float32 with TF32 off (``cfg.tpu.compute_dtype = "float32"``).
"""

from benchmark.reference.codeps_ref.device import resolve_device

__all__ = ["resolve_device"]
