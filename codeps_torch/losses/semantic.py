"""Hard-pixel-mining cross entropy for the semantic head.

Counterpart of ``codeps_tpu/losses/semantic.py:24-128`` (the reference's
SemanticLoss), NCHW. The reference's quirk is kept: the semantic head
returns softmax probabilities and the CE applies ``log_softmax`` to them
again.
"""

from __future__ import annotations

from typing import Sequence

import torch

from codeps_torch.ops.topk import top_k_mean


def cross_entropy_per_pixel(prediction: torch.Tensor, target: torch.Tensor,
                            class_weights: torch.Tensor | None = None,
                            ignore_index: int = 255) -> torch.Tensor:
    """torch-style CE with ``reduction='none'``: (B, C, H, W) prediction,
    (B, H, W) integer target -> (B, H, W).

    Pixels whose target is ``ignore_index`` contribute exactly 0; so does
    a target outside [0, C), as in the JAX package's one-hot form.
    """
    logp = torch.log_softmax(prediction, dim=1)
    num_classes = prediction.shape[1]
    target = target.long()
    valid = target != ignore_index
    in_range = (target >= 0) & (target < num_classes)
    safe = torch.where(valid & in_range, target, 0)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    if class_weights is not None:
        nll = nll * class_weights.to(nll.dtype)[safe]
    return torch.where(valid & in_range, nll, 0.0)


def _apply_ignore_labels(prediction, target, class_weights, ignore_labels,
                         ignore_index):
    """Targets of ignored classes become ``ignore_index``, the ignored
    prediction channels are dropped and their class weights with them.
    The remaining targets are not renumbered (the reference's rule)."""
    for ignore_label in ignore_labels:
        target = torch.where(target == ignore_label, ignore_index, target)
    preserved = [c for c in range(prediction.shape[1])
                 if c not in ignore_labels]
    prediction = prediction[:, preserved]
    if class_weights is not None:
        class_weights = [w for label, w in enumerate(class_weights)
                         if label not in ignore_labels]
    return prediction, target, class_weights


def semantic_loss(prediction: torch.Tensor, target: torch.Tensor,
                  pixel_weights: torch.Tensor,
                  class_weights: Sequence[float] | None = None,
                  ignore_labels: Sequence[int] | None = None,
                  top_k_percent_pixels: float = 1.0,
                  ignore_index: int = 255,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """Per-pixel weighted CE, then the mean of the top
    ``int(top_k_percent_pixels * B*H*W)`` pixel losses over the batch.

    Args:
      prediction: (B, C, H, W) softmax probabilities.
      target: (B, H, W) integer labels.
      pixel_weights: (B, H, W).
      class_weights: one weight per class channel.
      ignore_labels: class channels to drop entirely.
      dtype: element type of the per-pixel log-softmax and weighting (the
        compute dtype of the config); None keeps the prediction's. The
        top-k mean accumulates in float32 either way.
    """
    if dtype is not None:
        prediction = prediction.to(dtype)
        pixel_weights = pixel_weights.to(dtype)
    if ignore_labels:
        prediction, target, class_weights = _apply_ignore_labels(
            prediction, target, class_weights, ignore_labels, ignore_index)
    weights = None
    if class_weights is not None:
        weights = torch.tensor(list(class_weights), dtype=prediction.dtype,
                               device=prediction.device)
    loss = cross_entropy_per_pixel(prediction, target, weights, ignore_index)
    loss = loss * pixel_weights
    if top_k_percent_pixels < 1.0:
        flat = loss.reshape(-1)
        return top_k_mean(flat, int(top_k_percent_pixels * flat.shape[0]))
    return loss.to(torch.float32).mean()
