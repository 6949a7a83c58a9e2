"""Hard-pixel-mining cross entropy for the semantic head, and the warp
consistency of semantic predictions.

Counterpart of ``codeps_tpu/losses/semantic.py:24-193`` (the reference's
SemanticLoss and SemanticConsistencyLoss), NCHW. The reference's quirk is
kept: the semantic head returns softmax probabilities and the CE applies
``log_softmax`` to them again.

Inside a row split (``parallel/spatial.py``) ``semantic_loss`` takes this
rank's slab of rows and returns its share of the global value: the top-k
runs over every rank's pixels.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from codeps_torch import parallel
from codeps_torch.geometry.warp import warp_image
from codeps_torch.models.precision import loss_dtype, widened
from codeps_torch.parallel import spatial
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
    ``int(top_k_percent_pixels * B*H*W)`` pixel losses over the batch;
    inside a process group (``parallel/dist.py``) over the global batch,
    whose every rank holds B rows.

    Args:
      prediction: (B, C, H, W) softmax probabilities.
      target: (B, H, W) integer labels.
      pixel_weights: (B, H, W).
      class_weights: one weight per class channel.
      ignore_labels: class channels to drop entirely.
      dtype: element type of the per-pixel log-softmax and weighting (the
        compute dtype of the config; float64 for a float64 prediction);
        None keeps the prediction's. The top-k mean accumulates in float32
        (float64 for float64 losses).
    """
    if dtype is not None:
        dtype = loss_dtype(dtype, prediction)
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
        pixels = flat.shape[0] * parallel.group_size()
        return spatial.share(top_k_mean(flat,
                                        int(top_k_percent_pixels * pixels)))
    return spatial.mean(widened(loss))


def semantic_consistency_loss(
        intrinsics: torch.Tensor, preds_probs: Sequence[torch.Tensor],
        images: Sequence[torch.Tensor], depth_map: torch.Tensor,
        poses: Sequence[torch.Tensor],
        object_motion_maps: Sequence[torch.Tensor] | None = None,
        class_weights: Sequence[float] | None = None,
        ignore_labels: Sequence[int] | None = None,
        ignore_index: int = 255,
        generator: torch.Generator | None = None,
        noise: Callable[[tuple], torch.Tensor] | None = None
) -> torch.Tensor:
    """Warp-consistency CE between frame t's semantic prediction and the
    neighbours' argmax labels warped into it (``semantic.py:130``; the
    reference constructs it and never calls it, nor does any JAX path).

    Per pixel the CE of t's probabilities against each warped neighbour
    label, weighted by t's normalized confidence (max entropy minus
    entropy, over max entropy) and by ``exp(-|I_t - warp(I_i)|)``, and
    against each unwarped neighbour label (the identity), plus 1e-5
    normals; the loss is the mean of the per-pixel minimum. Labels are
    the argmax (ties to the lowest class) and warp by nearest sampling.

    Args:
      preds_probs: [t, t-1, t+1] softmax probabilities, each (B, C, H, W).
      images: [t, t-1, t+1], each (B, 3, H, W).
      depth_map: (B, 1, H, W) depth of frame t.
      poses: [T(t->t-1), T(t->t+1)], each (B, 4, 4).
      object_motion_maps: optional pair of (B, 3, H, W) scene-flow maps.
      generator: source of the identity noise when ``noise`` is None.
      noise: callable ``shape -> tensor`` giving the (B, 2, H, W) identity
        noise, in place of the generator.
    """
    sem_preds = [p.argmax(dim=1) for p in preds_probs]
    target_probs = preds_probs[0]
    entropy = -torch.sum(target_probs * torch.log(target_probs + 1e-10),
                         dim=1)
    pixel_weights = (entropy.max() - entropy) / entropy.max()

    def per_pixel(labels, photometric=None):
        pred, cw_list = target_probs, class_weights
        if ignore_labels:
            pred, labels, cw_list = _apply_ignore_labels(
                pred, labels, cw_list, ignore_labels, ignore_index)
        weights = None
        if cw_list is not None:
            weights = torch.tensor(list(cw_list), dtype=pred.dtype,
                                   device=pred.device)
        loss = cross_entropy_per_pixel(pred, labels, weights, ignore_index)
        loss = loss * pixel_weights
        if photometric is not None:
            loss = loss * photometric
        return loss[:, None]

    recon = []
    for i, (labels, image) in enumerate(zip(sem_preds[1:], images[1:])):
        motion = None if object_motion_maps is None \
            else object_motion_maps[i]
        warped = warp_image(intrinsics, labels[:, None].to(torch.float32),
                            depth_map, poses[i], interp_mode="nearest",
                            object_motion=motion)
        warped_rgb = warp_image(intrinsics, image, depth_map, poses[i],
                                object_motion=motion)
        recon.append(per_pixel(
            warped[:, 0].to(torch.int64),
            torch.exp(-torch.mean(torch.abs(images[0] - warped_rgb),
                                  dim=1))))
    identity = torch.cat([per_pixel(labels) for labels in sem_preds[1:]],
                         dim=1)
    if noise is not None:
        draw = noise(tuple(identity.shape)).to(identity.device)
    else:
        draw = torch.randn(identity.shape, generator=generator,
                           device=identity.device)
    identity = identity + draw * 1e-5
    return torch.amin(torch.cat(recon + [identity], dim=1), dim=1).mean()
