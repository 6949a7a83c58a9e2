"""Seeded weights, made on the card in one draw, for the port and the
reference alike.

``made_weights`` builds the frozen copy's modules (``reference/codeps_ref``)
in float32, fills every convolution from ONE ``torch.randn`` of a card
``torch.Generator`` seeded with the run's seed (the JAX package's scheme:
variance scaling over fan-out for the encoders, LeCun over fan-in for the
heads, normals cut at 2 standard deviations), zeroes biases and resets
BatchNorm, with the scale of each residual block's last BatchNorm at
1 / sqrt(the encoder's block count) (``RESIDUAL_SCALE``); with ``calibrate`` it sets the BatchNorm statistics from one
seeded frame as ``chip_smoke.calibrate_batch_norm`` does (torch's unbiased
update, in float32 with TF32 off) and raises the center head's bias so
that 0.02% of that frame's pixels pass the center threshold (the instance
head's center NMS then finds about 200 centers, as in
``chip_smoke.py`` phase 4). The state dict goes to the host, and both the
port's modules and the reference load it: the port makes none of it.
"""

from __future__ import annotations

import math

import torch

# std of a unit normal cut at +-2, which variance scaling divides by
TRUNC_STD = 0.87962566103423978
# A ResNet-101 at unit residual scales amplifies any rounding: bfloat16's
# 0.3% at the stem grows to 85% at the last stage, emulated float8's to
# 98%, so no comparison could tell the two apart (seen on a 128x384 frame
# on the CPU). Scaling each residual branch by 1 / sqrt(blocks), as
# depth-scaled initializations do, keeps the signal's propagation stable,
# as trained weights are: 0.3% -> 9% against 3.7% -> 54%.
RESIDUAL_BLOCKS = {"Bottleneck": "bn3", "BasicBlock": "bn2"}
CENTER_QUANTILE = 0.9998
CENTER_LEVEL = 0.1


class no_tf32:
    """float32 convolutions and matmuls without TF32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


@torch.no_grad()
def fill_seeded(modules, seed: int, device) -> None:
    """Every convolution of ``modules`` (a ``CodepsModules``) from one draw
    of a generator on ``device``; biases 0; BatchNorm reset, residual
    blocks scaled (``residual_scale``)."""
    convs, total = [], 0
    for name in modules.module_names():
        encoder = name.startswith("backbone")
        module = getattr(modules, name)
        for sub in module.modules():
            if isinstance(sub, torch.nn.Conv2d):
                out_ch, in_per_group, kh, kw = sub.weight.shape
                fan = out_ch * kh * kw if encoder else in_per_group * kh * kw
                scale = 2.0 if encoder else 1.0
                convs.append((sub, math.sqrt(scale / fan) / TRUNC_STD))
                total += sub.weight.numel()
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, torch.nn.BatchNorm2d):
                sub.reset_parameters()
        residual_scale(module)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=generator, device=device)
    draw.clamp_(-2.0, 2.0)
    start = 0
    for conv, std in convs:
        n = conv.weight.numel()
        conv.weight.copy_(draw[start:start + n].view_as(conv.weight) * std)
        start += n


@torch.no_grad()
def residual_scale(module) -> None:
    """Each residual block's last BatchNorm scale at 1 / sqrt(blocks)."""
    last = [getattr(sub, RESIDUAL_BLOCKS[type(sub).__name__])
            for sub in module.modules()
            if type(sub).__name__ in RESIDUAL_BLOCKS]
    for bn in last:
        bn.weight.fill_(1.0 / math.sqrt(len(last)))


@torch.no_grad()
def calibrate_batch_norm(modules, image) -> None:
    """Every BatchNorm's running statistics set to the mean and unbiased
    variance of its input on ``image`` (normalized NCHW float32): one
    forward of the depth encoder and instance head in train mode."""
    norms = [m for m in modules.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    stats = {}

    def capture(bn, args):
        stats[bn] = torch.var_mean(args[0].float(), dim=(0, 2, 3),
                                   correction=1)
    hooks = [bn.register_forward_pre_hook(capture) for bn in norms]
    modules.train()
    try:
        modules.instance_head(modules.backbone_po_depth(image))
    finally:
        modules.eval()
        for hook in hooks:
            hook.remove()
    for bn in norms:
        bn.reset_running_stats()
        if bn in stats:
            var, mean = stats[bn]
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)


@torch.no_grad()
def raise_centers(modules, image) -> float:
    """Shift the center head's bias so that ``1 - CENTER_QUANTILE`` of
    ``image``'s pixels score above ``CENTER_LEVEL``; returns the shift."""
    feats = modules.backbone_po_depth(image)
    center = modules.instance_head(feats)[0]
    shift = float(CENTER_LEVEL - torch.quantile(
        center.flatten().float()[:1 << 24], CENTER_QUANTILE))
    modules.instance_head.center_head.net.conv.bias.add_(shift)
    return shift


def made_weights(config: dict, seed: int, device, calibration_frame=None):
    """(host state dict, center shift or None) of the seeded modules of a
    configuration, made on ``device`` with the frozen copy in float32.
    ``calibration_frame``, a uint8 (H, W, 3) frame, calibrates BatchNorm
    and raises the centers."""
    from benchmark.reference import model as ref_model
    cfg = ref_model.reference_config(config, "float32")
    modules = ref_model.build(cfg, config["num_classes"], device)
    fill_seeded(modules, seed, device)
    shift = None
    if calibration_frame is not None:
        with no_tf32():
            image = ref_model.normalized_nchw(cfg, calibration_frame, device)
            calibrate_batch_norm(modules, image)
            shift = raise_centers(modules, image)
    state = {k: v.detach().to("cpu") for k, v in
             modules.state_dict().items()}
    del modules
    return state, shift
