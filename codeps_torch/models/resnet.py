"""ResNet encoder (NCHW) with the reference's state-dict layout.

Counterpart of ``codeps_tpu/models/resnet.py:116-267``: torchvision-v1.5
ResNet-{18,34,50,101,152} returning the pyramid [conv1+relu, layer1..4]
with channels [64, 64, 128, 256, 512] (x4 from layer1 up for bottleneck
variants), eps 1e-5. conv1 is the plain 7x7/stride 2 (the JAX package's
space-to-depth fold is a TPU rewrite of the same conv) over
``num_input_images * num_channels_input`` channels: 3 for the depth
encoder, 6 for the pose encoder, which takes two frames stacked on the
channel axis (8 with the flow head: RGB-D frames). Parameter names
follow the reference checkpoints:
``encoder.conv1.weight``, ``encoder.layer3.22.conv2.weight``,
``encoder.layer1.0.downsample.1.running_mean``.

BatchNorm (``BatchNorm2d`` below) in eval mode normalizes with the
running statistics. In train mode it normalizes with the batch's
statistics and moves the running ones as Flax's ``nn.BatchNorm``
(momentum 0.9) does, with the biased batch variance: the JAX pretraining
step keeps those updates. After ``keep_running_stats`` it leaves the
running statistics as they are: the JAX adaptation step discards Flax's
``batch_stats`` updates.

The encoder runs in its ``compute_dtype`` (``models/precision.py``); its
feature maps come out in that dtype. Its convs and max-pool are the
row-split layers of ``parallel/spatial.py``: inside a row split they run
on this rank's slab with their neighbours' rows as a halo.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from codeps_torch import parallel
from codeps_torch.models.precision import ComputeDtype
from codeps_torch.parallel.spatial import Conv2d, MaxPool2d

_STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization over the global batch of the
    process group (SyncBN), in plain PyTorch for CPU tensors: each rank's
    (count, mean, M2) per channel are gathered and combined by Chan's
    parallel rule; the backward all-reduces the per-channel sums of the
    output gradient and of its product with the normalized input.
    Statistics and arithmetic in float32 (float64 for a float64 input);
    the output in the input's dtype. Returns (output, mean, biased
    variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dtype = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(dtype)
        count = x.numel() // x.shape[1]
        var_r, mean_r = torch.var_mean(xs, dim=(0, 2, 3), correction=0)
        local = torch.stack([torch.full_like(mean_r, count), mean_r,
                             var_r * count])
        n_r, mean_r, m2_r = parallel.all_gather(local).unbind(1)
        n = n_r.sum(0)
        mean = (n_r * mean_r).sum(0) / n
        var = (m2_r.sum(0) + (n_r * (mean_r - mean) ** 2).sum(0)) / n
        invstd = torch.rsqrt(var + eps)
        scale = (weight.to(dtype) * invstd)[:, None, None]
        out = (xs - mean[:, None, None]) * scale \
            + bias.to(dtype)[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad_out, _grad_mean, _grad_var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dtype = mean.dtype
        g = grad_out.to(dtype)
        xhat = (x.to(dtype) - mean[:, None, None]) * invstd[:, None, None]
        sum_g = g.sum(dim=(0, 2, 3))
        sum_gx = (g * xhat).sum(dim=(0, 2, 3))
        total = parallel.all_reduce(torch.stack([sum_g, sum_gx]))
        dx = (weight.to(dtype) * invstd)[:, None, None] * (
            g - (total[0] / n)[:, None, None]
            - xhat * (total[1] / n)[:, None, None])
        return (dx.to(x.dtype), sum_gx.to(weight.dtype),
                sum_g.to(weight.dtype), None)


class _GlobalBatchNormCuda(torch.autograd.Function):
    """``_GlobalBatchNorm`` for CUDA tensors, on the fused kernels of
    torch's ``SyncBatchNorm`` (``torch.batch_norm_stats`` and friends;
    they have no CPU version): per-rank mean and inverse deviation by
    Welford in float32 (float64 for a float64 input), gathered with the
    counts and combined by Chan's rule, the backward's two per-channel
    sums all-reduced. The running statistics are left to the caller
    (torch's would move the variance with the unbiased one), which gets
    the biased variance back as ``invstd**-2 - eps``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = x.contiguous()
        mean_r, invstd_r = torch.batch_norm_stats(x, eps)
        count = mean_r.new_full((1,), x.numel() // x.shape[1])
        mean_all, invstd_all, counts = parallel.all_gather(
            torch.cat([mean_r, invstd_r, count])).split(x.shape[1], dim=1)
        counts = counts.reshape(-1)
        # scratch running statistics (momentum 0) set the kernel's type to
        # the statistics'; without them it is the input's, and the counts
        # of a bfloat16 input would be bfloat16
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, mean_all, invstd_all, torch.zeros_like(mean_r),
            torch.ones_like(mean_r), 0.0, eps, counts)
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        var = invstd.pow(-2) - eps
        ctx.mark_non_differentiable(mean, var)
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd,
                                      eps), mean, var

    @staticmethod
    def backward(ctx, grad_out, _grad_mean, _grad_var):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        sum_dy, sum_dy_xmu, grad_weight, grad_bias = \
            torch.batch_norm_backward_reduce(grad_out, x, mean, invstd,
                                             weight, True, True, True)
        sum_dy, sum_dy_xmu = parallel.all_reduce(
            torch.cat([sum_dy, sum_dy_xmu])).split(x.shape[1])
        grad_in = torch.batch_norm_backward_elemt(
            grad_out, x, mean, invstd, weight.to(mean.dtype), sum_dy,
            sum_dy_xmu, counts)
        return grad_in, grad_weight, grad_bias, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state-dict keys)
    whose train-mode update of the running variance takes the *biased*
    batch variance, as Flax's does; torch's own takes the unbiased one,
    n / (n - 1) larger. ``momentum`` None is the cumulative average, as in
    torch. The statistics are computed in float32 whatever the input's
    dtype (float64 for a float64 input).

    Inside a process group of several ranks (``parallel/dist.py``) train
    mode takes the statistics of the global batch, for the output, the
    running statistics and the backward, as the JAX package's sharded
    step does (``codeps_tpu/tasks/train.py:8-12``), also after
    ``keep_running_stats`` (the global batch of a row split,
    ``parallel/spatial.py``, is every rank's rows); a group of one takes
    the single-process path."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global_batch = parallel.group_size() > 1
        if not self.training or not (self.track_running_stats
                                     or global_batch):
            return super().forward(x)
        if not self.track_running_stats:
            # train mode after keep_running_stats, over the global batch
            fn = _GlobalBatchNormCuda if x.is_cuda else _GlobalBatchNorm
            return fn.apply(x, self.weight, self.bias, self.eps)[0]
        if global_batch:
            fn = _GlobalBatchNormCuda if x.is_cuda else _GlobalBatchNorm
            out, mean, var = fn.apply(x, self.weight, self.bias, self.eps)
        else:
            out = F.batch_norm(x, None, None, self.weight, self.bias, True,
                               0.0, self.eps)
        with torch.no_grad():
            if not global_batch:
                var, mean = torch.var_mean(
                    x.to(torch.promote_types(x.dtype, torch.float32)),
                    dim=(0, 2, 3), correction=0)
            self.num_batches_tracked.add_(1)
            factor = (1.0 / float(self.num_batches_tracked)
                      if self.momentum is None else self.momentum)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    factor)
            self.running_var.lerp_(var.to(self.running_var.dtype), factor)
        return out


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        # torchvision v1.5 puts the stride on the 3x3 conv.
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class _Trunk(nn.Module):
    """torchvision's ResNet without the classifier."""

    def __init__(self, num_layers: int, in_channels: int):
        super().__init__()
        kind, stage_sizes = _STAGES[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, count in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            out_ch = planes * block.expansion
            downsample = None
            if stride != 1 or inplanes != out_ch:
                downsample = nn.Sequential(
                    Conv2d(inplanes, out_ch, 1, stride, bias=False),
                    BatchNorm2d(out_ch))
            blocks = [block(inplanes, planes, stride, downsample)]
            blocks += [block(out_ch, planes) for _ in range(count - 1)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            inplanes = out_ch


class ResNetEncoder(ComputeDtype, nn.Module):
    """Multi-scale feature encoder: (B, C, H, W) -> five NCHW maps at
    strides 2, 4, 8, 16, 32."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 num_channels_input: int = 3):
        super().__init__()
        if num_layers not in _STAGES:
            raise ValueError(f"Unsupported ResNet depth: {num_layers}")
        self.num_layers = num_layers
        self.encoder = _Trunk(num_layers, num_input_images * num_channels_input)

    @property
    def num_ch_enc(self) -> tuple[int, ...]:
        scale = 4 if self.num_layers > 34 else 1
        return (64, 64 * scale, 128 * scale, 256 * scale, 512 * scale)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        enc = self.encoder
        with self.autocast(x):
            feats = [enc.relu(enc.bn1(enc.conv1(x)))]
            feats.append(enc.layer1(enc.maxpool(feats[-1])))
            feats.append(enc.layer2(feats[-1]))
            feats.append(enc.layer3(feats[-1]))
            feats.append(enc.layer4(feats[-1]))
        return feats


def make_encoder(num_layers: int, num_input_images: int = 1,
                 num_channels_input: int = 3) -> ResNetEncoder:
    """An encoder, with the reference's rule that a multi-image or non-RGB
    input needs ResNet-18 or ResNet-50 (``resnet_encoder.py:54``)."""
    if (num_input_images > 1 or num_channels_input != 3) \
            and num_layers not in (18, 50):
        raise ValueError("Multi-image input requires ResNet-18 or ResNet-50")
    return ResNetEncoder(num_layers, num_input_images, num_channels_input)


def keep_running_stats(module: nn.Module) -> nn.Module:
    """Make every BatchNorm in ``module`` normalize with batch statistics in
    train mode without updating its running statistics; eval mode still
    uses them. (``nn.BatchNorm2d`` with ``track_running_stats`` off and its
    buffers kept does exactly that.)"""
    for sub in module.modules():
        if isinstance(sub, nn.BatchNorm2d):
            sub.track_running_stats = False
    return module
