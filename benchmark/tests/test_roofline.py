"""The roofline and FLOP arithmetic, pinned to hand-counted values."""

import pytest
import torch

from benchmark import roofline


def test_grouping_bound_bytes():
    # 1 x 384 x 1408, 0 valid: (384*1408*12 + 200*9) bytes at 3.35 TB/s
    seconds, by = roofline.grouping_bound_batch(1, 384, 1408, [0])
    assert by == "bytes"
    assert seconds == pytest.approx((384 * 1408 * 12 + 1800) / 3.35e12)


def test_grouping_bound_operations():
    # 2 x 384 x 1408 with 199 + 15 valid: 5 * 384*1408 * 214 FP32 ops
    seconds, by = roofline.grouping_bound_batch(2, 384, 1408, [199, 15])
    assert by == "operations"
    assert seconds == pytest.approx(5 * 384 * 1408 * 214 / 67e12)
    assert seconds * 1e6 == pytest.approx(8.635, abs=1e-3)


def test_peaks():
    assert roofline.BF16_FLOPS_PER_S == 989e12
    assert roofline.mfu_pct(989e12, 0.5) == pytest.approx(50.0)


def test_one_conv_forward_and_backward():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    x = torch.randn(2, 3, 16, 16, requires_grad=True)
    forward = 2 * 2 * 8 * 16 * 16 * 3 * 3 * 3
    _, flops = roofline.count_flops(lambda: conv(x))
    assert flops == forward
    _, flops = roofline.count_flops(lambda: conv(x).sum().backward())
    # input and weight gradients, each as many as the forward
    assert flops == 3 * forward


def test_small_encoder():
    from benchmark.reference.codeps_ref.models.resnet import ResNetEncoder
    encoder = ResNetEncoder(18)
    x = torch.randn(1, 3, 64, 96)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((mod, out.shape)))
        for m in encoder.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        encoder(x)
    for hook in hooks:
        hook.remove()
    by_hand = sum(2 * out[0] * out[2] * out[3] * mod.out_channels
                  * mod.in_channels // mod.groups * mod.kernel_size[0]
                  * mod.kernel_size[1] for mod, out in shapes)
    with torch.no_grad():
        _, flops = roofline.count_flops(lambda: encoder(x))
    assert flops == by_hand > 0
