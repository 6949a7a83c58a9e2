"""The hand-written CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so on a machine with a card it runs without
the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tests marked ``gpu`` need a card and skip where none is visible; the
kernels must equal their plain versions exactly. The others run on the
CPU: the wrapper's layout handling and its checks, which raise before
anything reaches a card.
"""

import numpy as np
import pytest
import torch

from codeps_torch.ops import grouping

THINGS = (9, 10, 11, 12, 13)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cases():
    """name -> (centers (B, K, 2), valid (B, K), offsets (B, H, W, 2))."""
    rng = np.random.default_rng(17)
    height, width, k = 48, 200, 24
    cases = {}

    def one(valid_share, nan_share=0.0, ties=False, k=k, height=height,
            width=width):
        yx = rng.uniform([0, 0], [height, width], (k, 2))
        valid = rng.random(k) < valid_share
        offsets = rng.normal(0, 5, (height, width, 2))
        if nan_share:
            offsets[rng.random((height, width)) < nan_share, 0] = np.nan
        if ties:
            yx = np.round(yx)
            yx[1::2] = yx[0::2]
            offsets = np.round(offsets)
        return (yx.astype(np.float32), valid, offsets.astype(np.float32))

    cases["random"] = [one(0.7)]
    cases["no_valid"] = [one(0.0)]
    cases["nan_offsets"] = [one(0.8, nan_share=0.1)]
    cases["duplicate_centers"] = [one(0.9, ties=True)]
    cases["k_13"] = [one(0.6, k=13)]
    cases["batch_of_3"] = [one(0.5), one(0.0), one(1.0, nan_share=0.05)]
    # odd width: the scalar path; H = 37 is not a multiple of the kernel's
    # 16-row tile; W = 200 takes the vector path with a ragged last tile
    cases["odd_width_197"] = [one(0.7, height=21, width=197)]
    cases["ragged_rows_37"] = [one(0.7, height=37, width=200)]
    cases["k_1"] = [one(1.0, k=1)]
    cases["k_2048"] = [one(0.3, k=2048, height=16, width=128)]
    # the widths of the SemKITTI-DVPS frames and of Cityscapes val
    cases["width_1280"] = [one(0.7, height=16, width=1280)]
    cases["width_1024"] = [one(0.7, height=16, width=1024)]
    cases = {name: tuple(torch.from_numpy(np.stack(parts))
                         for parts in zip(*images))
             for name, images in cases.items()}
    # valid centers that are not a prefix: every third slot
    yx, _, offsets = cases["random"]
    valid = (torch.arange(yx.shape[1]) % 3 == 1)[None]
    cases["valid_not_prefix"] = (yx, valid, offsets)
    return cases


CASES = _cases()


def _nchw_view(offsets):
    """The NHWC view of an NCHW copy of ``offsets``: the layout the
    instance head hands to fusion."""
    return offsets.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nhwc", "nchw_view"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_group_pixels_cuda_matches_plain(case, layout):
    """Truly NHWC offsets are copied once; the NHWC view of NCHW offsets,
    the instance head's layout, is read in place. One launch either way."""
    _needs_card()
    yx, valid, offsets = (t.cuda() for t in CASES[case])
    given = offsets if layout == "nhwc" else _nchw_view(offsets)
    launches = grouping.group_pixels_cuda.launches
    copies = grouping.group_pixels_cuda.copies
    ours = grouping.group_pixels(yx, valid, given)
    assert grouping.group_pixels_cuda.launches == launches + 1
    assert grouping.group_pixels_cuda.copies \
        == copies + (layout == "nhwc")
    ref = grouping.group_pixels_plain(yx, valid, offsets)
    torch.cuda.synchronize()
    assert ours.dtype == torch.int32
    assert torch.equal(ours, ref)


@pytest.mark.gpu
def test_group_pixels_cuda_unaligned_planes():
    """Planes that start 4 bytes past a 16-byte boundary take the scalar
    path."""
    _needs_card()
    yx, valid, offsets = (t.cuda() for t in CASES["random"])
    planes = offsets.permute(0, 3, 1, 2)
    buffer = torch.empty(planes.numel() + 1, device="cuda")
    buffer[1:] = planes.flatten()
    view = buffer[1:].view(planes.shape).permute(0, 2, 3, 1)
    ours = grouping.group_pixels_cuda(yx, valid, view)
    torch.cuda.synchronize()
    assert torch.equal(ours, grouping.group_pixels_plain(yx, valid, offsets))


def test_offset_planes_reads_the_nchw_view_in_place():
    _, _, offsets = CASES["batch_of_3"]
    nchw = offsets.permute(0, 3, 1, 2).contiguous()
    copies = grouping.group_pixels_cuda.copies
    planes = grouping.offset_planes(nchw.permute(0, 2, 3, 1))
    assert planes.data_ptr() == nchw.data_ptr()
    assert planes.is_contiguous()
    torch.testing.assert_close(planes, nchw, rtol=0, atol=0, equal_nan=True)
    assert grouping.group_pixels_cuda.copies == copies


def test_offset_planes_copies_truly_nhwc_offsets_once():
    _, _, offsets = CASES["batch_of_3"]
    copies = grouping.group_pixels_cuda.copies
    planes = grouping.offset_planes(offsets)
    assert grouping.group_pixels_cuda.copies == copies + 1
    assert planes.is_contiguous()
    assert tuple(planes.shape) == (3, 2, *offsets.shape[1:3])
    torch.testing.assert_close(planes, offsets.permute(0, 3, 1, 2), rtol=0,
                               atol=0, equal_nan=True)


def _bad_inputs():
    yx, valid, offsets = CASES["random"]
    meta = torch.empty(offsets.shape, device="meta")
    return {
        "offsets_3_channels": ((yx, valid, offsets[..., [0, 1, 1]]),
                               ValueError, "offsets must be"),
        "offsets_unbatched": ((yx, valid, offsets[0]), ValueError,
                              "offsets must be"),
        "centers_batch": ((yx[:, :, :1].expand(2, -1, 2), valid, offsets),
                          ValueError, "centers must be"),
        "valid_length": ((yx, valid[:, :-1], offsets), ValueError,
                         "valid must be"),
        "too_many_centers": ((torch.zeros(1, 2049, 2),
                              torch.ones(1, 2049, dtype=torch.bool),
                              offsets), ValueError, "at most 2048"),
        "offsets_float64": ((yx, valid, offsets.double()), TypeError,
                            "offsets must be torch.float32"),
        "centers_int": ((yx.int(), valid, offsets), TypeError,
                        "centers must be torch.float32"),
        "valid_uint8": ((yx, valid.to(torch.uint8), offsets), TypeError,
                        "valid must be torch.bool"),
        "cpu_tensors": ((yx, valid, offsets), ValueError,
                        "takes CUDA tensors"),
        "meta_tensors": ((yx, valid, meta), ValueError,
                         "takes CUDA tensors"),
    }


BAD_INPUTS = _bad_inputs()


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_group_pixels_cuda_rejects_bad_inputs(case):
    """Wrong shapes, types and devices raise before any launch or copy."""
    args, error, match = BAD_INPUTS[case]
    launches = grouping.group_pixels_cuda.launches
    copies = grouping.group_pixels_cuda.copies
    with pytest.raises(error, match=match):
        grouping.group_pixels_cuda(*args)
    assert grouping.group_pixels_cuda.launches == launches
    assert grouping.group_pixels_cuda.copies == copies


def test_main_paths_hand_fusion_the_head_planes():
    """The facade and the teacher eval pass fusion the NHWC view of the
    instance head's NCHW offsets, which the kernel reads without a copy
    (checked here on the CPU, where fusion itself takes the plain
    version)."""
    from codeps_torch.config import get_cfg_defaults_adapt
    from codeps_torch.models import CodepsNet, build_modules, init_params
    from codeps_torch.tasks.adapt import build_eval_forward
    cfg = get_cfg_defaults_adapt()
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.dataset.feed_img_size = [32, 64]
    modules = init_params(build_modules(cfg, 14, device="cpu"), seed=0,
                          device="cpu")
    image = np.random.default_rng(0).integers(0, 256, (1, 32, 64, 3),
                                              dtype=np.uint8)
    served = CodepsNet(modules, thing_list=THINGS, device="cpu")(
        image, mode="eval")
    evaluated, _ = build_eval_forward(cfg, THINGS, 14)(
        modules, {"image": torch.from_numpy(image)})
    copies = grouping.group_pixels_cuda.copies
    for result in (served, evaluated):
        offsets = result["offset"]
        assert tuple(offsets.shape) == (1, 32, 64, 2)
        planes = grouping.offset_planes(offsets)
        assert planes.data_ptr() == offsets.data_ptr()
    assert grouping.group_pixels_cuda.copies == copies


@pytest.mark.parametrize("size", [(384, 1280), (512, 1024)])
def test_validation_hands_the_kernel_aligned_gt_planes(size):
    """Validation uploads the GT offsets as (2, H, W) planes: at the widths
    of the SemKITTI-DVPS frames and of Cityscapes val the kernel reads
    them in place, 16-byte aligned with W % 4 == 0 (its vector path)."""
    from codeps_torch.tasks.validate import _to_device
    height, width = size
    offsets = np.random.default_rng(1).normal(
        0, 5, (1, height, width, 2)).astype(np.float32)
    batch = _to_device({"offset": offsets}, "cpu")
    copies = grouping.group_pixels_cuda.copies
    planes = grouping.offset_planes(batch["offset"])
    assert grouping.group_pixels_cuda.copies == copies
    assert planes.data_ptr() == batch["offset"].data_ptr()
    assert planes.data_ptr() % 16 == 0 and width % 4 == 0
    np.testing.assert_array_equal(planes.permute(0, 2, 3, 1).numpy(),
                                  offsets)


def test_group_pixels_cuda_rejects_cpu_tensors():
    yx, valid, offsets = CASES["random"]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        grouping.group_pixels_cuda(yx, valid, offsets)


def test_group_pixels_dispatch_takes_plain_on_cpu():
    """CPU tensors take the plain version (single images and batches),
    and launch nothing."""
    yx, valid, offsets = CASES["batch_of_3"]
    before = grouping.group_pixels_cuda.launches
    batched = grouping.group_pixels(yx, valid, offsets)
    assert torch.equal(batched,
                       grouping.group_pixels_plain(yx, valid, offsets))
    for b in range(3):
        assert torch.equal(grouping.group_pixels(yx[b], valid[b],
                                                 offsets[b]), batched[b])
    assert grouping.group_pixels_cuda.launches == before
    assert int(batched[1].abs().max()) == 0          # no valid center
