"""The grouping kernel's wide cases on the card, and the offset layouts
the wrapper and the main paths hand it, on the CPU
(``tests/test_torch_kernels.py`` says how they run)."""

import numpy as np
import pytest
import torch

from codeps_torch.ops import grouping
from torch_kernel_cases import (CASE_NAMES, CASES, THINGS, check_matches_plain)
from torch_kernel_cases import few_threads  # noqa: F401 (autouse)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nhwc", "nchw_view"])
@pytest.mark.parametrize("case", CASE_NAMES[11:])
def test_group_pixels_cuda_matches_plain(case, layout):
    check_matches_plain(case, layout)


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
