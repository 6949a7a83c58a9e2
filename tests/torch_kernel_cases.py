"""Inputs and checks shared by ``tests/test_torch_kernels*.py``: the
grouping kernel's cases, the bad inputs its wrapper rejects, and the
check of a case on the card against the plain version. Imports no JAX.
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
CASE_NAMES = sorted(CASES)


def _nchw_view(offsets):
    """The NHWC view of an NCHW copy of ``offsets``: the layout the
    instance head hands to fusion."""
    return offsets.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def check_matches_plain(case, layout):
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


BAD_INPUTS = _bad_inputs()
