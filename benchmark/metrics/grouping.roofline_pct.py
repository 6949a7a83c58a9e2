"""The grouping kernel's share of its roofline over the profiled frames,
in percent: the bound of each call (offsets read and ids written once,
5 FP32 operations per pixel and valid center, ``roofline.py``) summed,
over the kernel's device time from the profiler."""

from benchmark.roofline import grouping_bound_batch

KERNEL = "group_pixels_kernel"


def read(record):
    profile = record.get("profile") or {}
    launches, seconds = profile.get("kernels", {}).get(KERNEL, (0, 0.0))
    calls = record.get("grouping_calls") or []
    if not launches or not seconds or launches != len(calls):
        return None
    bound = sum(grouping_bound_batch(*shape, valid)[0]
                for shape, valid in calls)
    return 100.0 * bound / seconds
