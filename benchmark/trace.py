"""The traced part of a run: ``torch.profiler`` over a few steady frames
or steps after the measured window, and what is read from it.

``device_busy`` is copied from ``chip_smoke.py``: the union of the card's
kernels, copies and sets, overlaps counted once. Idle gaps are named by
the innermost span that the benchmark placed around a call into the port
(``record_function``) and, where none covers the gap, by the innermost host
operation running at its middle.
"""

from __future__ import annotations

import bisect

import torch

# names of the benchmark's own spans around calls into the port
SPAN_PREFIX = "bench."
TOP = 10


def _annotation(event) -> bool:
    """A host span mirrored on the card's timeline (``record_function``,
    the optimizer's ``Optimizer.step#Adam.step``), not device work."""
    return bool(getattr(event, "is_user_annotation", False)) \
        or event.name.startswith((SPAN_PREFIX, "ProfilerStep",
                                  "Optimizer."))


def _device_events(events):
    """The card's kernels, copies and sets."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not _annotation(e)]


def device_busy(events):
    """(busy us, merged intervals) of the card's events."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(events))
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _namer(events):
    """name(t_us): what the host was doing at ``t_us``."""
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in host), key=lambda x: x[0])
    starts = [s for s, _, _ in spans]

    def name(t):
        covering = [(e - s, n) for s, e, n in
                    spans[:bisect.bisect_right(starts, t)] if e >= t]
        ours = [c for c in covering if c[1].startswith(SPAN_PREFIX)]
        pick = min(ours or covering, default=None)
        inner = min(covering, default=None)
        if pick is None:
            return "host (no recorded operation)"
        if ours and inner is not None and inner[1] != pick[1]:
            return f"{pick[1][len(SPAN_PREFIX):]}: {inner[1]}"
        return pick[1].removeprefix(SPAN_PREFIX)
    return name


def summarize(events, window_s: float, kernel_names=()):
    """busy_s, window_s and the breakdown of a profiled window; with
    ``kernel_names`` also each such kernel's (launches, device seconds)."""
    busy_us, merged = device_busy(events)
    by_name = {}
    for e in _device_events(events):
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    name = _namer(events)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    kernels = {}
    for kernel in kernel_names:
        hits = [e for e in _device_events(events) if kernel in e.name]
        kernels[kernel] = (len(hits), sum(
            e.time_range.end - e.time_range.start for e in hits) / 1e6)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "breakdown": {
            "device_ops": [[n[:160], us / 1e6] for n, us in device_ops],
            "idle_gaps": [[name(mid)[:160], us / 1e6] for us, mid in gaps]},
        "kernels": kernels,
    }


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str):
    """A host span of the benchmark's around a call into the port."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def wrap(fn, name: str):
    """``fn`` inside ``span(name)``."""
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapped
