"""The runner's own host work a frame on the main thread, in ms: the
``batch``, ``gt_map``, ``meters``, ``prefetch_wait`` and ``add`` parts of
``AdaptationRunner.frame_phases``, summed, mean over the window's
frames."""

PARTS = ("batch", "gt_map", "meters", "prefetch_wait", "add")


def read(record):
    phases = record.get("frame_phases") or {}
    if not all(phases.get(p) for p in PARTS):
        return None
    n = len(phases["batch"])
    return sum(sum(phases[p]) for p in PARTS) / n * 1e3
