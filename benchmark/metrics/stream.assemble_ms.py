"""The runner's assembly of a frame's batch on the host, in ms: the
program's span ``batch.assemble`` (``AdaptationRunner.frame_phases``:
the eval GT and ``_adapt_batch``), mean over the window's frames."""


def read(record):
    values = (record.get("frame_phases") or {}).get("batch.assemble")
    return sum(values) / len(values) * 1e3 if values else None
