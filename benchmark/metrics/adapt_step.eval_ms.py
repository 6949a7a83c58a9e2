"""The teacher eval inside the adaptation step a frame, in ms: the
program's span ``step.eval`` (``AdaptationRunner.frame_phases``), mean
over the window's frames."""


def read(record):
    values = (record.get("frame_phases") or {}).get("step.eval")
    return sum(values) / len(values) * 1e3 if values else None
