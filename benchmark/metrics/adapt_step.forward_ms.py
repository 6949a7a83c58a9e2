"""The adaptation step's forward a frame, in ms: the program's span
``step.forward`` (``AdaptationRunner.frame_phases``, from the step's
entry to the end of its losses), mean over the window's frames."""


def read(record):
    values = (record.get("frame_phases") or {}).get("step.forward")
    return sum(values) / len(values) * 1e3 if values else None
