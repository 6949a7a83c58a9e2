"""The adaptation step's update a frame, in ms: the program's span
``step.update`` (``AdaptationRunner.frame_phases``: the skip ring's push,
the learning rate, Adam, the EMA blend and the metric dict), mean over
the window's frames."""


def read(record):
    values = (record.get("frame_phases") or {}).get("step.update")
    return sum(values) / len(values) * 1e3 if values else None
