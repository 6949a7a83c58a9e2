"""The main thread's time in the adaptation step a frame
(``frame_phases["step"]``), mean over the window's frames, in ms."""


def read(record):
    steps = (record.get("frame_phases") or {}).get("step")
    return sum(steps) / len(steps) * 1e3 if steps else None
