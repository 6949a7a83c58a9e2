"""The runner's upload of a frame's batch and eval GT to the card, in ms:
the program's span ``batch.upload`` (``AdaptationRunner.frame_phases``),
mean over the window's frames."""


def read(record):
    values = (record.get("frame_phases") or {}).get("batch.upload")
    return sum(values) / len(values) * 1e3 if values else None
