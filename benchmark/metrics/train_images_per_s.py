"""Images of the optimizer steps completed in the window over its seconds,
the loader's wait included (host clock; each step ends in its scalar
readback)."""


def read(record):
    return record.get("rate") if record.get("kind") == "train" else None
