"""Mean host time from the end of a step's readback to the arrival of the
next batch from the loader, over the window's steps, in ms."""


def read(record):
    waits = record.get("wait_s")
    if record.get("kind") != "train" or not waits:
        return None
    return sum(waits) / len(waits) * 1e3
