"""Mean host time of ``train_step`` and its stacked scalar readback over
the window's steps, in ms."""


def read(record):
    steps = record.get("step_s")
    if record.get("kind") != "train" or not steps:
        return None
    return sum(steps) / len(steps) * 1e3
