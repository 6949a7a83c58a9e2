"""Set-up seconds: from the harness's start to the window's (imports,
CUDA context, readers, seeded weights, buffers, loader workers and the
warm-up frames or steps, with every kernel build)."""


def read(record):
    return record.get("setup_s")
