"""Share of the profiled window in which no kernel, copy or set ran on
the card, in percent (``trace.device_busy``, copied from
``chip_smoke.device_busy``)."""


def read(record):
    profile = record.get("profile")
    if record.get("kind") != "stream" or not profile \
            or not profile["window_s"]:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / profile["window_s"])
