"""95th percentile of the window's frame times (host clock between the
runner's ``on_frame`` marks), in ms."""

import statistics


def read(record):
    frames = record.get("frame_s") or []
    if len(frames) < 20:
        return None
    return statistics.quantiles(frames, n=20)[18] * 1e3
