"""Adapted frames completed in the window over its seconds (host clock,
the card synchronized at both ends)."""


def read(record):
    return record.get("rate") if record.get("kind") == "stream" else None
