"""The device's idle share of the traced training window."""

from retrieval_bench import readers


def read(rec):
    return readers.device_idle(rec)
