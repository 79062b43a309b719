"""The 99th percentile, over the window's answered text requests, of the
wait from ``submit_text`` until their tile's dispatch started (the port's
``frontend.request`` records), in ms."""

import numpy as np

from retrieval_bench.metrics import program_spans


def read(rec):
    reqs = program_spans.records(rec, "frontend.request".__eq__)
    if reqs is None:
        return None
    waits = [r[5]["dispatch_ns"] - r[1] for r in reqs]
    return float(np.percentile(waits, 99)) / 1e6
