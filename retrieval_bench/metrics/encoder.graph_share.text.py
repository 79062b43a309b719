"""% of the traced text window's tiles (the port's ``frontend.dispatch``
records wholly inside the window) whose encoder ran as one replayed CUDA
graph: an ``encoder.graph`` record on the tile's thread, inside its
dispatch. None where the port keeps no ``encoder.graph`` records."""

import bisect

from retrieval_bench.metrics import program_spans


def read(rec):
    tiles = program_spans.records(rec, "frontend.dispatch".__eq__)
    graphs = program_spans.records(rec, "encoder.graph".__eq__)
    if tiles is None or graphs is None:
        return None
    w0, w1 = rec["trace"].window
    tiles = [r for r in tiles if w0 <= r[1] and r[2] <= w1]
    if not tiles:
        return None
    starts = {}
    for _, a, b, thread, *_ in sorted(graphs, key=lambda r: r[1]):
        starts.setdefault(thread, []).append((a, b))
    graphed = 0
    for _, a, b, thread, *_ in tiles:
        inner = starts.get(thread, [])
        i = bisect.bisect_left(inner, (a,))
        graphed += i < len(inner) and inner[i][1] <= b
    return 100.0 * graphed / len(tiles)
