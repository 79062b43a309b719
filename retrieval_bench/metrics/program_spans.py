"""What the readers of the program's own spans share (not a metric). The
port records its spans and counters while a profiler session runs
(``scaling_retriever_tpu_torch.utils.profiling``: ``spans``, ``dropped``),
on ``time.time_ns()``'s clock, which is the clock of the trace's events;
so a record is placed against the device's activity as it stands.
``records``, ``idle_share`` and ``slot_fill`` return None where the port
keeps no such records, where none lies in the window, or where its buffer
dropped some."""

from __future__ import annotations

from retrieval_bench import trace


def records(rec: dict, match):
    """The port's records that overlap the traced window and whose name
    ``match`` accepts, or None."""
    tr = rec.get("trace")
    if tr is None:
        return None
    try:
        from scaling_retriever_tpu_torch.utils.profiling import (dropped,
                                                                 spans)
    except ImportError:     # a port that keeps no records
        return None
    if dropped():
        return None
    out = [r for r in spans(*tr.window) if match(r[0])]
    return out or None


def idle_share(rec: dict, match):
    """% of the traced window in which the device is idle while a span
    whose name ``match`` accepts is open, on any thread."""
    recs = records(rec, match)
    if recs is None:
        return None
    tr = rec["trace"]
    w0, w1 = tr.window
    if w1 <= w0:
        return None
    return 100.0 * idle_under(tr.device, [(a, b) for _, a, b, *_ in recs],
                              w0, w1) / (w1 - w0)


def idle_under(device: list, intervals: list, w0: int, w1: int) -> int:
    """Nanoseconds of [w0, w1] inside the union of ``intervals`` in which
    no device interval runs."""
    under = trace.merged(intervals, w0, w1)
    busy = trace.merged(device, w0, w1)
    total = sum(b - a for a, b in under)
    j = 0
    for a, b in under:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            total -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total


def slot_fill(rec: dict):
    """% of the job slots of the window's engine reads that real rows
    needed: the sums of the ``engine.copy_out`` records' ``jobs_real`` and
    ``jobs_slab``."""
    reads = records(rec, "engine.copy_out".__eq__)
    if reads is None:
        return None
    slab = sum(r[5]["jobs_slab"] for r in reads)
    if slab <= 0:
        return None
    return 100.0 * sum(r[5]["jobs_real"] for r in reads) / slab
