"""Named host spans on the profiler's clock (port of utils/profiling.py).

Every span adds its duration to a per-name aggregate (count, total, max)
that ``timings()`` reports (the offline driver copies it into
``q_stats.json``). While a ``torch.profiler`` session runs, a span also
opens ``torch.profiler.record_function`` (so an exported trace shows it)
and appends a record to a bounded buffer that ``spans()`` reads::

    (name, start_ns, end_ns, thread native id, parent name, attrs)

stamped with ``time.time_ns()``, the clock of the profiler's events, so a
record can be placed against the device's activity of the same session.
``record()`` adds a record whose ends were stamped elsewhere, such as a
request's wait across two threads. With no session running a span costs a
flag read, two clock reads and the aggregate update, and allocates no
record.

    with profile_span("engine.copy_out", rows=64) as sp:
        buf = out.cpu().numpy()
        sp.attrs["jobs_real"] = n      # attrs the record carries
    sp.seconds                         # its duration, from the same stamps

Names carry their layer: ``frontend.*``, ``encoder.*``, ``engine.*``,
``train.*``.
"""

from __future__ import annotations

import threading
from time import time_ns
from typing import Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

MAX_RECORDS = 1 << 18

_lock = threading.Lock()
_totals: dict = {}        # name -> [count, total ns, max ns]
_records: list = []
_dropped = 0
_local = threading.local()  # .open: names of this thread's open spans


def tracing() -> bool:
    """Whether a torch profiler session runs. The flag reads True on every
    thread, also under ``profile_all_threads``, where
    ``torch.autograd._profiler_enabled()`` reads False."""
    return _autograd_profiler._is_profiler_enabled


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def _append(rec: tuple) -> None:
    global _dropped
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(rec)
        else:
            _dropped += 1


class profile_span:
    """A span named ``name`` whose record carries ``attrs``; see the
    module's docstring."""

    __slots__ = ("name", "attrs", "t0", "t1", "_region", "_parent")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._region = None

    # the stamps enclose the profiler's own region, whose first entry on a
    # thread takes ~1 ms after the profiler's start stamp
    def __enter__(self) -> "profile_span":
        self.t0 = time_ns()
        if _autograd_profiler._is_profiler_enabled:
            stack = _open()
            self._parent = stack[-1] if stack else None
            stack.append(self.name)
            self._region = record_function(self.name)
            self._region.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        region = self._region
        if region is not None:
            region.__exit__(None, None, None)
        self.t1 = t1 = time_ns()
        dt = t1 - self.t0
        _lock.acquire()       # cheaper than ``with`` on this hot path
        try:
            agg = _totals.get(self.name)
            if agg is None:
                _totals[self.name] = [1, dt, dt]
            else:
                agg[0] += 1
                agg[1] += dt
                if dt > agg[2]:
                    agg[2] = dt
        finally:
            _lock.release()
        if region is not None:
            _open().pop()
            _append((self.name, self.t0, t1, threading.get_native_id(),
                     self._parent, self.attrs))

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """A record stamped by the caller (``time.time_ns()``), kept only while
    a profiler session runs."""
    if _autograd_profiler._is_profiler_enabled:
        stack = _open()
        _append((name, start_ns, end_ns, threading.get_native_id(),
                 stack[-1] if stack else None, attrs))


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None
          ) -> list:
    """The buffer's records that overlap [t0_ns, t1_ns], in the order they
    closed."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    with _lock:
        return [r for r in _records if r[2] >= lo and r[1] <= hi]


def dropped() -> int:
    """Records the full buffer turned away since the last reset."""
    return _dropped


def reset_spans() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def timings() -> dict:
    """Wall-time summaries of all spans seen so far."""
    with _lock:
        items = [(name, list(agg)) for name, agg in _totals.items()]
    return {name: {"count": n, "total_sec": total / 1e9,
                   "mean_sec": total / n / 1e9, "max_sec": mx / 1e9}
            for name, (n, total, mx) in items}


def reset_timings() -> None:
    with _lock:
        _totals.clear()
