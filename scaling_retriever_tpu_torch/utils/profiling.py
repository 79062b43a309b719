"""Named host spans and profiler hooks (port of utils/profiling.py).

Every span records its wall time on the host; ``timings()`` summarizes
them (the offline driver copies the table into ``q_stats.json``). Inside a
running ``torch.profiler`` session a span also opens
``torch.profiler.record_function``, so the trace carries the driver's span
names next to the kernels. With ``SRT_PROFILE_DIR`` set (or ``profile_dir``
given), a span runs its own profiler and writes a Chrome trace to
``<dir>/<name>/trace.json``; such spans do not nest, as in the reference.

    with profile_span("encode"):
        reps = model.encode(...)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

_PROFILE_DIR = os.environ.get("SRT_PROFILE_DIR")

_TIMINGS: dict[str, list] = {}


def profiling_enabled() -> bool:
    return _PROFILE_DIR is not None


@contextlib.contextmanager
def profile_span(name: str, profile_dir: Optional[str] = None
                 ) -> Iterator[None]:
    """Time the span on the host; trace it when profiling is enabled."""
    target = profile_dir or _PROFILE_DIR
    prof = None
    if target:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    region = (torch.profiler.record_function(name)
              if torch.autograd._profiler_enabled() else None)
    if region is not None:
        region.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if region is not None:
            region.__exit__(None, None, None)
        if prof is not None:
            prof.__exit__(None, None, None)
            out = os.path.join(target, name)
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
        _TIMINGS.setdefault(name, []).append(dt)


def annotate(name: str):
    """A named region in the profiler's trace (a context manager)."""
    return torch.profiler.record_function(name)


def timings() -> dict:
    """Wall-time summaries of all spans seen so far."""
    return {
        name: {"count": len(ts), "total_sec": sum(ts),
               "mean_sec": sum(ts) / len(ts), "max_sec": max(ts)}
        for name, ts in _TIMINGS.items() if ts
    }


def reset_timings() -> None:
    _TIMINGS.clear()
