"""The traced run's reading of the device: a ``torch.profiler`` session
over the measured window, reduced to plain records and sums.

``Trace.summarize`` turns the profiler's events into ``Summary``: the
device's activity (kernels, copies, sets) as intervals, the benchmark's
host spans (``record_function`` names starting ``rb.``), and, for each
span name, the device time of the work launched inside it (a launch
belongs to the span open on its thread when it was issued). The
functions below it are pure, so tests feed them records.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import heapq

import torch

SPAN_PREFIX = "rb."
WINDOW_SPAN = "rb.window"


@contextlib.contextmanager
def span(name: str):
    """A host span the trace can read (a no-op when nothing profiles)."""
    with torch.profiler.record_function(name):
        yield


@dataclasses.dataclass
class Summary:
    window: tuple          # (start_ns, end_ns) of the rb.window span
    device: list           # (start_ns, end_ns, name, corr)
    spans: list            # (name, start_ns, end_ns, thread)
    launches: dict         # corr -> (start_ns, thread)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return sum(b - a for a, b in merged(self.device, *self.window)) / 1e9

    def span_device_s(self, names) -> float:
        """Device seconds of the work launched inside spans of ``names``."""
        return span_device_ns(self.device, self.spans, self.launches,
                              set(names)) / 1e9

    def breakdown(self, n: int = 10) -> dict:
        return {"device_ops": top_ops(self.device, *self.window, n),
                "idle_gaps": idle_gaps(self.device, self.spans,
                                       *self.window, n)}


class Trace:
    """Profiles the device and host while active."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # the serving path's spans open on the frontend's and the server's
        # threads, not on the one that starts the profiler
        every_thread = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        self.prof = torch.profiler.profile(activities=acts,
                                           experimental_config=every_thread)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def summarize(self) -> Summary:
        device, spans, launches, window = [], [], {}, None
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() != torch.autograd.DeviceType.CPU:
                if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
                    continue
                device.append((start, end, name, e.correlation_id()))
            elif name == WINDOW_SPAN:
                window = (start, end)
            elif name.startswith(SPAN_PREFIX):
                spans.append((name, start, end, e.start_thread_id()))
            elif e.correlation_id() and name.startswith("cu"):
                launches[e.correlation_id()] = (start, e.start_thread_id())
        if window is None:
            raise RuntimeError("the trace holds no rb.window span")
        return Summary(window, device, spans, launches)


def merged(device: list, w0: int, w1: int) -> list:
    """The union of the device intervals, clipped to [w0, w1]."""
    out: list = []
    for a, b, *_ in sorted(device):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def span_device_ns(device: list, spans: list, launches: dict,
                   names: set) -> int:
    by_thread = collections.defaultdict(list)
    for name, a, b, th in spans:
        if name in names:
            by_thread[th].append((a, b))
    starts = {th: sorted(v) for th, v in by_thread.items()}
    keys = {th: [a for a, _ in v] for th, v in starts.items()}
    total = 0
    for a, b, _, corr in device:
        launch = launches.get(corr)
        if launch is None or launch[1] not in starts:
            continue
        t, th = launch
        j = bisect.bisect_right(keys[th], t) - 1
        if j >= 0 and starts[th][j][0] <= t <= starts[th][j][1]:
            total += b - a
    return total


def top_ops(device: list, w0: int, w1: int, n: int) -> list:
    by = collections.Counter()
    for a, b, name, _ in device:
        if a < w1 and b > w0:
            by[name[:120]] += (min(b, w1) - max(a, w0)) / 1e9
    return [[k, v] for k, v in by.most_common(n)]


def idle_gaps(device: list, spans: list, w0: int, w1: int, n: int) -> list:
    """Idle device seconds, by the host spans open at each gap's middle
    ("no span" where none is)."""
    busy = merged(device, w0, w1)
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    by = collections.Counter()
    order = sorted(spans, key=lambda s: s[1])
    live: list = []                      # heap of (end, name)
    active = collections.Counter()
    j = 0
    for a, b in gaps:                    # gaps are in time order
        mid = (a + b) // 2
        while j < len(order) and order[j][1] <= mid:
            heapq.heappush(live, (order[j][2], order[j][0]))
            active[order[j][0]] += 1
            j += 1
        while live and live[0][0] < mid:
            _, name = heapq.heappop(live)
            active[name] -= 1
        open_ = sorted(k for k, c in active.items() if c > 0)
        by["+".join(open_) or "no span"] += (b - a) / 1e9
    return [[k, v] for k, v in by.most_common(n)]
