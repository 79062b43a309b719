"""The open loop and its latency arithmetic: every request timed from
when it was due, failed and unanswered ones counted at the deadline, the
percentiles over all requests."""

from __future__ import annotations

import time
from concurrent.futures import Future

import numpy as np

from retrieval_bench.kinds import text_serving as ts


def test_latency_runs_from_the_due_time_not_the_send():
    due = np.array([0.0, 0.1, 0.2])
    t0 = 100.0
    futs = [Future() for _ in due]
    for f in futs:
        f.set_result(([1], [1.0]))
    stamps = np.array([100.05, 100.40, 100.21])
    lat, failed = ts.latencies_ms(futs, stamps, due, t0, deadline=200.0)
    np.testing.assert_allclose(lat, [50.0, 300.0, 10.0], atol=1e-6)
    assert not failed.any()


def test_failed_and_unanswered_count_at_the_deadline():
    due = np.array([0.0, 0.5, 1.0])
    t0 = time.perf_counter() - 2.0
    ok, err, never = Future(), Future(), Future()
    ok.set_result(([1], [1.0]))
    err.set_exception(RuntimeError("shed"))
    stamps = np.array([t0 + 0.2, t0 + 0.6, np.nan])
    deadline = time.perf_counter() + 0.05
    lat, failed = ts.latencies_ms([ok, err, never], stamps, due, t0,
                                  deadline)
    assert failed.tolist() == [False, True, True]
    np.testing.assert_allclose(lat[0], 200.0, atol=1e-6)
    np.testing.assert_allclose(lat[1:], (deadline - t0 - due[1:]) * 1e3,
                               atol=1e-6)


def test_percentiles_cover_every_request():
    lat = np.concatenate([np.full(990, 10.0), np.full(10, 500.0)])
    assert np.percentile(lat, 50) == 10.0
    assert np.percentile(lat, 99) > 10.0
    assert np.percentile(lat, 99.5) == 500.0


def test_open_loop_sends_on_schedule_and_reports_lateness():
    sent = []

    def submit(text):
        sent.append((time.perf_counter(), text))
        f = Future()
        f.set_result(([0], [1.0]))
        return f

    due = np.array([0.0, 0.02, 0.05])
    t0 = time.perf_counter() + 0.01
    futs, stamps, late = ts.open_loop(submit, ["a", "b", "c"], due, t0)
    assert [t for _, t in sent] == ["a", "b", "c"]
    assert (late >= 0).all() and (late < 0.02).all()
    for (t, _), d in zip(sent, due):
        assert t >= t0 + d
    assert np.isfinite(stamps).all()


def test_real_rows_drop_the_tile_padding():
    assert ts.real_rows(["a", "b", "c", "c", "c"]) == 3
    assert ts.real_rows(["a"]) == 1
    assert ts.real_rows(["a", "a"]) == 1
