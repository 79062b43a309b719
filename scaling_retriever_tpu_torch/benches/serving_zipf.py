"""Closed-loop serving over the power-law (zipf) index with skewed traffic
on one card (the port's counterpart of ``bench_serving_zipf.py``).

    python3 -m scaling_retriever_tpu_torch.benches.serving_zipf [--device cpu]

bench_zipf.py's full CSR (made on the device, 8.5 GB) behind a
``SegsortEngine``, a ``SparseTileBackend`` with width rungs 8, 16, 32 and
64, a fast-lane cap of 8,192 jobs a query, a tile envelope of 32,768 job
slots (``tile_slots_cap``: co-riders are admitted only while rung x
bucket of the batch's largest need stays inside it) and ``ZipfHostLane``
as the hot lane, and a ``RetrievalServer`` whose admission reorders a
window of 8 tile widths. Traffic: a pool of 2,048 queries calibrated to
425,000 matched postings, and every 32nd request of a client drawn from a
pool of 64 hot-term queries (terms ~ len^0.7), so job need varies ~100x:
cost-aware admission splits tiles, expensive singletons ride the narrow
rungs, and queries over the cap go to the host lane, which sheds beyond
32 in flight. Every (rung, bucket) variant the pools reach is warmed
first. At each concurrency of 1, 8, 64, 128 and 256 for 8 s: QPS, client
latency p50/p95/p99, mean batch, cost splits, hot queries and hot sheds.

Check: a sample of fast-lane and hot-lane results served after the
ladder equals both ``ZipfHostLane`` and a direct engine call on the same
query (tie-equal, rtol 1e-5).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    SegsortEngine, bucket_jobs,
)
from scaling_retriever_tpu_torch.serving.server import (
    RetrievalServer, ServerOverloadedError, SparseTileBackend,
)
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

SPEC = corpora.ZipfSpec()
TOPK = 1000
T_BUDGET = 64
L0_Q = 48
WIDTHS = (8, 16, 32, 64)
HOT_EVERY = 32            # one hot request in HOT_EVERY, per client
REORDER_HORIZON = 8
MAX_NEED_JOBS = 8192      # fast-lane cap a query (~8.4M postings)
TILE_SLOTS_CAP = 32768
POOL = 2048
HOT_POOL = 64
TARGET_MATCHED = 425_000.0
HOT_ALPHA = 0.7
CONCURRENCY = (1, 8, 64, 128, 256)
SECONDS = 8.0
WARM_PASSES = 3
CHECK_FAST, CHECK_HOT = 4, 2


def zipf_server(corpus, topk: int = TOPK):
    """(engine, backend, server) over the corpus's full CSR, made on its
    device; the server is not started."""
    rows, bits = corpus.csr(prefix=False)
    n_docs = corpus.spec.n_docs
    engine = SegsortEngine(topk=topk, query_terms_budget=T_BUDGET,
                           device_csr=(rows, bits, corpus.t["offsets"],
                                       n_docs))
    backend = SparseTileBackend(
        engine, None, n_docs, widths=WIDTHS, t_budget=T_BUDGET, topk=topk,
        max_need_jobs=MAX_NEED_JOBS,
        hot_lane=corpora.ZipfHostLane(corpus.t, corpus.spec),
        tile_slots_cap=TILE_SLOTS_CAP)
    server = RetrievalServer(backend, max_wait_ms=2.0,
                             reorder_horizon=REORDER_HORIZON)
    return engine, backend, server


def pools(t: dict, seed: int):
    """(calibrated pool, hot pool, alpha), drawn as bench_serving_zipf
    draws them."""
    rng = np.random.default_rng(seed)
    alpha = corpora.calibrate_alpha(t, TARGET_MATCHED, L0_Q)
    return (corpora.query_pool(t, rng, alpha, POOL, L0_Q),
            corpora.query_pool(t, rng, HOT_ALPHA, HOT_POOL, L0_Q), alpha)


def mix(cal: list, hot: list):
    """The clients' draw: request j is hot when j % HOT_EVERY == 0."""
    def pick(rng, j):
        if j % HOT_EVERY == 0:
            return hot[int(rng.integers(len(hot)))]
        return cal[int(rng.integers(len(cal)))]
    return pick


def warm(backend, queries, passes: int = WARM_PASSES) -> int:
    """Run every (width rung, job bucket) variant the fast-lane queries
    reach: rung x bucket within the envelope, and every bucket on the
    narrowest rung (an expensive query rides it alone). Returns tiles."""
    by_bucket: dict = {}
    for q in queries:
        need = backend.request_cost(q)
        if need <= backend.max_need_jobs:
            by_bucket.setdefault(bucket_jobs(need), []).append(q)
    n = 0
    for b, qs in sorted(by_bucket.items()):
        for w in backend.widths:
            if w * b > backend.tile_slots_cap and w != backend.widths[0]:
                continue
            reqs = (qs * -(-w // len(qs)))[:w]
            for _ in range(passes):
                backend.drain(backend.dispatch(reqs), reqs)
                n += 1
    return n


def check_served(engine, lane, served, topk: int = TOPK) -> None:
    """Each served (query, (ids, scores)) equals the host lane and the
    engine's own tile on that query, over docs of positive score."""
    for q, (ids, scores) in served:
        assert len(ids) > 0 and np.isfinite(scores).all(), "empty result"
        got = common.positive(ids, scores)
        tie_equal_topk(*got, *common.positive(*lane.retrieve_sparse(
            q[0], q[1], topk)), rtol=1e-5)
        tie_equal_topk(*got, *common.engine_topk(engine, q, topk),
                       rtol=1e-5)


def serve_sample(server, backend, cal, hot, n_fast=CHECK_FAST,
                 n_hot=CHECK_HOT) -> list:
    """Submit ``n_fast`` fast-lane and ``n_hot`` hot-lane queries together
    to the running server; returns [(query, result)]."""
    fast = [q for q in cal if backend.route(q) == "fast"][:n_fast]
    hot_q = [q for q in hot if backend.route(q) == "hot"][:n_hot]
    assert len(hot_q) == n_hot, "the hot pool routes too few queries hot"
    futs = [(q, server.submit(q)) for q in fast + hot_q]
    return [(q, f.result(timeout=600)) for q, f in futs]


def main(argv=None) -> int:
    args = common.parser(__doc__, topk=TOPK).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    corpus = corpora.ZipfCorpus(SPEC, dev)
    t = corpus.t
    engine, backend, server = zipf_server(corpus, args.topk)
    cal, hot, alpha = pools(t, args.seed)
    needs = np.array([backend.request_cost(q) for q in cal])
    hot_needs = np.array([backend.request_cost(q) for q in hot])
    routed_hot = int((hot_needs > MAX_NEED_JOBS).sum())
    common.log(f"zipf index: {t['nnz']} postings; alpha {alpha:.4f}; pool "
               f"need p50 {np.percentile(needs, 50):.0f} p95 "
               f"{np.percentile(needs, 95):.0f} max {needs.max()} jobs; hot "
               f"pool need p50 {np.percentile(hot_needs, 50):.0f} max "
               f"{hot_needs.max()}: {routed_hot}/{HOT_POOL} route to the "
               f"host lane")
    t0 = time.perf_counter()
    n_warm = warm(backend, cal + hot)
    common.log(f"warmed {n_warm} tiles in {time.perf_counter() - t0:.1f} s")

    with server:
        res, _ = common.closed_loop(
            server.search, mix(cal, hot), CONCURRENCY, SECONDS,
            counters=common.server_counters(server),
            shed=(ServerOverloadedError,), seed=args.seed)
        stage_s = server.stats()["stage_s"]
        served: list = []
        checks.run(f"{CHECK_HOT} hot-pool queries route to the host lane",
                   lambda: served.extend(serve_sample(server, backend, cal,
                                                      hot)))
    checks.run("fast-lane and hot-lane results == ZipfHostLane and the "
               "engine", lambda: check_served(engine, backend.hot_lane,
                                              served, args.topk))
    best = max(r["qps"] for r in res.values())
    return common.emit({
        "metric": "serving_qps_zipf",
        "value": best,
        "unit": (f"queries/sec through RetrievalServer, closed loop "
                 f"({SPEC.n_docs} docs, {t['nnz']} power-law postings, "
                 f"queries calibrated to {TARGET_MATCHED:.0f} matched "
                 f"postings plus 1 in {HOT_EVERY} hot, top-{args.topk}, "
                 f"widths {WIDTHS}, {SECONDS} s windows, one card, best of "
                 f"the concurrency ladder)"),
        "card": card_s, "device": str(dev),
        "arms": {"f32": {"best_qps": best, "stage_s": stage_s,
                         "by_concurrency": res}},
        "traffic": {"alpha": alpha, "hot_every": HOT_EVERY,
                    "reorder_horizon": REORDER_HORIZON,
                    "max_need_jobs": MAX_NEED_JOBS,
                    "tile_slots_cap": TILE_SLOTS_CAP,
                    "pool_need_p50": float(np.percentile(needs, 50)),
                    "pool_need_p95": float(np.percentile(needs, 95)),
                    "pool_need_max": int(needs.max()),
                    "hot_pool_routed_hot": routed_hot,
                    "warm_tiles": n_warm},
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
