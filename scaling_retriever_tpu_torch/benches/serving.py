"""Closed-loop serving QPS and latency at MSMARCO scale on one card (the
port's counterpart of ``bench_serving.py``).

    python3 -m scaling_retriever_tpu_torch.benches.serving [--device cpu]

bench.py's uniform index (made on the device) behind a ``SegsortEngine``,
a ``SparseTileBackend`` (width rungs 8 and 64, 64-term budget, top-1000
or ``--topk``)
and a ``RetrievalServer`` (2 ms window, pipeline depth 2). At each
concurrency C of 1, 8, 64, 128 and 256, C client threads keep one
pre-encoded 48-term query in flight for 8 s, drawn from a pool of 2,048;
the line carries, per concurrency, QPS, client latency p50/p95/p99, the
server's mean batch and its cost-split and hot-lane counters. The f32
layout runs first; its rows are then packed in place into the q8 layout
and the ladder runs again in the same invocation. A sample of each arm's
served results must equal a direct engine call on the same query
(tie-equal, rtol 1e-5).
"""

from __future__ import annotations

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine
from scaling_retriever_tpu_torch.serving.server import (
    RetrievalServer, SparseTileBackend,
)
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

N_DOCS = 8_841_823
K = 128
VOCAB = 128_256
L0_Q = 48
TOPK = 1000
WIDTHS = (8, 64)
T_BUDGET = 64
PIPE_DEPTH = 2
POOL = 2048
CONCURRENCY = (1, 8, 64, 128, 256)
SECONDS = 8.0           # window per concurrency
SAMPLE = 8              # served results checked per arm


def query_pool(rng, n: int) -> list:
    """bench_serving's requests: 48 distinct uniform terms, weights in
    [0.1, 2)."""
    return [(rng.choice(VOCAB, size=L0_Q, replace=False).astype(np.int32),
             rng.uniform(0.1, 2.0, size=L0_Q).astype(np.float32))
            for _ in range(n)]


def check_served(engine, samples, topk: int) -> None:
    """Each served (query, result) equals the engine's own tile over that
    query (tie-equal, rtol 1e-5)."""
    for q, (ids, scores) in samples:
        assert len(ids) > 0 and np.isfinite(scores).all(), "empty result"
        tie_equal_topk(*common.engine_topk(engine, q, topk), ids, scores,
                       rtol=1e-5)


def ladder(name: str, engine, pool, args, checks) -> dict:
    backend = SparseTileBackend(engine, None, N_DOCS, widths=WIDTHS,
                                t_budget=T_BUDGET, topk=args.topk)
    server = RetrievalServer(backend, max_wait_ms=2.0,
                             pipeline_depth=PIPE_DEPTH)
    warm = server.warmup(pool[:max(WIDTHS)], passes=4)
    common.log(f"[{name}] warmup: {warm}")
    with server:
        res, samples = common.closed_loop(
            server.search, lambda rng, j: pool[int(rng.integers(len(pool)))],
            CONCURRENCY, SECONDS,
            counters=common.server_counters(server), keep=SAMPLE,
            seed=args.seed, label=f"[{name}] ")
        stage_s = server.stats()["stage_s"]
    common.log(f"[{name}] server worker seconds by stage: {stage_s}")
    sample = [s for kept in samples.values() for s in kept][:SAMPLE]
    checks.run(f"{name}: served results == direct engine calls",
               lambda: check_served(engine, sample, args.topk))
    return {"best_qps": max(r["qps"] for r in res.values()),
            "stage_s": stage_s, "by_concurrency": res}


def main(argv=None) -> int:
    args = common.parser(__doc__, topk=TOPK).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    rows, offsets, nnz = corpora.uniform_rows(dev, N_DOCS, K, VOCAB)
    valbits = corpora.uniform_valbits(nnz, rows.shape[0], dev)
    pool = query_pool(np.random.default_rng(args.seed), POOL)
    engine = SegsortEngine(topk=args.topk, query_terms_budget=T_BUDGET,
                           device_csr=(rows, valbits, offsets, N_DOCS))
    arms = {"f32": ladder("f32", engine, pool, args, checks)}
    del engine, valbits
    corpora.q8_words(rows, nnz, N_DOCS, out=rows)
    engine = SegsortEngine(topk=args.topk, query_terms_budget=T_BUDGET,
                           val_dtype="q8",
                           device_csr=(rows, corpora.q8_scales(VOCAB),
                                       offsets, N_DOCS))
    arms["q8"] = ladder("q8", engine, pool, args, checks)

    best = {n: a["best_qps"] for n, a in arms.items()}
    lead = max(best, key=best.get)
    return common.emit({
        "metric": "serving_qps_uniform",
        "value": best[lead],
        "unit": (f"queries/sec through RetrievalServer, closed loop "
                 f"({N_DOCS} docs, {nnz} uniform postings, {L0_Q}-term "
                 f"pre-encoded queries, top-{args.topk}, widths {WIDTHS}, "
                 f"{SECONDS} s windows, one card, best of the "
                 f"concurrency ladder, {lead} layout)"),
        "card": card_s, "device": str(dev),
        "arms": arms,
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
