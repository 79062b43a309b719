"""An offline evaluation pass: a stream of pre-encoded query tiles
straight into ``SegsortEngine`` (``retrieve_tile_async`` / ``finalize``,
the engine sizing each tile's job bucket from the index's lists), tile
i+1 dispatched before tile i's host read, for the whole window.

The mix's file gives the pool of queries (cycled), the terms a query, the
term budget, the weights' range, the tile and k. ``stream_qps`` counts the
queries of every tile dispatched in the window over the time until the
last one's top-k was read back to the host.
"""

from __future__ import annotations

import collections
import gc
import time

import numpy as np

from retrieval_bench import check, flops, gen, program
from retrieval_bench.kinds.text_serving import ENGINE_SPANS, EngineSpans
from retrieval_bench.reference import scoring


def served_rows(scores, rows, n_docs: int) -> tuple:
    keep = (rows >= 0) & (rows < n_docs) & np.isfinite(scores)
    return rows[keep].astype(np.int64), scores[keep]


def run(ctx) -> dict:
    conf, tr, dev, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    m, ix = conf["model"], conf["index"]
    vocab, k, width = m["vocab_size"], tr["topk"], tr["tile"]

    ctx.stage("imports")
    engine = program.build_engine(conf, k, tr["t_budget"], dev)
    ctx.stage("index")
    spanned = EngineSpans(engine)
    qt, qv = gen.query_pool(vocab, tr["pool"], tr["terms"], tr["t_budget"],
                            *tr["weights"], seed)
    tiles = [(qt[s:s + width], qv[s:s + width])
             for s in range(0, len(qt) - width + 1, width)]

    def dispatch(i):
        return spanned.retrieve_tile_async(None, k,
                                           sparsified=tiles[i % len(tiles)])

    for _ in range(3):
        spanned.finalize(dispatch(0))
    ctx.stage("warm-up")
    gc.collect()
    gc.freeze()
    ctx.sync()
    drained = []
    with ctx.window() as w:
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        pending = collections.deque()
        i = 0
        while time.perf_counter() < t_end:
            pending.append((i, dispatch(i)))
            i += 1
            if len(pending) >= tr["depth"]:
                j, p = pending.popleft()
                drained.append((j, *spanned.finalize(p)))
        while pending:
            j, p = pending.popleft()
            drained.append((j, *spanned.finalize(p)))
        elapsed = time.perf_counter() - t0
    gc.unfreeze()
    peak = ctx.memory_peak()
    pt = gen.per_term(ix, vocab)
    per_tile = [int((t[1] > 0).sum()) * pt for t in tiles]
    postings = sum(per_tile[j % len(tiles)] for j in range(i))
    record = {"window_s": w.seconds, "trace": w.summary,
              "retrieval_bytes": flops.retrieval_bytes(postings, i * width,
                                                       k),
              "retrieval_spans": ENGINE_SPANS}

    r = gen.rng(seed, 9)
    picks = r.choice(len(drained) * width, size=min(tr["sample"],
                                                    len(drained) * width),
                     replace=False)
    terms, vals, served = [], [], []
    for p in sorted(picks.tolist()):
        j, s, rw = drained[p // width]
        row = p % width
        terms.append(tiles[j % len(tiles)][0][row])
        vals.append(tiles[j % len(tiles)][1][row])
        served.append(served_rows(s[row], rw[row], ix["n_docs"]))
    del engine, spanned, drained, tiles
    ctx.free()
    terms, vals = np.array(terms), np.array(vals)
    refs = scoring.score_queries(ix, vocab, terms, vals, k,
                                 [s[0] for s in served], dev)
    numbers = check.engine_numbers(served, refs, k)
    control = None
    if ctx.control:
        low = scoring.score_queries(ix, vocab, terms, vals, k,
                                    [[]] * len(terms), dev, precision="bf16")
        c_served = [(x["top_docs"][x["top_scores"] > 0],
                     x["top_scores"][x["top_scores"] > 0]) for x in low]
        c_refs = scoring.score_queries(ix, vocab, terms, vals, k,
                                       [s[0] for s in c_served], dev)
        control = check.engine_numbers(c_served, c_refs, k)
    return {"attempted": i * width, "failed": 0,
            "e2e": {"stream_qps": i * width / elapsed},
            "memory_peak_bytes": peak, "record": record,
            "numbers": numbers, "control": control, "window_start": t0}
