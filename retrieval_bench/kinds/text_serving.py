"""Text-in serving under open-loop traffic, through the port's normal text
path as its server CLI builds it: ``QueryEncoderFrontend`` (tokenize,
encode tiles of the width ladder, the top-T handoff on the device) →
``SegsortEngine.retrieve_tile_handoff_async`` at the standing job bucket,
with ``RetrievalServer`` / ``SparseTileBackend`` behind it for rows over
the bucket.

The mix's file gives the rate, the word-count histogram, the word bank,
the length rungs, the encode widths, T and k. Arrivals are due on the
seed's open-loop schedule whatever the system does; each request's
latency runs from when it was due until its top-k reaches the client.

The benchmark wraps three of the port's callables, and edits none: the
tokenize function (records the texts of each tile), the encode function
(span ``rb.encode``; keeps each tile's ids and its device-resident
(terms, vals) for the check, with no host read) and the engine (spans
``rb.engine`` around a dispatch, ``rb.read`` around a read).
"""

from __future__ import annotations

import functools
import gc
import time

import numpy as np
import torch

from retrieval_bench import check, flops, gen, program
from retrieval_bench.reference import scoring
from retrieval_bench.trace import span

ENGINE_SPANS = ("rb.engine", "rb.read")
# what the configuration's architecture module has to define for this kind
ARCH = ("build_encoder", "sparse_reps", "encode_flops")


class TokenizeRecorder:
    def __init__(self, inner):
        self.inner = inner
        self.lengths = inner.lengths
        self.calls = None

    def __call__(self, texts, length=None):
        out = self.inner(texts, length)
        if self.calls is not None:
            self.calls.append(list(texts))
        return out


class EncodeRecorder:
    """The handoff encode fn, spanned; while ``tiles`` is a list it keeps
    (ids, mask, terms, vals) of each tile, the last two on the device."""

    handoff = True

    def __init__(self, inner):
        self.inner = inner
        self.tiles = None

    def __call__(self, ids, mask):
        with span("rb.encode"):
            out = self.inner(ids, mask)
        if self.tiles is not None:
            self.tiles.append((ids, mask, out[0], out[1]))
        return out

    dispatch = __call__


class EngineSpans:
    """The engine, with spans around what the frontend and the server
    call; every other attribute is the engine's own."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def retrieve_tile_handoff_async(self, *a, **kw):
        with span("rb.engine"):
            return self._engine.retrieve_tile_handoff_async(*a, **kw)

    def finalize_handoff(self, payload):
        with span("rb.read"):
            return self._engine.finalize_handoff(payload)

    def retrieve_tile_async(self, *a, **kw):
        with span("rb.engine"):
            return self._engine.retrieve_tile_async(*a, **kw)

    def finalize(self, payload):
        with span("rb.read"):
            return self._engine.finalize(payload)


def _done(stamps, i, _fut):
    stamps[i] = time.perf_counter()


def open_loop(submit, texts, due, t0) -> tuple:
    """Send texts[i] at t0 + due[i]; returns (futures, done stamps,
    lateness of each send)."""
    n = len(texts)
    futs = [None] * n
    stamps = np.full(n, np.nan)
    late = np.zeros(n)
    for i in range(n):
        target = t0 + due[i]
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - target
        futs[i] = submit(texts[i])
        futs[i].add_done_callback(functools.partial(_done, stamps, i))
    return futs, stamps, late


def latencies_ms(futs, stamps, due, t0, deadline) -> tuple:
    """(latency of every request in ms from its due time, failed mask).
    A request not answered by ``deadline`` or answered with an error
    counts as failed, at the latency it reached by the deadline."""
    failed = np.zeros(len(futs), bool)
    for i, f in enumerate(futs):
        try:
            f.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:        # counted, never raised: a run reports it
            failed[i] = True
    end = np.where(failed | np.isnan(stamps), deadline, stamps)
    return (end - (t0 + np.asarray(due))) * 1e3, failed


def real_rows(texts: list) -> int:
    """Rows of a tile that are requests: the frontend pads a tile with
    copies of its last text, and a window's texts are distinct."""
    n = len(texts)
    while n > 1 and texts[n - 1] == texts[n - 2]:
        n -= 1
    return n


def run(ctx) -> dict:
    from scaling_retriever_tpu_torch.serving.server import (
        RetrievalServer, SparseTileBackend)
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, make_encode_fn_handoff)

    conf, tr, dev, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    m, ix = conf["model"], conf["index"]
    vocab, k, t_sparse = m["vocab_size"], tr["topk"], tr["t_sparse"]

    ctx.stage("imports")
    model = ctx.arch.build_encoder(conf, seed, dev)
    ctx.stage("weights")
    engine = program.build_engine(conf, k, t_sparse, dev)
    ctx.stage("index")
    spanned = EngineSpans(engine)
    backend = SparseTileBackend(spanned, None, ix["n_docs"], topk=k)
    server = RetrievalServer(backend, max_wait_ms=tr["max_wait_ms"])
    tok = TokenizeRecorder(gen.StandInTokenizer(vocab, tr["length_rungs"]))
    enc = EncodeRecorder(make_encode_fn_handoff(model, t_sparse))
    fe = QueryEncoderFrontend(server, enc, tok, widths=tr["encode_widths"],
                              t_sparse=t_sparse,
                              max_wait_ms=tr["max_wait_ms"])

    bank = gen.word_bank(vocab, tr["word_bank"], seed)
    due = gen.open_loop_schedule(tr["rate_qps"], ctx.seconds, seed)
    texts = gen.texts(tr["words"], len(due), bank, seed)
    longest = max(int(w) for w in tr["words"])
    warm = gen.texts({str(longest): 1}, max(tr["encode_widths"]), bank,
                     seed, stream=7)
    ctx.log(f"encoder warmup: {fe.warmup(warm, passes=3)}")
    ctx.stage("warm-up")

    with server, fe:
        fe.start()
        tok.calls, enc.tiles = [], []
        gc.collect()
        gc.freeze()
        before = fe.stats()
        ctx.sync()
        with ctx.window() as w:
            t0 = time.perf_counter()
            futs, stamps, late = open_loop(fe.submit_text, texts, due, t0)
            lat, failed = latencies_ms(futs, stamps, due, t0,
                                       t0 + ctx.seconds + 60.0)
        after = fe.stats()
    gc.unfreeze()
    drain_s = float(np.nanmax(stamps)) - (t0 + ctx.seconds)
    ctx.log(f"generator lateness ms: p50 {np.percentile(late, 50) * 1e3:.3f}"
            f", p99 {np.percentile(late, 99) * 1e3:.3f}, max "
            f"{late.max() * 1e3:.3f}; frontend {after}")
    peak = ctx.memory_peak()

    # what the window's tiles asked of the engine (real rows only)
    pt = gen.per_term(ix, vocab)
    postings = queries = 0
    row_of = {}
    for c, (call_texts, tile) in enumerate(zip(tok.calls, enc.tiles)):
        r = real_rows(call_texts)
        queries += r
        postings += int((tile[3][:r] > 0).sum()) * pt
        for j, t in enumerate(call_texts[:r]):
            row_of.setdefault(t, (c, j))

    words = np.array([len(t.split()) for t in texts])
    p50_ms = float(np.percentile(lat, 50))
    record = {
        "window_s": w.seconds,
        "text_p50_ms": p50_ms,
        "trace": w.summary,
        "counters": {"n_texts": after["n_texts"] - before["n_texts"],
                     "n_encode_batches": after["n_encode_batches"]
                     - before["n_encode_batches"]},
        "model": m,
        "flops": sum(ctx.arch.encode_flops(m, int(n)) for n in words),
        "retrieval_bytes": flops.retrieval_bytes(postings, queries, k),
        "retrieval_spans": ENGINE_SPANS,
    }

    # the sample: drawn from the seed among the answered, with the longest
    ok = np.flatnonzero(~failed)
    ok = ok[[texts[i] in row_of for i in ok]]
    n_s = min(tr["sample"], len(ok))
    pick = set(gen.rng(seed, 9).choice(ok, size=max(n_s - 1, 0),
                                       replace=False).tolist())
    if len(ok):
        pick.add(int(ok[np.argmax(words[ok])]))
    pick = sorted(pick)
    rows, p_terms, p_vals, served = [], [], [], []
    for i in pick:
        c, j = row_of[texts[i]]
        ids, mask, terms, vals = enc.tiles[c]
        rows.append((ids[j], mask[j]))
        p_terms.append(terms[j].cpu().numpy())
        p_vals.append(vals[j].cpu().numpy())
        served.append(futs[i].result())
    sample_texts = [texts[i] for i in pick]
    del model, engine, spanned, backend, server, fe, enc, tok
    ctx.free()

    numbers, control = judge_sample(ctx, sample_texts, rows,
                                    np.array(p_terms), np.array(p_vals),
                                    served)
    return {"attempted": len(texts), "failed": int(failed.sum()),
            "e2e": {"text_p50_ms": p50_ms,
                    "text_p99_ms": float(np.percentile(lat, 99))},
            "memory_peak_bytes": peak, "record": record,
            "numbers": numbers, "control": control,
            "window_start": t0, "drain_s": drain_s}


def judge_sample(ctx, texts, rows, p_terms, p_vals, served) -> tuple:
    """The sample's numbers against the reference, and with
    ``ctx.control`` the control's on the same texts."""
    conf, tr, dev, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    m, ix, k = conf["model"], conf["index"], tr["topk"]
    vocab = m["vocab_size"]
    toks = [[int(w[1:]) % vocab for w in t.split()] for t in texts]
    ref = ctx.arch.sparse_reps(m, seed, toks, dev)
    refs = scoring.score_queries(ix, vocab, p_terms, p_vals, k,
                                 [s[0] for s in served], dev)
    numbers = {"tokens_mismatch": check.token_mismatches(rows, toks),
               **check.rep_numbers(p_terms, p_vals, ref.cpu().numpy()),
               **check.engine_numbers(served, refs, k)}
    control = None
    if ctx.control:
        low = ctx.arch.sparse_reps(m, seed, toks, dev, precision="fp8")
        vals, terms = torch.topk(low, tr["t_sparse"], dim=1)
        vals = vals.clamp_min(0.0)
        c_terms = torch.where(vals > 0, terms, 0).int().cpu().numpy()
        c_vals = vals.cpu().numpy()
        low_top = scoring.score_queries(ix, vocab, c_terms, c_vals, k,
                                        [[]] * len(texts), dev,
                                        precision="bf16")
        c_served = [(r["top_docs"][r["top_scores"] > 0],
                     r["top_scores"][r["top_scores"] > 0]) for r in low_top]
        c_refs = scoring.score_queries(ix, vocab, c_terms, c_vals, k,
                                       [s[0] for s in c_served], dev)
        control = {"tokens_mismatch": 0,
                   **check.rep_numbers(c_terms, c_vals, ref.cpu().numpy()),
                   **check.engine_numbers(c_served, c_refs, k)}
    return numbers, control
