"""Text-in serving QPS on one card: raw text → Llama-3.2-1B-architecture
sparse encoder → micro-batched retrieval, closed loop (the port's
counterpart of ``bench_text.py``).

    python3 -m scaling_retriever_tpu_torch.benches.text [--device cpu]

bench.py's uniform index (made on the device) behind a ``SegsortEngine``,
a ``SparseTileBackend`` (width rungs 8 and 64, 64-term budget, top-1000)
and a ``RetrievalServer``; in front, a ``QueryEncoderFrontend`` over the
published Llama-3.2-1B architecture in bf16 with random weights from
``--seed`` and ``StandInTokenizer`` (queries of 8 words from a bank of
4,096 ride the 16-token rung; rungs 16 and 64), each tile's top-64 handed
to the engine on the device (``retrieve_tile_handoff_async``) at a
standing job bucket sized from the warmup with headroom 1.0, encode
dispatch depth 2. The f32 layout runs first, then its rows are packed in
place into q8 and the ladder runs again. At each concurrency of 1, 64, 128
and 256 for 8 s: QPS, client latency p50/p95/p99 and the mean encode
batch.

Check: texts served after each ladder equal a direct engine call on the
reps their own encode tile produced (tie-equal, rtol 1e-5).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine
from scaling_retriever_tpu_torch.serving.server import (
    RetrievalServer, SparseTileBackend,
)
from scaling_retriever_tpu_torch.serving.text_frontend import (
    QueryEncoderFrontend, make_encode_fn_handoff,
)
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

N_DOCS = 8_841_823
K = 128
VOCAB = 128_256
MODEL: dict = {}          # config.json overrides of Llama-3.2-1B (none)
TOPK = 1000
WIDTHS = (8, 64)
T_SPARSE = 64
Q_WORDS = 8               # ~MSMARCO query length: the 16-token rung
LENGTH_RUNGS = (16, 64)
WORD_BANK = 4096
POOL = 2048
DEPTH = 2                 # encode tiles in flight
BUCKET_HEADROOM = 1.0     # the query population is stationary here
CONCURRENCY = (1, 64, 128, 256)
SECONDS = 8.0
SAMPLE = 8


class RecordingEncode:
    """A handoff encode fn that, while ``tiles`` is a list, keeps each
    tile's token ids and top-T reps on the host (one read a tile; only
    for the check after the timed ladder)."""

    handoff = True

    def __init__(self, inner):
        self.inner = inner
        self.tiles = None
        self._lock = threading.Lock()

    def __call__(self, ids, mask):
        out = self.inner(ids, mask)
        if self.tiles is not None:
            with self._lock:
                self.tiles.append((ids, mask, out[0].cpu().numpy(),
                                   out[1].cpu().numpy()))
        return out

    dispatch = __call__

    @staticmethod
    def rep(tiles, token_ids) -> tuple:
        """The first recorded (terms, vals) of a row with these tokens."""
        key = tuple(token_ids)
        for ids, mask, terms, vals in tiles:
            for i in range(len(ids)):
                if tuple(ids[i][mask[i] > 0]) == key:
                    keep = vals[i] > 0
                    return terms[i][keep], vals[i][keep]
        raise AssertionError(f"no encode tile held the tokens {key[:4]}...")


def run_arm(name, engine, model, tok, texts, args, checks) -> dict:
    backend = SparseTileBackend(engine, None, N_DOCS, widths=WIDTHS,
                                t_budget=T_SPARSE, topk=args.topk)
    server = RetrievalServer(backend, max_wait_ms=2.0, pipeline_depth=2)
    encode = RecordingEncode(make_encode_fn_handoff(model, T_SPARSE))
    fe = QueryEncoderFrontend(server, encode, tok, widths=WIDTHS,
                              t_sparse=T_SPARSE, max_wait_ms=2.0,
                              pipeline_depth=DEPTH,
                              bucket_headroom=BUCKET_HEADROOM)
    warm_texts = texts[:max(WIDTHS)]
    common.log(f"[{name}] encoder warmup: {fe.warmup(warm_texts, passes=4)}")
    terms, vals = (x.cpu().numpy() for x in encode(*tok(warm_texts)))
    reps = [(terms[i][vals[i] > 0], vals[i][vals[i] > 0])
            for i in range(len(warm_texts))]
    common.log(f"[{name}] retrieval warmup: {server.warmup(reps, passes=4)}")

    def counters():
        with fe._lock:
            return {"batches": fe.n_encode_batches, "batched": fe.n_texts}

    with server, fe:
        fe.start()
        res, _ = common.closed_loop(
            fe.search_text, lambda rng, j: texts[int(rng.integers(POOL))],
            CONCURRENCY, SECONDS, counters=counters,
            seed=args.seed, label=f"[{name}] ")
        fe_stats = fe.stats()
        common.log(f"[{name}] frontend: {fe_stats}; server worker seconds "
                   f"by stage: {server.stats()['stage_s']}")
        sample = texts[POOL:POOL + SAMPLE]
        encode.tiles = []
        futs = [(t, fe.submit_text(t)) for t in sample]
        served = [(t, f.result(timeout=600)) for t, f in futs]
        recorded, encode.tiles = encode.tiles, None

    def same():
        for t, (ids, scores) in served:
            q = encode.rep(recorded, [int(w[1:]) % VOCAB for w in t.split()])
            assert len(ids) > 0 and np.isfinite(scores).all(), "empty result"
            tie_equal_topk(*common.engine_topk(engine, q, args.topk), ids,
                           scores, rtol=1e-5)

    checks.run(f"{name}: served texts == direct engine calls on their "
               f"reps", same)
    return {"best_qps": max(r["qps"] for r in res.values()),
            "stage_s": fe_stats["stage_s"],
            "rung_tiles": fe_stats["rung_tiles"],
            "jobs_bucket": fe_stats["jobs_bucket"], "by_concurrency": res}


def main(argv=None) -> int:
    args = common.parser(__doc__, topk=TOPK).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    rows, offsets, nnz = corpora.uniform_rows(dev, N_DOCS, K, VOCAB)
    valbits = corpora.uniform_valbits(nnz, rows.shape[0], dev)
    model = common.sparse_encoder(dev, args.seed,
                                  dict(MODEL, vocab_size=VOCAB))
    tok = common.StandInTokenizer(VOCAB, lengths=LENGTH_RUNGS)
    rng = np.random.default_rng(args.seed)
    bank = [f"w{i + 2}" for i in rng.choice(VOCAB - 2, size=WORD_BANK,
                                            replace=False)]
    texts = [" ".join(rng.choice(bank, size=Q_WORDS))
             for _ in range(POOL + SAMPLE)]

    engine = SegsortEngine(topk=args.topk, query_terms_budget=T_SPARSE,
                           device_csr=(rows, valbits, offsets, N_DOCS))
    arms = {"f32": run_arm("f32", engine, model, tok, texts, args, checks)}
    del engine, valbits
    corpora.q8_words(rows, nnz, N_DOCS, out=rows)
    engine = SegsortEngine(topk=args.topk, query_terms_budget=T_SPARSE,
                           val_dtype="q8",
                           device_csr=(rows, corpora.q8_scales(VOCAB),
                                       offsets, N_DOCS))
    arms["q8"] = run_arm("q8", engine, model, tok, texts, args, checks)

    best = {n: a["best_qps"] for n, a in arms.items()}
    lead = max(best, key=best.get)
    cfg = model.config
    return common.emit({
        "metric": "text_in_serving_qps",
        "value": best[lead],
        "unit": (f"text queries/sec end to end (tokenize, encode with "
                 f"{cfg.num_hidden_layers} layers x {cfg.hidden_size} bf16, "
                 f"top-{T_SPARSE} handoff, top-{args.topk} retrieval over "
                 f"{N_DOCS} docs / {nnz} postings), closed loop, "
                 f"{SECONDS} s windows, one card, best of the "
                 f"concurrency ladder, {lead} layout)"),
        "card": card_s, "device": str(dev),
        "arms": arms,
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
