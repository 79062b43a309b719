"""Closed-loop dense serving QPS and latency at MSMARCO depth on one card
(the port's counterpart of ``bench_serving_dense.py``).

    python3 -m scaling_retriever_tpu_torch.benches.serving_dense [--device cpu]

8,841,823 L2-normalized 2048-wide bf16 rows made on the device into a
``DenseFlatIndexer`` (the production search: blocked selection through
B5 with its certificate, the direct rerun where it fails), behind a
``DenseTileBackend`` with width rungs 8, 32, 64, 128 and 256 (padding rows
copy the first query) and a ``RetrievalServer`` (2 ms window, pipeline
depth 2, up to 3 under load). At each concurrency of 1, 8, 64, 128, 256
and 512 for 8 s, unit-norm f32 queries drawn from a pool of 2,048: QPS,
client latency p50/p95/p99 and mean batch. The bf16 layout runs first,
then the int8 layout (per-doc codes, 18.1 GB, built beside the bf16
store: 54.6 GB together) in the same invocation. The reference cut the
corpus to 2,097,152 rows to fit a 16 GB chip; this card holds the full
depth.

Check: a sample of each arm's served results equals the always-exact
direct search (``_search_chunked``) on the same query (tie-equal, rtol
1e-5; the int8 products are exact over the codes).
"""

from __future__ import annotations

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.index.dense_index import (
    DenseFlatIndexer, _quantize_queries_int8, _search_chunked,
)
from scaling_retriever_tpu_torch.serving.server import (
    DenseTileBackend, RetrievalServer,
)
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

N_DOCS = 8_841_823
D = 2048
TOPK = 1000
CHUNK = 262_144
SEL_BLOCK = 4096
WIDTHS = (8, 32, 64, 128, 256)
POOL = 2048
CONCURRENCY = (1, 8, 64, 128, 256, 512)
SECONDS = 8.0
SAMPLE = 8


def direct(idx, vec: np.ndarray, topk: int):
    """The exact direct search of one query on the index's layout."""
    q = torch.as_tensor(vec[None]).to(idx.device, torch.float32)
    q, qs = (_quantize_queries_int8(q) if idx.quantize == "int8"
             else (q.to(idx.dtype), None))
    s, r = _search_chunked(idx._materialize(), q, topk, idx.chunk,
                           doc_scales=idx._layout[2], q_scale=qs)
    return r[0].cpu().numpy(), s[0].cpu().numpy()


def ladder(name: str, idx, pool, args, checks) -> dict:
    backend = DenseTileBackend(idx, width=WIDTHS[-1], topk=args.topk,
                               widths=WIDTHS)
    server = RetrievalServer(backend, max_wait_ms=2.0, pipeline_depth=2,
                             max_pipeline_depth=3)
    common.log(f"[{name}] warmup: "
               f"{server.warmup(pool[:WIDTHS[-1]], passes=4)}")
    with server:
        res, samples = common.closed_loop(
            server.search, lambda rng, j: pool[int(rng.integers(len(pool)))],
            CONCURRENCY, SECONDS,
            counters=common.server_counters(server), keep=SAMPLE,
            seed=args.seed, label=f"[{name}] ")
        stage_s = server.stats()["stage_s"]
    common.log(f"[{name}] server worker seconds by stage: {stage_s}")
    sample = [s for kept in samples.values() for s in kept][:SAMPLE]

    def same():
        for q, (ids, scores) in sample:
            assert len(ids) == args.topk and np.isfinite(scores).all()
            tie_equal_topk(*direct(idx, q, args.topk), ids, scores,
                           rtol=1e-5)

    checks.run(f"{name}: served results == the direct search", same)
    common.log(f"[{name}] certificate fallbacks {idx.fallbacks}")
    return {"best_qps": max(r["qps"] for r in res.values()),
            "stage_s": stage_s, "fallbacks": idx.fallbacks,
            "by_concurrency": res}


def main(argv=None) -> int:
    args = common.parser(__doc__, topk=TOPK).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    idx = DenseFlatIndexer(device=dev, chunk=CHUNK, sel_block=SEL_BLOCK)
    idx.init_index(D)
    corpora.dense_corpus(idx, corpora.corpus_chunks(dev, args.seed, N_DOCS,
                                                    D, CHUNK))
    gb = {"bf16": sum(c.nbytes for c in idx._materialize()) / 1e9}
    rng = np.random.default_rng(args.seed)
    pool = rng.standard_normal((POOL, D)).astype(np.float32)
    pool = list(pool / np.linalg.norm(pool, axis=1, keepdims=True))
    arms = {"bf16": ladder("bf16", idx, pool, args, checks)}
    idx.quantize = "int8"
    gb["int8"] = sum(c.nbytes for c in idx._materialize()) / 1e9 + sum(
        s.nbytes for s in idx._layout[2]) / 1e9
    arms["int8"] = ladder("int8", idx, pool, args, checks)

    for n in arms:
        arms[n]["gb"] = gb[n]
    best = {n: a["best_qps"] for n, a in arms.items()}
    lead = max(best, key=best.get)
    return common.emit({
        "metric": "dense_serving_qps",
        "value": best[lead],
        "unit": (f"queries/sec through RetrievalServer, closed loop "
                 f"({N_DOCS} docs x {D}, exact inner product top-{args.topk}, "
                 f"widths {WIDTHS}, {SECONDS} s windows, one card, "
                 f"best of the concurrency ladder, {lead} layout)"),
        "card": card_s, "device": str(dev),
        "arms": arms,
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
