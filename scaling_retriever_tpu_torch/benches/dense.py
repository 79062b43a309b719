"""Exact dense (flat inner-product) retrieval QPS at MSMARCO depth on one
card (the port's counterpart of ``bench_dense.py``).

    python3 -m scaling_retriever_tpu_torch.benches.dense [--device cpu]

8,841,823 L2-normalized 2048-wide rows (Llama-3.2-1B's hidden size) made
on the device in bf16 (36.5 GB in 262,144-row chunks, the last padded with
zero rows), searched by 256-query tiles of random unit queries, top-1000:
each chunk's f32-output product, the top 32 of every 4,096 docs (B5,
``block_topm`` at its dense site), a running merge and the certificate
(``_search_chunked_blocked``), tile i+1 dispatched before tile i's read,
12 timed tiles. Then the same rows as per-doc int8 codes (18.1 GB, the
s32 product exact over the codes) on the same queries. The reference cut
the corpus to 2,097,152 rows to fit a 16 GB chip; this card holds the
full depth.

Check: on the first tile's first 8 queries, the search equals one top-k
over the whole [8, N] score matrix, its products those of the tile (the
same product shape, so the same sums): scores bit-equal, ids tie-equal;
every row certified. Baseline: numpy's f32 BLAS product plus
``argpartition`` on 64 queries against a 200,000-row slice on this host,
scaled to the corpus's depth.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.index.dense_index import (
    _quantize_rows, _score_slab, _search_chunked_blocked,
)
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

N_DOCS = 8_841_823
D = 2048
TOPK = 1000
TILE = 256
N_TILES = 12
CHUNK = 262_144
BLOCK, M = 4096, 32       # B5's dense selection: top 32 of each 4,096 docs
CPU_SLICE = 200_000       # rows of the host-BLAS baseline
CPU_Q = 64
ORACLE_Q = 8


def padded_chunks(dev, seed: int) -> list:
    """The corpus as full [CHUNK, D] bf16 chunks (zero rows pad the last)."""
    out = []
    for _, v in corpora.corpus_chunks(dev, seed, N_DOCS, D, CHUNK):
        if len(v) < CHUNK:
            v = torch.cat([v, v.new_zeros(CHUNK - len(v), D)])
        out.append(v)
    return out


def oracle(chunks, q_tile, q_scale, doc_scales):
    """One top-k over the first ORACLE_Q queries' scores against every
    doc, each chunk's products taken from the whole tile's product."""
    s = torch.cat([
        _score_slab(q_tile, blk, q_scale,
                    None if doc_scales is None else doc_scales[c])[:ORACLE_Q]
        .clone() for c, blk in enumerate(chunks)], dim=1)
    v, i = torch.topk(s, TOPK, dim=1)
    return v.cpu().numpy(), i.cpu().numpy()


def stream(name, chunks, tiles, dev, checks, doc_scales=None) -> dict:
    """Time ``tiles`` ([(queries, q_scale or None)]) after the check on
    the first."""
    def dispatch(t):
        return _search_chunked_blocked(chunks, t[0], TOPK, CHUNK, M, BLOCK,
                                       topm="pallas", doc_scales=doc_scales,
                                       q_scale=t[1])

    n_cert = [0]

    def drain(out):
        s, r, ok = out
        s.cpu()
        r.cpu()
        n_cert[0] += int(ok.sum())

    s, r, ok = (x.cpu().numpy() for x in dispatch(tiles[0]))
    o_s, o_i = oracle(chunks, *tiles[0], doc_scales)

    def exact():
        assert ok.all(), f"{int((~ok).sum())} rows uncertified"
        assert (r < N_DOCS).all(), "a padding row was returned"
        np.testing.assert_array_equal(s[:ORACLE_Q], o_s)
        for i in range(ORACLE_Q):
            tie_equal_topk(r[i], s[i], o_i[i], o_s[i], rtol=0.0)

    checks.run(f"{name}: blocked search == one top-k over the whole "
               f"score matrix ({ORACLE_Q} queries, scores bit-equal)", exact)
    for _ in range(3):
        drain(dispatch(tiles[0]))
    n_cert[0] = 0
    dt = common.timed(tiles[1:], dispatch, drain, dev)
    nq = TILE * (len(tiles) - 1)
    checks.run(f"{name}: every timed row certified",
               lambda: np.testing.assert_equal(n_cert[0], nq))
    common.log(f"{name}: {nq} queries in {dt:.3f} s -> {nq / dt:.1f} QPS "
               f"({dt / (len(tiles) - 1) * 1e3:.2f} ms a {TILE}-query tile,"
               f" certified {n_cert[0]}/{nq})")
    return {"qps": nq / dt, "certified": n_cert[0] / nq, "first": r}


def host_blas(q: np.ndarray, rng) -> float:
    """QPS of numpy's f32 product + argpartition over CPU_SLICE rows on
    this host, scaled to N_DOCS rows."""
    docs = rng.standard_normal((CPU_SLICE, D)).astype(np.float32)
    t0 = time.perf_counter()
    sc = q @ docs.T
    np.argpartition(-sc, TOPK, axis=1)[:, :TOPK]
    dt = time.perf_counter() - t0
    return len(q) / (dt * (N_DOCS / CPU_SLICE))


def main(argv=None) -> int:
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    t0 = time.perf_counter()
    chunks = padded_chunks(dev, args.seed)
    common.sync(dev)
    gb = {"bf16": sum(c.nbytes for c in chunks) / 1e9}
    common.log(f"{N_DOCS} x {D} bf16 in {len(chunks)} chunks "
               f"({gb['bf16']:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed)
    tiles = []
    for _ in range(N_TILES + 1):
        q = rng.standard_normal((TILE, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        tiles.append(torch.from_numpy(q).to(dev).bfloat16())
    arms = {"bf16": stream("bf16", chunks, [(q, None) for q in tiles], dev,
                           checks)}

    codes, scales = zip(*(_quantize_rows(c) for c in chunks))
    gb["int8"] = sum(c.nbytes + s.nbytes for c, s in zip(codes, scales)) / 1e9
    arms["int8"] = stream("int8", list(codes),
                          [_quantize_rows(q) for q in tiles], dev, checks,
                          list(scales))
    r_bf, r_i8 = arms["bf16"].pop("first"), arms["int8"].pop("first")
    arms["int8"]["top_overlap_vs_bf16"] = float(np.mean(
        [len(np.intersect1d(r_bf[i], r_i8[i])) / TOPK
         for i in range(len(r_bf))]))
    for name in arms:
        arms[name]["gb"] = gb[name]

    cpu_qps = host_blas(tiles[1][:CPU_Q].float().cpu().numpy(), rng)
    common.log(f"host BLAS baseline: {cpu_qps:.2f} QPS scaled to {N_DOCS} "
               f"docs; arms {arms}")
    return common.emit({
        "metric": "dense_retrieval_qps",
        "value": arms["bf16"]["qps"],
        "unit": (f"queries/sec ({N_DOCS} docs x {D} bf16, exact inner "
                 f"product top-{TOPK}, {TILE}-query tiles, depth 2, one "
                 f"card)"),
        "vs_baseline": arms["bf16"]["qps"] / cpu_qps,
        "baseline": {"what": f"numpy f32 BLAS + argpartition, {CPU_Q} "
                             f"queries x {CPU_SLICE} rows on this host, "
                             f"scaled to {N_DOCS} rows", "qps": cpu_qps},
        "card": card_s, "device": str(dev), "arms": arms,
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
