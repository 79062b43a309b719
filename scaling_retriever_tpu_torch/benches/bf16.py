"""The posting-value layout ladder at MSMARCO scale on one card (the port's
counterpart of ``bench_bf16.py``).

    python3 -m scaling_retriever_tpu_torch.benches.bf16 [--device cpu]

bench.py's uniform index, made on the device as ``benches.uniform`` makes
it (8,841,823 docs, 1,131,730,944 postings, every value 1.0), held in
three layouts at once: f32 (rows + value bits, 8 B a posting, through
B1), bf16 pairs (rows + two bf16 values a word, 6 B, 2048-posting jobs,
B3) and q8 (one ``(row24 << 8) | code8`` word, 4 B, B2); all three go on
through B4 and B5. The four arrays take 15.8 GB, so all stay resident.
Each layout's jobs per query are the exact bound of the 13 tiles from
the host offsets (bench_bf16.py's ``need(chunk)``), rounded up to whole
4096-slot selection blocks so that the slab takes B5 (at most 3 jobs).
Each arm warms on tile 0, then runs 3 timed passes of 12 tiles (64
queries, 48 terms in a 64-term budget, top-1000, depth 2) and reports
the median.

The values are bf16-representable and the q8 codes lossless, so the
layouts score the same index: bf16 and q8 must equal f32 over every timed
query (scores to atol and rtol 2e-4, rows differing only on ties). The
baseline is the q8 arm with ``ops=PLAIN`` (the kernels' plain PyTorch
versions) over 2 tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora, uniform
from scaling_retriever_tpu_torch.ops.fetch import CHUNK, CHUNK2
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    KERNELS, PLAIN, segsort_retrieve_dma, segsort_retrieve_dma_bf16,
    segsort_retrieve_dma_q8,
)

SEL_BLOCK = 4096        # the engine's top-m block (B5's block)
ATOL = 2e-4             # bench_bf16.py's cross-layout tolerance


def need(tiles, offsets: np.ndarray, chunk: int) -> int:
    """The largest per-query job count of ``chunk``-posting jobs over the
    tiles (bench_bf16.py's ``need``)."""
    lens = np.diff(offsets)
    return max(int(corpora.job_need(qt, qv, offsets, lens, chunk).max())
               for qt, qv in tiles)


def slab_jobs(jobs: int, chunk: int) -> int:
    """``jobs`` rounded up so that a query's slab is whole B5 blocks."""
    per = SEL_BLOCK // chunk
    return -(-jobs // per) * per


def main(argv=None) -> int:
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()
    u = uniform
    n_docs = u.N_DOCS

    rows, offsets, nnz = corpora.uniform_rows(dev, n_docs, u.K, u.VOCAB)
    n = rows.shape[0]
    valbits = corpora.uniform_valbits(nnz, n, dev)
    pairs = corpora.uniform_pairs(nnz, n, dev)
    packed = corpora.q8_words(rows, nnz, n_docs)
    offsets_dev = torch.from_numpy(offsets).to(dev)
    gb = {"f32": (rows.nbytes + valbits.nbytes) / 1e9,
          "bf16": (rows.nbytes + pairs.nbytes) / 1e9,
          "q8": packed.nbytes / 1e9}
    common.log(f"uniform index: {nnz} postings; f32 {gb['f32']:.2f} GB, "
               f"bf16 {gb['bf16']:.2f} GB, q8 {gb['q8']:.2f} GB")

    tiles = u.query_tiles(np.random.default_rng(args.seed), u.N_TILES + 1)
    jobs = {"f32": need(tiles, offsets, CHUNK),
            "bf16": need(tiles, offsets, CHUNK2)}
    jobs["q8"] = jobs["f32"]
    chunk = {"f32": CHUNK, "bf16": CHUNK2, "q8": CHUNK}
    slab = {k: slab_jobs(j, chunk[k]) for k, j in jobs.items()}
    common.log(f"jobs a query (exact bound -> slab): "
               f"{ {k: (jobs[k], slab[k]) for k in jobs} }")
    scale = float(corpora.q8_scales(u.VOCAB)[0])
    dev_tiles = [(torch.from_numpy(qt).to(dev), torch.from_numpy(qv).to(dev))
                 for qt, qv in tiles]
    q8_tiles = [(qt, qv * scale) for qt, qv in dev_tiles]

    def f32(t):
        return segsort_retrieve_dma(rows, valbits, offsets_dev, t[0], t[1],
                                    u.TOPK, slab["f32"], n_docs)

    def bf16(t):
        return segsort_retrieve_dma_bf16(rows, pairs, offsets_dev, t[0],
                                         t[1], u.TOPK, slab["bf16"], n_docs)

    def q8(t, ops=KERNELS):
        return segsort_retrieve_dma_q8(packed, offsets_dev, t[0], t[1],
                                       u.TOPK, slab["q8"], n_docs, ops)

    arms = {name: u.run_arm(name, fn, arm_tiles, dev)
            for name, fn, arm_tiles in (("f32", f32, dev_tiles),
                                        ("bf16", bf16, dev_tiles),
                                        ("q8", q8, q8_tiles))}
    plain_tiles = q8_tiles[1:1 + u.PLAIN_TILES]
    q8(plain_tiles[0], PLAIN)[0].cpu()
    plain_dt = common.timed(plain_tiles, lambda t: q8(t, PLAIN),
                            lambda out: out[0].cpu(), dev)
    plain_qps = sum(len(t[0]) for t in plain_tiles) / plain_dt
    common.log(f"q8 with ops=PLAIN: {plain_qps:.1f} QPS over "
               f"{len(plain_tiles)} tiles")

    outs = {name: [np.concatenate(x) for x in zip(*arm.pop("out"))]
            for name, arm in arms.items()}
    identical = {}
    for name in ("bf16", "q8"):
        def same(name=name):
            identical[name] = corpora.cross_check(*outs["f32"], *outs[name],
                                                  atol=ATOL)
        checks.run(f"{name} == f32 on all {len(outs['f32'][0])} timed "
                   f"queries (atol, rtol {ATOL}; rows differ on ties only)",
                   same)
    for name, arm in arms.items():
        arm.update(gb=gb[name], jobs=jobs[name], slab_jobs=slab[name])
    q8_qps = arms["q8"]["qps"]
    return common.emit({
        "metric": "sparse_retrieval_qps_q8_index",
        "value": q8_qps,
        "unit": (f"queries/sec ({n_docs} docs, {nnz} uniform postings as q8 "
                 f"(row24 << 8) | code8 words, {gb['q8']:.2f} GB against "
                 f"bf16 {gb['bf16']:.2f} and f32 {gb['f32']:.2f}; "
                 f"{u.L0_Q}-term queries, top-{u.TOPK}, {u.TILE}-query "
                 f"tiles, depth 2, one card, median of {u.N_PASSES} passes "
                 f"of {u.N_TILES} tiles; same-run f32 "
                 f"{arms['f32']['qps']:.1f}, bf16 {arms['bf16']['qps']:.1f})"),
        "vs_baseline": q8_qps / plain_qps,
        "baseline": {"what": f"the q8 arm with ops=PLAIN over "
                             f"{len(plain_tiles)} tiles", "qps": plain_qps},
        "rows_identical_bf16": identical.get("bf16"),
        "rows_identical_q8": identical.get("q8"),
        "card": card_s, "device": str(dev), "arms": arms,
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
