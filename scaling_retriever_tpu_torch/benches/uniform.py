"""Uniform sparse retrieval QPS at MSMARCO scale on one card (the port's
counterpart of ``bench.py``).

    python3 -m scaling_retriever_tpu_torch.benches.uniform [--device cpu]

The index is bench.py's, made on the device: 8,841,823 docs, 128 postings
a doc, vocab 128,256 (1,131,730,944 postings, every value 1.0). Queries
are 48 terms in a 64-term budget, 64-query tiles, top-1000, run through
``segsort_retrieve_dma`` (B1, B4, B5) with 512 jobs a query, tile i+1
dispatched before tile i's host read. Two layouts run in one invocation
on the same tiles: f32 (rows + value bits, 9.1 GB), then q8 (one
``(row24 << 8) | code8`` word a posting, 4.5 GB, packed in place of the
rows after the value bits are freed; B2 in place of B1). Each arm reports
the median of 3 passes over 12 timed tiles. The q8 codes are lossless
here, so the arms must agree on a check tile (rtol 2e-5, bench.py's
check). The baseline is the same f32 arm with ``ops=PLAIN`` (the kernels'
plain PyTorch versions) over 2 tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    KERNELS, PLAIN, segsort_retrieve_dma, segsort_retrieve_dma_q8,
)
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

N_DOCS = 8_841_823      # MSMARCO passage collection size
K = 128                 # postings per doc (SPLADE-like L0_d)
VOCAB = 128_256         # Llama-3 vocab
L0_Q = 48               # query nonzeros
TOPK = 1000
TILE = 64               # queries per device call
T_BUDGET = 64           # query term budget
JOBS_PER_QUERY = 512    # covers the ~480 jobs a 48-term query needs here
N_TILES = 12            # timed tiles per pass
N_PASSES = 3            # the median pass is reported
PLAIN_TILES = 2


def query_tiles(rng, n: int) -> list:
    """bench.py's tiles: uniform terms, weights in [0.1, 2), the slots past
    L0_Q unused."""
    tiles = []
    for _ in range(n):
        qt = rng.integers(0, VOCAB, (TILE, T_BUDGET)).astype(np.int32)
        qv = rng.uniform(0.1, 2.0, (TILE, T_BUDGET)).astype(np.float32)
        qv[:, L0_Q:] = 0.0
        tiles.append((qt, qv))
    return tiles


def run_arm(name: str, dispatch, tiles, dev) -> dict:
    """Warm, then N_PASSES timed passes over tiles[1:]; returns the arm's
    numbers and, under "out", the last pass's results on the host, one
    (scores, rows) a tile, for the cross-arm checks."""
    out: list = []

    def drain(res):
        out.append((res[0].cpu().numpy(), res[1].cpu().numpy()))

    for _ in range(4):
        drain(dispatch(tiles[0]))
    n_q = sum(len(t[0]) for t in tiles[1:])
    pass_qps = []
    for p in range(N_PASSES):
        out.clear()
        dt = common.timed(tiles[1:], dispatch, drain, dev)
        pass_qps.append(n_q / dt)
        common.log(f"{name} pass {p}: {n_q} queries in {dt:.3f} s -> "
                   f"{pass_qps[-1]:.1f} QPS ({dt / (len(tiles) - 1) * 1e3:.2f}"
                   f" ms per {len(tiles[1][0])}-query tile)")
    return {"qps": float(np.median(pass_qps)), "pass_qps": pass_qps,
            "out": list(out)}


def main(argv=None) -> int:
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    rows, offsets, nnz = corpora.uniform_rows(dev, N_DOCS, K, VOCAB)
    valbits = corpora.uniform_valbits(nnz, rows.shape[0], dev)
    offsets_dev = torch.from_numpy(offsets).to(dev)
    gb = {"f32": (rows.nbytes + valbits.nbytes) / 1e9,
          "q8": rows.nbytes / 1e9}
    common.log(f"uniform index: {nnz} postings, f32 {gb['f32']:.2f} GB")

    tiles = query_tiles(np.random.default_rng(args.seed), N_TILES + 1)
    need = corpora.jobs_for(tiles, offsets, np.diff(offsets))
    checks.run("job table covers every matched posting",
               lambda: np.testing.assert_array_less(need,
                                                    JOBS_PER_QUERY + 1))
    scale = float(corpora.q8_scales(VOCAB)[0])
    dev_tiles = [(torch.from_numpy(qt).to(dev), torch.from_numpy(qv).to(dev))
                 for qt, qv in tiles]
    q8_tiles = [(qt, qv * scale) for qt, qv in dev_tiles]

    def f32(t, ops=KERNELS):
        return segsort_retrieve_dma(rows, valbits, offsets_dev, t[0], t[1],
                                    TOPK, JOBS_PER_QUERY, N_DOCS, ops)

    arms = {"f32": run_arm("f32", f32, dev_tiles, dev)}
    plain_tiles = dev_tiles[1:1 + PLAIN_TILES]
    f32(plain_tiles[0], PLAIN)[0].cpu()
    plain_dt = common.timed(plain_tiles, lambda t: f32(t, PLAIN),
                            lambda out: out[0].cpu(), dev)
    plain_qps = TILE * len(plain_tiles) / plain_dt
    common.log(f"f32 with ops=PLAIN: {plain_qps:.1f} QPS over "
               f"{len(plain_tiles)} tiles")

    del valbits   # the rows become the q8 words in place: one 4.5 GB buffer
    corpora.q8_words(rows, nnz, N_DOCS, out=rows)

    def q8(t):
        return segsort_retrieve_dma_q8(rows, offsets_dev, t[0], t[1], TOPK,
                                       JOBS_PER_QUERY, N_DOCS)

    arms["q8"] = run_arm("q8", q8, q8_tiles, dev)

    s_a, r_a = arms["f32"].pop("out")[0]
    s_b, r_b = arms["q8"].pop("out")[0]

    def same_arms():
        np.testing.assert_allclose(s_a, s_b, rtol=2e-5, atol=2e-5)
        for i in range(len(s_a)):
            tie_equal_topk(r_a[i], s_a[i], r_b[i], s_b[i], rtol=2e-5,
                           atol=2e-5)

    checks.run("q8 == f32 on the check tile (rtol 2e-5)", same_arms)
    for name, arm in arms.items():
        arm["gb"] = gb[name]
    best = max(arms, key=lambda a: arms[a]["qps"])
    return common.emit({
        "metric": "sparse_retrieval_qps_uniform",
        "value": arms[best]["qps"],
        "unit": (f"queries/sec ({N_DOCS} docs, {nnz} uniform postings, "
                 f"vocab {VOCAB}, {L0_Q}-term queries, top-{TOPK}, "
                 f"{TILE}-query tiles, depth 2, one card, {best} layout, "
                 f"median of {N_PASSES} passes of {N_TILES} tiles)"),
        "vs_baseline": arms[best]["qps"] / plain_qps,
        "baseline": {"what": f"the f32 arm with ops=PLAIN over "
                             f"{len(plain_tiles)} tiles", "qps": plain_qps},
        "card": card_s, "device": str(dev), "arms": arms,
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
