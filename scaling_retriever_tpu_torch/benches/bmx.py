"""The clustered corpus under block-max pruning on one card (the port's
counterpart of ``bench_bmx.py``).

    python3 -m scaling_retriever_tpu_torch.benches.bmx [--cover 4,8]
        [--topk 10] [--device cpu]

bench_bmx.py's corpus at its published sizes, made on the device
(``benches.corpora``): 1,024 topic clusters of 8,634 docs plus a
cluster-free block (8,849,850 docs), 64 topical terms a cluster posting
8,192 times inside it at high impact and 4,096 times outside, 2,000
generic terms posting 40,960 times corpus-wide (887,226,368 postings,
7.1 GB in f32), every list doc-sorted. The block-max meta (256-posting
sub-blocks) is computed from the device's tensors by
``build_chunk_meta``. Queries are SPLADE-shaped: 12 topical terms of one
cluster at weights in [0.7, 1.3) plus 10 generic terms in [0.2, 0.5), in
a 32-term budget.

Arms, as bench_bmx.py runs them, over the same 12 tiles of 64 queries
(768):
  * ``base``: the unpruned ``SegsortEngine`` (B1, B4, B5) on 32-query
    tiles (the 32k-slot cap: 544 jobs a query take bucket 768) through
    the depth-2 pipeline;
  * ``bmx@<cover>``, one for each ``--cover`` value: the
    ``BlockMaxSegsortEngine`` (B1 at its second site, B4, B5) with
    cover <cover> (pass 1 keeps the sub-block regions covering
    cover x top-k docs) and the engine's default gate 0.85, on 64-query
    tiles through ``staged_pipeline(d1=2, d2=2)``.
Each arm runs two untimed passes, then one timed pass. Checks: the timed
scores equal the warm pass's (atol 1e-5); every cover equals the
unpruned engine on all 768 queries (bench_bmx.py's ``cross_check``:
scores within 2e-4, rows differing only on ties); one tile of the best
cover equals the block-max engine with ``ops=PLAIN`` (tie-equal, rtol
1e-5). ``vs_baseline`` is the best cover's QPS over the base's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.ops.blockmax import BlockMaxSegsortEngine
from scaling_retriever_tpu_torch.ops.segsort_scoring import PLAIN
from scaling_retriever_tpu_torch.utils.utils import (depth2_pipeline,
                                                     staged_pipeline,
                                                     tie_equal_topk)

TOPK = 1000
TILE = 64               # block-max tiles; the base engine rides TILE // 2
T_BUDGET = 32
N_TILES = 12            # the timed stream: 768 queries
CFG: dict = {}          # make_cfg overrides (a cut of the corpus)


def run_stream(engine, tiles, topk: int, staged: bool):
    """One pass over ``tiles``; returns (scores, rows, seconds), the
    results concatenated on the host."""
    out_s, out_r = [], []

    def dispatch(t):
        return engine.retrieve_tile_async(None, topk, sparsified=t)

    def drain(p):
        s, r = engine.finalize(p)
        out_s.append(s)
        out_r.append(r)

    t0 = time.perf_counter()
    if staged:
        staged_pipeline(tiles, dispatch, engine.continue_async, drain, d1=2,
                        d2=2)
    else:
        depth2_pipeline(tiles, dispatch, drain)
    dt = time.perf_counter() - t0
    return np.concatenate(out_s), np.concatenate(out_r), dt


def main(argv=None) -> int:
    ap = common.parser(__doc__, topk=TOPK)
    ap.add_argument("--cover", default="4.0",
                    help="comma list of block-max covers, one arm each")
    args = ap.parse_args(argv)
    covers = [float(c) for c in args.cover.split(",")]
    topk = args.topk
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    cfg = corpora.make_cfg(**CFG)
    t0 = time.perf_counter()
    csr, meta, base = corpora.clustered_index(dev, cfg, topk, T_BUDGET)
    common.sync(dev)
    common.log(f"clustered index: {cfg['NNZ']} postings, {cfg['N']} docs in "
               f"{cfg['C']} clusters, {len(meta['sub_max'])} sub-blocks, on "
               f"the device with its meta in {time.perf_counter() - t0:.1f} s "
               f"({(csr[0].nbytes + csr[1].nbytes) / 1e9:.2f} GB)")

    tiles = corpora.make_tiles(cfg, np.random.default_rng(args.seed),
                               N_TILES, TILE, T_BUDGET)
    half = TILE // 2
    tiles_base = [(qt[i:i + half], qv[i:i + half])
                  for qt, qv in tiles for i in (0, half)]
    lens = np.diff(cfg["offsets"])
    matched = float((lens[tiles[0][0]] * (tiles[0][1] > 0)).sum(1).mean())
    common.log(f"query stream: {N_TILES * TILE} queries, ~{matched:.0f} "
               f"matched postings a query")

    engines = [("base", base, tiles_base, False)] + [
        (f"bmx@{c:g}", BlockMaxSegsortEngine(
            None, topk=topk, query_terms_budget=T_BUDGET, cover=c,
            meta=meta, device_csr=csr), tiles, True) for c in covers]
    arms, results = {}, {}
    for name, eng, arm_tiles, staged in engines:
        s0, _, warm_s = run_stream(eng, arm_tiles, topk, staged)
        run_stream(eng, arm_tiles, topk, staged)
        s1, r1, dt = run_stream(eng, arm_tiles, topk, staged)
        checks.run(f"{name}: timed pass == warm pass (atol 1e-5)",
                   lambda s0=s0, s1=s1: np.testing.assert_allclose(
                       s1, s0, atol=1e-5))
        results[name] = (s1, r1)
        arms[name] = {"qps": len(s1) / dt,
                      "ms_per_tile": dt / len(arm_tiles) * 1e3,
                      "tiles": len(arm_tiles), "tile": len(arm_tiles[0][0]),
                      "first_pass_s": warm_s}
        if staged:
            st = eng.stats()
            arms[name]["stats"] = st
            arms[name]["host_ms_per_tile"] = {
                k: v / (3 * len(arm_tiles)) for k, v in st["host_ms"].items()}
        common.log(f"{name}: {arms[name]['qps']:.1f} QPS "
                   f"({arms[name]['ms_per_tile']:.2f} ms per "
                   f"{arms[name]['tile']}-query tile)"
                   + (f"; stats {arms[name]['stats']}" if staged else ""))

    bmx_names = [name for name, *_ in engines[1:]]
    for name in bmx_names:
        def same(name=name):
            arms[name]["rows_identical"] = corpora.cross_check(
                *results[name], *results["base"])
        checks.run(f"{name} == the unpruned engine on all "
                   f"{len(results['base'][0])} queries (cross_check 2e-4)",
                   same)
    best = max(bmx_names, key=lambda n: arms[n]["qps"])
    plain = BlockMaxSegsortEngine(
        None, topk=topk, query_terms_budget=T_BUDGET,
        cover=covers[bmx_names.index(best)], meta=meta, device_csr=csr,
        ops=PLAIN)
    s_p, r_p = plain.finalize(plain.retrieve_tile_async(
        None, topk, sparsified=tiles[0]))
    s_x, r_x = (a[:TILE] for a in results[best])

    def same_plain():
        for q in range(TILE):
            tie_equal_topk(r_p[q], s_p[q], r_x[q], s_x[q], rtol=1e-5)

    checks.run(f"{best} == the block-max engine with ops=PLAIN on a tile "
               f"(tie-equal, rtol 1e-5)", same_plain)
    best_qps = arms[best]["qps"]
    return common.emit({
        "metric": "sparse_retrieval_qps_clustered_bmx",
        "value": best_qps,
        "unit": (f"queries/sec ({cfg['N']} docs, {cfg['NNZ']} postings, "
                 f"{cfg['C']} doc-reordered topic clusters, ~{matched:.0f} "
                 f"matched postings a query, top-{topk}, exact, one card; "
                 f"block-max {best} over {TILE}-query tiles, staged "
                 f"pipeline; unpruned engine {arms['base']['qps']:.1f})"),
        "vs_baseline": best_qps / arms["base"]["qps"],
        "baseline": {"what": "the unpruned SegsortEngine on the same "
                             "queries", "qps": arms["base"]["qps"]},
        "rows_identical": arms[best].get("rows_identical"),
        "best_cover": best,
        "card": card_s, "device": str(dev), "arms": arms,
        "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
