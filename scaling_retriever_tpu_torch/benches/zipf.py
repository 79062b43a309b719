"""Sparse retrieval QPS over the power-law (zipf) index at MSMARCO scale on
one card (the port's counterpart of ``bench_zipf.py``).

    python3 -m scaling_retriever_tpu_torch.benches.zipf [--device cpu]

The index is bench_zipf.py's, made on the device (``corpora.ZipfCorpus``):
8,841,823 docs, 13 dyadic bands from 16 terms of 4,000,000 postings at
ratio 0.52 (1,064,158,464 postings, 8.5 GB as f32), impacts (1 + j)^-0.6.
Two query streams of 12 timed 64-query tiles (48 terms each): one whose
sampling exponent is calibrated to 425,000 matched postings a query
(MSMARCO's), and a hot one (terms ~ len^0.7, millions matched).

* Phase A, the full CSR: the calibrated stream (all 13 tiles) sorted by
  job need and cut into cost-sized tiles (64, 32 or 16 queries, nq x
  bucket within 32,768 job slots, buckets on ``bucket_jobs``'s grid),
  run through
  ``segsort_retrieve_dma`` (B1, B4, B5) depth 2. Baseline: the same
  engine with ``ops=PLAIN`` on 2 of those tiles.
* Phase B, maxscore: the 4,096-deep impact prefix (2.7 GB) scored by the
  same engine at 2,048 candidates, ``rescore_candidates`` over the
  doc-major rows (8.6 GB) with the certificate, and tiles that fail it
  rerun whole on ``retrieve_doc_major``; both streams, tile by tile.

Check: on the first tile of each stream, the rescore's certified rows,
the maxscore results and the doc-major scan each equal the full-CSR
segsort (tie-equal, rtol 1e-5).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, corpora
from scaling_retriever_tpu_torch.ops.fetch import CHUNK
from scaling_retriever_tpu_torch.ops.maxscore import rescore_candidates
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    KERNELS, PLAIN, bucket_jobs, segsort_retrieve_dma,
)
from scaling_retriever_tpu_torch.ops.sparse_scoring import retrieve_doc_major
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

SPEC = corpora.ZipfSpec()
TOPK = 1000
C_CAND = 2048             # phase-B candidates (certificate width)
TILE = 64
T_BUDGET = 64
L0_Q = 48
N_TILES = 12              # timed tiles per stream
DOC_BLOCK = 4096          # doc-major scan block
S_SLOTS = 32768           # nq x job bucket cap of a phase-A tile
TARGET_MATCHED = 425_000.0
HOT_ALPHA = 0.7
PLAIN_TILES = 2


def cost_tiles(t: dict, tiles) -> list:
    """bench_zipf's phase-A schedule: the stream sorted by job need, cut
    into tiles of 64, 32 or 16 queries whose nq x bucket stays within
    S_SLOTS (16 always). Returns [(qt, qv, bucket, n_real)], pads zero."""
    all_qt = np.concatenate([qt for qt, _ in tiles])
    all_qv = np.concatenate([qv for _, qv in tiles])
    need = corpora.job_need(all_qt, all_qv, t["offsets"], t["lens"])
    order = np.argsort(need, kind="stable")
    all_qt, all_qv, need = all_qt[order], all_qv[order], need[order]
    out = []
    s0 = 0
    while s0 < len(all_qt):
        for nq in (64, 32, 16):
            hi = min(s0 + nq, len(all_qt))
            bucket = bucket_jobs(int(need[s0:hi].max()))
            if nq * bucket <= S_SLOTS or nq == 16:
                pad = nq - (hi - s0)
                out.append((np.pad(all_qt[s0:hi], ((0, pad), (0, 0))),
                            np.pad(all_qv[s0:hi], ((0, pad), (0, 0))),
                            bucket, hi - s0))
                s0 = hi
                break
    return out


def same_results(a, b) -> None:
    """Two (scores, rows) [nq, k] results agree on each query's docs of
    positive score (tie-equal, rtol 1e-5)."""
    for i in range(len(a[0])):
        tie_equal_topk(*common.positive(a[1][i], a[0][i]),
                       *common.positive(b[1][i], b[0][i]), rtol=1e-5)


class ZipfSearch:
    """The driver's engines over one ``ZipfCorpus``: the full-CSR segsort
    (``full_ref``: a tile in groups within S_SLOTS), and after
    ``build_maxscore``, maxscore over the impact prefix (``ms_tile``) with
    the doc-major scan (``exhaustive``) as its fallback."""

    def __init__(self, corpus, full_rows, full_bits):
        self.t = corpus.t
        self.corpus = corpus
        self.n_docs = corpus.spec.n_docs
        self.full = (full_rows, full_bits, self.on_dev(self.t["offsets"]))

    def on_dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.corpus.dev)

    def full_tile(self, qt, qv, bucket: int, ops=KERNELS):
        return segsort_retrieve_dma(*self.full, self.on_dev(qt),
                                    self.on_dev(qv), TOPK, bucket,
                                    self.n_docs, ops)

    def full_ref(self, qt, qv):
        """(scores, rows) of a tile on the full CSR, run in groups of
        queries whose nq x bucket stays within S_SLOTS."""
        need = corpora.job_need(qt, qv, self.t["offsets"], self.t["lens"])
        s_out, r_out = [], []
        i = 0
        while i < len(qt):
            n = 1
            while (i + n < len(qt) and (n + 1) * bucket_jobs(
                    int(need[i:i + n + 1].max())) <= S_SLOTS):
                n += 1
            s, r, _ = self.full_tile(qt[i:i + n], qv[i:i + n],
                                     bucket_jobs(int(need[i:i + n].max())))
            s_out.append(s.cpu().numpy())
            r_out.append(r.cpu().numpy())
            i += n
        return np.concatenate(s_out), np.concatenate(r_out)

    def build_maxscore(self, tiles) -> dict:
        """The prefix CSR, the doc-major side and the prefix job budget of
        ``tiles``; returns their sizes in GB."""
        t = self.t
        self.pre = (*self.corpus.csr(prefix=True),
                    self.on_dev(t["pre_offsets"]))
        self.doc_terms, self.doc_vals, _ = self.corpus.doc_major(DOC_BLOCK)
        self.jobs_pre = corpora.jobs_for(tiles, t["pre_offsets"],
                                         t["pre_lens"])
        return {"prefix_csr": (self.pre[0].nbytes + self.pre[1].nbytes) / 1e9,
                "doc_major": (self.doc_terms.nbytes
                              + self.doc_vals.nbytes) / 1e9}

    def exhaustive(self, qt, qv):
        """The doc-major scan of a tile: (scores, rows)."""
        q_dense = np.zeros((self.t["V"], len(qt)), np.float32)
        for i in range(len(qt)):
            nz = qv[i] > 0
            q_dense[qt[i][nz], i] = qv[i][nz]
        s, r = retrieve_doc_major(self.doc_terms, self.doc_vals,
                                  self.on_dev(q_dense), TOPK, DOC_BLOCK)
        return s.cpu().numpy(), r.cpu().numpy()

    def rescore(self, qt, qv):
        """The prefix segsort at C_CAND candidates and the exact rescore
        with its certificate: (scores, rows, ok [nq])."""
        bound = (self.t["u_arr"][qt] * qv * (qv > 0)).sum(1).astype(
            np.float32)
        qt_d, qv_d = self.on_dev(qt), self.on_dev(qv)
        ps, pr, _ = segsort_retrieve_dma(*self.pre, qt_d, qv_d, C_CAND,
                                         self.jobs_pre, self.n_docs)
        s, r, ok = rescore_candidates(self.doc_terms, self.doc_vals, ps, pr,
                                      qt_d, qv_d, self.on_dev(bound), TOPK,
                                      self.n_docs)
        return s.cpu().numpy(), r.cpu().numpy(), ok.cpu().numpy()

    def ms_tile(self, qt, qv):
        """maxscore on a tile: ``rescore``, and the whole tile on the
        doc-major scan if a query fails the certificate. Returns (scores,
        rows, certified queries, fell back)."""
        s, r, ok = self.rescore(qt, qv)
        if not ok.all():
            return (*self.exhaustive(qt, qv), int(ok.sum()), True)
        return s, r, int(ok.sum()), False

    def check_tile(self, checks, label: str, qt, qv):
        """On one tile, the certified rows of the rescore, the maxscore
        result and the doc-major scan each equal the full-CSR segsort."""
        ref = self.full_ref(qt, qv)
        s, r, ok = self.rescore(qt, qv)
        ms = self.ms_tile(qt, qv)
        common.log(f"{label} check tile: certified {int(ok.sum())}/"
                   f"{len(qt)}, fell back {ms[3]}")
        checks.run(f"{label}: certified rescore rows == full-CSR segsort",
                   lambda: same_results((s[ok], r[ok]),
                                        (ref[0][ok], ref[1][ok])))
        checks.run(f"{label}: maxscore == full-CSR segsort",
                   lambda: same_results(ms[:2], ref))
        checks.run(f"{label}: doc-major scan == full-CSR segsort",
                   lambda: same_results(self.exhaustive(qt, qv), ref))


def main(argv=None) -> int:
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    corpus = corpora.ZipfCorpus(SPEC, dev)
    t = corpus.t
    if t["nnz"] + CHUNK >= 2 ** 31:
        raise ValueError("the flat CSR must stay within int32")
    rng = np.random.default_rng(args.seed)
    alpha = corpora.calibrate_alpha(t, TARGET_MATCHED, L0_Q)
    real = corpora.make_queries(t, rng, N_TILES + 1, alpha, TILE, T_BUDGET,
                                L0_Q)
    hot = corpora.make_queries(t, rng, N_TILES + 1, HOT_ALPHA, TILE,
                               T_BUDGET, L0_Q)
    matched = {name: float(np.mean([(t["lens"][qt] * (qv > 0)).sum(1).mean()
                                     for qt, qv in tiles]))
               for name, tiles in (("calibrated", real), ("hot", hot))}
    common.log(f"zipf index: V {t['V']}, {t['nnz']} postings, lists "
               f"{t['L'][0]}..{t['L'][-1]}; alpha {alpha:.4f}; matched a "
               f"query {matched}")

    # ---- phase A: the full CSR, cost-sized tiles -----------------------
    search = ZipfSearch(corpus, *corpus.csr(prefix=False))
    gb = {"full_csr": (search.full[0].nbytes + search.full[1].nbytes) / 1e9}
    seg = cost_tiles(t, real)
    variants = sorted({(qt.shape[0], b) for qt, _, b, _ in seg})
    common.log(f"segsort-full: {len(seg)} cost-sized tiles, (nq, bucket) "
               f"variants {variants}")

    def seg_dispatch(tile, ops=KERNELS):
        return search.full_tile(tile[0], tile[1], tile[2], ops)

    def drain(out):
        out[0].cpu()
        out[1].cpu()

    for nqv, b in variants:     # the first runs of a shape pay allocation
        tile = next(x for x in seg if x[0].shape[0] == nqv and x[2] == b)
        for _ in range(2):
            drain(seg_dispatch(tile))
    n_seg_q = sum(x[3] for x in seg)
    dt = common.timed(seg, seg_dispatch, drain, dev)
    seg_qps = n_seg_q / dt
    common.log(f"segsort-full (calibrated stream): {seg_qps:.1f} QPS "
               f"({n_seg_q} queries, {dt / len(seg) * 1e3:.2f} ms a tile)")
    mid = seg[len(seg) // 2:len(seg) // 2 + PLAIN_TILES]
    n_mid = sum(x[3] for x in mid)
    drain(seg_dispatch(mid[0], PLAIN))
    plain_qps = n_mid / common.timed(mid, lambda x: seg_dispatch(x, PLAIN),
                                     drain, dev)
    same_qps = n_mid / common.timed(mid, seg_dispatch, drain, dev)
    common.log(f"ops=PLAIN on {len(mid)} tiles: {plain_qps:.1f} QPS "
               f"(the kernels on the same tiles: {same_qps:.1f})")

    # ---- phase B: maxscore over the impact prefix ----------------------
    gb.update(search.build_maxscore(real + hot))
    common.log(f"prefix {SPEC.prefix}: {t['pre_nnz']} postings; GB {gb}; "
               f"maxscore jobs_per_query {search.jobs_pre}")
    for name, tiles in (("calibrated", real), ("hot", hot)):
        search.check_tile(checks, name, *tiles[0])

    def timed_stream(tiles, label):
        search.ms_tile(*tiles[0])
        common.sync(dev)
        t0 = time.perf_counter()
        cert = fb = 0
        for qt, qv in tiles[1:]:
            _, _, n_cert, fell = search.ms_tile(qt, qv)
            cert += n_cert
            fb += int(fell)
        dt = time.perf_counter() - t0
        nq = TILE * (len(tiles) - 1)
        common.log(f"maxscore ({label}): {nq} queries in {dt:.3f} s -> "
                   f"{nq / dt:.1f} QPS (certified {cert / nq:.1%}, {fb} "
                   f"fallback tiles)")
        return {"qps": nq / dt, "certified": cert / nq, "fallback_tiles": fb}

    arms = {"segsort_full": {"qps": seg_qps, "tiles": len(seg),
                             "variants": [list(v) for v in variants]},
            "maxscore": timed_stream(real, "calibrated stream"),
            "maxscore_hot": timed_stream(hot, "hot stream")}
    best = max(("segsort_full", "maxscore"), key=lambda a: arms[a]["qps"])
    return common.emit({
        "metric": "sparse_retrieval_qps_zipf",
        "value": arms[best]["qps"],
        "unit": (f"queries/sec ({SPEC.n_docs} docs, {t['nnz']} power-law "
                 f"postings, {L0_Q}-term queries calibrated to "
                 f"{matched['calibrated']:.0f} matched postings, top-{TOPK},"
                 f" exact, one card, engine {best})"),
        "vs_baseline": arms[best]["qps"] / plain_qps,
        "baseline": {"what": f"segsort_full with ops=PLAIN over {len(mid)} "
                             f"of its tiles", "qps": plain_qps,
                     "kernels_same_tiles_qps": same_qps},
        "card": card_s, "device": str(dev), "arms": arms,
        "streams": {"alpha": alpha, "matched_per_query": matched},
        "gb": gb, "launches": common.since(before),
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
