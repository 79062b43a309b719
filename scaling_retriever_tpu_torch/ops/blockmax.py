"""Block-max doc-range pruned segsort ("bmx") for clustered corpora (port
of ops/blockmax.py).

On a corpus whose documents are ordered so that topics occupy contiguous
doc-id ranges (a BP/URL-style reorder), whole fetch windows of a query's
posting lists cover doc ranges that cannot reach the top-k, and skipping
them is exact:

* ``build_chunk_meta``: per term, per SUB-posting sub-block (default 256)
  of its doc-sorted posting list, the sub-block's max impact and its
  [lo, hi] doc span. Windows mirror the fetch's job grid (CHUNK postings
  from ALIGN-aligned sources), each owning R = CHUNK // SUB sub-blocks.
* the UB overlay: each sub-block contributes qw * sub_max on its doc span;
  summing all of a query's step functions (one event sweep) gives, for
  every doc, an upper bound on its score.
* two passes, both through B1 and the segsort rank tail over a job table
  the host builds: pass 1 keeps the top-UB doc regions covering
  ``cover * k`` docs and scores them exactly; its k-th score tau1 is a
  lower bound of the true k-th. If every dropped segment's UB is below
  tau1, pass 1 is final; otherwise pass 2 keeps every segment with
  UB >= tau1 and rescores, which is exact by construction.
* a gate: when pruning would keep more than ``gate`` of the windows, the
  tile runs through the unpruned base engine.

The host pruner (overlay, thresholds, keep masks, job tables) is numpy, as
in the reference; this module keeps its own copy of it. Results are exact
(the same top-k set and scores as brute force) but not bit-identical to
the unpruned engine: a pruned job table lays postings out in other slots,
so each doc's contributions sum in another order.

The engine is f32-only: its meta and job grid are CHUNK geometry and it
fetches through B1 (``Ops.fetch_bmx``, counted under its own launch key).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.ops.fetch import ALIGN, CHUNK
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    KERNELS, Ops, SegsortEngine, _finish, _pack_score_rows, _rank_tail_async,
    bucket_jobs,
)


# ---------------------------------------------------------------------------
# chunk metadata


def check_doc_sorted(offsets: np.ndarray, doc_rows: np.ndarray) -> bool:
    """True iff every posting list is ascending in doc row (the block-max
    doc-span meta is meaningless otherwise). O(nnz) single compare."""
    if len(doc_rows) < 2:
        return True
    asc = doc_rows[1:] >= doc_rows[:-1]
    # positions where a new list starts may descend freely
    starts = np.asarray(offsets[1:-1], dtype=np.int64)
    starts = starts[(starts > 0) & (starts < len(doc_rows))]
    asc[starts - 1] = True
    return bool(asc.all())


def build_chunk_meta(offsets: np.ndarray, doc_rows, values,
                     sub: int = 256) -> dict:
    """Per-(term, sub-block) metadata at SUB-posting granularity, padded
    so every fetch window owns exactly R = CHUNK // sub sub-blocks. Term
    t's window j is the flat slice [src_al + j*CHUNK, src_al + (j+1)*CHUNK)
    with src_al = (offsets[t] // ALIGN) * ALIGN, restricted to t's list;
    its sub-block r covers [src_al + (j*R + r)*sub, ...+sub) ∩ list.

    ``doc_rows`` and ``values`` are numpy arrays or tensors (on any
    device, e.g. a ``device_csr`` index on the card, padded past
    ``offsets[-1]``); the per-sub-block max and spans are then computed
    where the data lives and only the result comes to the host.

    Returns a host dict with ``term_chunk_offset`` [V+1] (CSR over
    per-term window counts; sub-block s belongs to window s // R),
    ``sub_max`` [NC*R] f32 (max impact in sub-block ∩ list; 0 for padded
    empty sub-blocks), ``sub_lo``/``sub_hi`` [NC*R] int32 (doc span of
    sub-block ∩ list; empty sub-blocks get lo=0, hi=-1, an interval no doc
    inhabits), and ``sub``."""
    if CHUNK % sub:
        raise ValueError(f"sub {sub} must divide CHUNK {CHUNK}")
    R = CHUNK // sub
    offsets = np.asarray(offsets, np.int64)
    V = len(offsets) - 1
    starts, ends = offsets[:-1], offsets[1:]
    src_al = (starts // ALIGN) * ALIGN
    n_ch = np.where(ends > starts, -(-(ends - src_al) // CHUNK), 0)
    tco = np.zeros(V + 1, np.int64)
    np.cumsum(n_ch, out=tco[1:])
    ns = int(tco[-1]) * R
    term_of = np.repeat(np.arange(V, dtype=np.int64), n_ch * R)
    j_of = np.arange(ns, dtype=np.int64) - tco[term_of] * R
    w0 = src_al[term_of] + j_of * sub
    seg_lo = np.maximum(w0, starts[term_of])
    seg_hi = np.minimum(w0 + sub, ends[term_of])
    live = seg_hi > seg_lo
    sub_max = np.zeros(ns, np.float32)
    sub_lo = np.zeros(ns, np.int32)
    sub_hi = np.full(ns, -1, np.int32)
    if live.any():
        lo, hi = seg_lo[live], seg_hi[live]
        if isinstance(values, torch.Tensor):
            # live segments tile [lo[0], hi[-1]) contiguously (CSR ends[t]
            # == starts[t+1]), so one segment_reduce over that slice gives
            # every sub-block ∩ list max
            dev = values.device
            lengths = torch.from_numpy(hi - lo).to(dev)
            sub_max[live] = torch.segment_reduce(
                values[int(lo[0]):int(hi[-1])].float(), "max",
                lengths=lengths).cpu().numpy()
            ends_idx = torch.from_numpy(np.stack([lo, hi - 1])).to(dev)
            spans = doc_rows[ends_idx].cpu().numpy()
            sub_lo[live], sub_hi[live] = spans[0], spans[1]
        else:
            # the same tiling makes one reduceat cover every max
            sub_max[live] = np.maximum.reduceat(
                np.asarray(values, np.float32), lo)
            sub_lo[live] = doc_rows[lo]
            sub_hi[live] = doc_rows[hi - 1]
    return {"term_chunk_offset": tco, "sub": sub, "sub_max": sub_max,
            "sub_lo": sub_lo, "sub_hi": sub_hi}


# ---------------------------------------------------------------------------
# host-side pruning: UB overlay + keep passes + job tables


def build_overlay(meta: dict, offsets: np.ndarray,
                  q_terms: np.ndarray, q_vals: np.ndarray,
                  n_docs: int) -> Optional[dict]:
    """Per-tile upper-bound step function over doc space, one step per
    (query, candidate sub-block); job-table fields per (query, fetch
    window). Returns None for an all-empty tile."""
    tco = meta["term_chunk_offset"]
    R = CHUNK // meta["sub"]
    nq, T = q_terms.shape
    qt = np.asarray(q_terms, np.int64)
    qv = np.asarray(q_vals, np.float32)
    n_ch_t = np.diff(tco)[qt] * (qv > 0)                       # [nq, T]

    e_cum = np.zeros(nq * T + 1, np.int64)
    np.cumsum(n_ch_t.reshape(-1), out=e_cum[1:])
    E = int(e_cum[-1])                                         # windows
    if E == 0:
        return None
    flat_qt = np.repeat(np.arange(nq * T, dtype=np.int64),
                        n_ch_t.reshape(-1))
    j_within = np.arange(E, dtype=np.int64) - e_cum[flat_qt]
    e_q = flat_qt // T
    e_term = qt.reshape(-1)[flat_qt]
    e_w = qv.reshape(-1)[flat_qt]
    starts_t = offsets[e_term]
    src = ((starts_t // ALIGN) * ALIGN + j_within * CHUNK).astype(np.int64)

    # sub-block expansion: window entry i owns sub entries i*R .. i*R+R-1
    # (meta is padded so every window has exactly R), preserving order —
    # keep_entries lifts sub keeps back with a reshape(-1, R).any()
    gsi = (((tco[e_term] + j_within) * R)[:, None]
           + np.arange(R, dtype=np.int64)).reshape(-1)
    s_q = np.repeat(e_q, R)
    s_ub = np.repeat(e_w, R) * meta["sub_max"][gsi]
    s_lo = meta["sub_lo"][gsi].astype(np.int64)
    s_hi = meta["sub_hi"][gsi].astype(np.int64)    # empty sub: lo=0, hi=-1

    # event sweep over (query-composite) doc space. Each query's deltas
    # net to zero, so one global cumsum over (q, pos)-sorted events is
    # already per-query (bases telescope to 0 at query boundaries).
    OFF = np.int64(n_docs + 2)
    ev_key = np.concatenate([s_q * OFF + s_lo, s_q * OFF + s_hi + 1])
    ev_dlt = np.concatenate([s_ub, -s_ub])
    # negatives first at equal positions: phantom zero-width segments then
    # only dip (can cause extra keeps, never wrong drops). Within an equal
    # (position, sign) group the order is free: settled segment values are
    # the cumsum at the end of each equal-key run, and i0/i1 land on run
    # ends, so one non-stable argsort of a composite key suffices.
    key2 = ev_key * 2 + (ev_dlt > 0)
    order = np.argsort(key2.astype(np.int32) if len(ev_key) == 0
                       or int(key2.max()) < 2 ** 31 else key2)
    ev_key = ev_key[order]
    ev_val = np.cumsum(ev_dlt[order].astype(np.float64)).astype(np.float32)
    n_ev = len(ev_key)
    seg_w = np.empty(n_ev, np.int64)                   # width to next event
    seg_w[:-1] = ev_key[1:] - ev_key[:-1]
    seg_w[-1] = 0
    seg_q = np.concatenate([s_q, s_q])[order]          # == ev_key // OFF
    seg_w[:-1][seg_q[:-1] != seg_q[1:]] = 0            # last segment of a q

    # per-sub-entry segment range, from the sort's inverse permutation and
    # run boundaries: i0 = end of the run holding sub-entry s's own lo
    # event (last index with key <= s_lo), i1 = index just before the run
    # holding its hi+1 event (last index with key <= s_hi). Empty subs
    # (hi = -1) insert both events at the same key, so i1 < i0 and they
    # are never kept.
    inv = np.empty(n_ev, np.int64)
    inv[order] = np.arange(n_ev)
    idx = np.arange(n_ev, dtype=np.int64)
    new_run = np.empty(n_ev, bool)                     # first of a key run
    new_run[0] = True
    np.not_equal(ev_key[1:], ev_key[:-1], out=new_run[1:])
    run_start = np.maximum.accumulate(np.where(new_run, idx, -1))
    run_end = np.empty(n_ev, np.int64)                 # last of a key run
    run_end[:-1] = np.where(new_run[1:], idx[:-1], n_ev)
    run_end[-1] = n_ev - 1
    run_end = np.minimum.accumulate(run_end[::-1])[::-1]
    E2 = len(s_q)
    i0 = run_end[inv[:E2]]
    i1 = run_start[inv[E2:]] - 1
    return {"nq": nq, "R": R, "e_q": e_q, "e_w": e_w, "i0": i0, "i1": i1,
            "src": src,
            "lo_loc": np.clip(starts_t - src, 0, CHUNK).astype(np.int32),
            "hi_loc": np.clip(offsets[e_term + 1] - src, 0, CHUNK
                              ).astype(np.int32),
            "ev_val": ev_val, "seg_w": seg_w, "seg_q": seg_q}


def cover_tau(ov: dict, target_docs: float, nbins: int = 4096) -> np.ndarray:
    """Pass-1 keep threshold per query: the UB level at which the kept
    doc-width first covers ``target_docs`` docs, from a histogram of
    segment widths by UB level (the lower edge of the crossing bin). Any
    tau is correct here: it only sizes pass 1."""
    nq = ov["nq"]
    ev_val, seg_w, seg_q = ov["ev_val"], ov["seg_w"], ov["seg_q"]
    v = np.maximum(ev_val, 0.0)
    vmax = float(v.max(initial=0.0))
    if vmax <= 0.0:
        return np.zeros(nq, np.float32)
    idx = np.minimum((v * np.float32(nbins / vmax)).astype(np.int64),
                     nbins - 1)
    cnt = np.bincount(seg_q * nbins + idx, weights=seg_w,
                      minlength=nq * nbins).reshape(nq, nbins)
    suf = np.cumsum(cnt[:, ::-1], axis=1)           # width above each level
    crossed = suf >= target_docs
    hit = crossed.argmax(axis=1)                    # first (highest) crossing
    tau = ((nbins - 1 - hit) * (vmax / nbins)).astype(np.float32)
    # a query whose total width never reaches target keeps everything
    return np.where(crossed[:, -1], np.maximum(tau, 0.0),
                    np.float32(0.0)).astype(np.float32)


def keep_entries(ov: dict, tau: np.ndarray) -> np.ndarray:
    """Window keep mask for per-query thresholds ``tau``: a sub-block is
    kept iff any settled segment on its doc span has UB >= tau[q]; a fetch
    window is kept iff any of its R sub-blocks is. One global suffix-min
    suffices: indices are query-monotone, so cross-query leakage can only
    fail the <= i1 test (never a wrong keep)."""
    ev_val, seg_q = ov["ev_val"], ov["seg_q"]
    n_ev = len(ev_val)
    keep_seg = ev_val >= tau[seg_q]
    nk = np.where(keep_seg, np.arange(n_ev), n_ev)
    nk = np.minimum.accumulate(nk[::-1])[::-1]
    kept_sub = nk[np.maximum(ov["i0"], 0)] <= ov["i1"]
    return kept_sub.reshape(-1, ov["R"]).any(axis=1)


NQ_RUNGS = (4, 8, 16, 32, 64)


def _rung(n: int) -> int:
    for r in NQ_RUNGS:
        if n <= r:
            return r
    return -(-n // NQ_RUNGS[-1]) * NQ_RUNGS[-1]


def job_table(ov: dict, kept: np.ndarray,
              q_rows: Optional[np.ndarray] = None) -> dict:
    """Job table for ``blockmax_retrieve_dma`` from the kept entries,
    packed into one [4, nq, J] int32 array (src / window-local lo / hi /
    qw bits; J on the ``bucket_jobs`` grid), so a pass uploads once.

    ``q_rows`` (optional) maps original query index -> compact output row
    (-1 = excluded): pass 2 dispatches only the uncertified queries,
    padded to the next NQ_RUNGS rung. Entries of excluded queries must
    already be dropped from ``kept``."""
    if q_rows is None:
        nq = ov["nq"]
        kq = ov["e_q"][kept]
    else:
        nq = _rung(int((q_rows >= 0).sum()))
        kq = q_rows[ov["e_q"][kept]]
        if not (kq >= 0).all():
            raise ValueError("kept entry of an excluded query")
    cnt = np.bincount(kq, minlength=nq)
    J = bucket_jobs(int(cnt.max(initial=1)))
    slot_base = np.zeros(nq + 1, np.int64)
    np.cumsum(cnt, out=slot_base[1:])
    slot = np.arange(len(kq)) - slot_base[kq]
    packed = np.zeros((4, nq, J), np.int32)
    packed[0, kq, slot] = ov["src"][kept].astype(np.int32)
    packed[1, kq, slot] = ov["lo_loc"][kept]
    packed[2, kq, slot] = ov["hi_loc"][kept]
    packed[3, kq, slot] = ov["e_w"][kept].astype(np.float32).view(np.int32)
    return {"packed": packed, "jobs_per_query": J,
            "dropped_any": np.bincount(ov["e_q"][~kept],
                                       minlength=ov["nq"]) > 0}


# ---------------------------------------------------------------------------
# device: fetch a host-built job table, score, rank


def fetch_inputs(packed: torch.Tensor, nnz: int):
    """[4, nq, J] int32 job table → the fused fetch's inputs (src int64
    clamped into the flat arrays, jv_start, jv_end int32 positions in the
    query's output row, j_qv f32), each [nq*J]. An entry with qw <= 0 gets
    an empty interval: the reference's valid mask also requires qw > 0."""
    _, nq, J = packed.shape
    max_src = ((nnz - CHUNK) // ALIGN) * ALIGN
    src = packed[0].reshape(-1).long().clamp(0, max_src)
    qw = packed[3].reshape(-1).view(torch.float32)
    base = (torch.arange(J, device=packed.device, dtype=torch.int32)
            * CHUNK).repeat(nq)
    jv_start = base + packed[1].reshape(-1)
    jv_end = torch.where(qw > 0, base + packed[2].reshape(-1), jv_start)
    return (src.contiguous(), jv_start.contiguous(), jv_end.contiguous(),
            qw.contiguous())


def _blockmax_async(rows_flat, valbits_flat, packed, k: int, n_docs: int,
                    max_run: int, ops: Ops):
    """Dispatch one pass with no device->host read: (scores, rows,
    fallback) as ``_rank_tail_async`` returns them."""
    _, nq, J = packed.shape
    src, jvs, jve, jqv = fetch_inputs(packed, rows_flat.shape[0])
    rows, contrib = ops.fetch_bmx(rows_flat, valbits_flat, src, jvs, jve,
                                  jqv, J, n_docs)
    return _rank_tail_async(rows.view(nq, -1), contrib.view(nq, -1), n_docs,
                            k, max_run, ops)


def blockmax_retrieve_dma(rows_flat, valbits_flat, packed, k: int,
                          jobs_per_query: int, n_docs: int, max_run: int,
                          ops: Ops = KERNELS) -> torch.Tensor:
    """B1 over a host-built job table (``packed`` [4, nq, J] int32 on the
    device: ALIGN-aligned flat sources / window-local valid lo / hi /
    query-weight bits), then the rank tail. Returns one packed [nq, 2k]
    int32 buffer: score bits | rows."""
    if packed.shape[2] != jobs_per_query:
        raise ValueError(f"job table has {packed.shape[2]} jobs per query, "
                         f"not {jobs_per_query}")
    s, r = _finish(*_blockmax_async(rows_flat, valbits_flat, packed, k,
                                    n_docs, max_run, ops), k)
    return _pack_score_rows(s, r, 2 * k)


def _read_pass(payload) -> tuple[np.ndarray, np.ndarray]:
    """Resolve a pass's certificate and read it back in one copy."""
    (scores, rows, fallback), k = payload
    scores, rows = _finish(scores, rows, fallback, k)
    buf = _pack_score_rows(scores, rows, 2 * k).cpu().numpy()
    return buf[:, :k].copy().view(np.float32), buf[:, k:]


# ---------------------------------------------------------------------------
# engine


class BlockMaxSegsortEngine(SegsortEngine):
    """Two-pass block-max pruned segsort. Speaks the base engine's
    async/finalize protocol, plus ``continue_async`` for pipelined drivers
    (``staged_pipeline``, ``RetrievalServer``'s advance step).

    ``cover`` sizes pass 1 (the top-UB regions covering cover*k docs; its
    exact k-th score seeds pass 2's threshold). ``gate`` bounds hostile
    corpora: a pass whose kept window fraction exceeds it runs through the
    unpruned base path instead. ``meta`` takes precomputed
    ``build_chunk_meta`` output; an engine over ``device_csr`` needs it,
    since the host never holds those posting arrays. f32 layout only."""

    def __init__(self, index, topk: int = 1000, query_terms_budget: int = 64,
                 cover: float = 4.0, gate: float = 0.85,
                 meta: Optional[dict] = None, **kw):
        if kw.get("val_dtype", "f32") != "f32":
            raise ValueError("the block-max engine reads the f32 layout "
                             "(CHUNK-geometry meta, fetch B1)")
        if meta is None and kw.get("device_csr") is not None:
            raise ValueError("device_csr construction requires precomputed "
                             "meta= (the host never holds the posting "
                             "arrays)")
        if meta is None and not check_doc_sorted(index.offsets,
                                                 index.doc_rows):
            raise ValueError("block-max pruning needs doc-sorted posting "
                             "lists (run a doc reorder / sort lists first)")
        super().__init__(index, topk=topk,
                         query_terms_budget=query_terms_budget, **kw)
        if meta is None:
            meta = build_chunk_meta(index.offsets, index.doc_rows,
                                    index.values)
        self.meta = meta
        self.cover = cover
        self.gate = gate
        self.n_gated_tiles = 0        # pass 1 or 2 exceeded the gate
        self.n_pass1_final = 0        # pass 1 certified itself (whole tile)
        self.n_pass2_tiles = 0
        self.kept_frac_sum = 0.0      # pass-2 (or final) kept fraction
        self.kept1_frac_sum = 0.0     # pass-1 kept fraction
        self.n_pruned_tiles = 0
        self.n_q_total = 0            # per-query certification accounting
        self.n_q_certified = 0        # done after pass 1
        self.n_q_pass2 = 0            # re-dispatched in a compacted pass 2
        self.host_ms = {"overlay": 0.0, "tau": 0.0, "keep": 0.0,
                        "job_table": 0.0}

    def _timed(self, key: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.host_ms[key] += (time.perf_counter() - t0) * 1e3
        return out

    def _dispatch_jobs(self, plan: dict, T: int, k: int):
        packed = torch.from_numpy(plan["packed"]).to(self.device)
        return (_blockmax_async(self.rows_flat, self.valbits_flat, packed, k,
                                self.n_docs, T, self.ops), k)

    def _base(self, topk, sparsified):
        return ("base", super().retrieve_tile_async(None, topk,
                                                    sparsified=sparsified))

    def retrieve_tile_async(self, q_dense, topk=None, sparsified=None):
        """Build pass 1 on the host and dispatch it, with no device->host
        read. Returns a payload for ``continue_async``/``finalize``."""
        topk = topk or self.topk
        q_terms, q_vals = (sparsified if sparsified is not None
                           else self.sparsify_queries(q_dense))
        k = min(topk, self.n_docs)
        ov = self._timed("overlay", build_overlay, self.meta,
                         self._host_offsets, q_terms, q_vals, self.n_docs)
        if ov is None:
            return self._base(topk, (q_terms, q_vals))
        tau1 = self._timed("tau", cover_tau, ov, max(1.0, self.cover * k))
        kept1 = self._timed("keep", keep_entries, ov, tau1)
        if kept1.mean() > self.gate:
            self.n_gated_tiles += 1
            return self._base(topk, (q_terms, q_vals))
        self.kept1_frac_sum += float(kept1.mean())
        plan1 = self._timed("job_table", job_table, ov, kept1)
        p1 = self._dispatch_jobs(plan1, q_terms.shape[1], k)
        # pass 2 is built once pass 1's k-th scores are known
        return ("bmx", p1, tau1, plan1["dropped_any"], ov,
                (q_terms, q_vals), topk)

    def continue_async(self, payload):
        """Stage boundary for pipelined drivers: read pass 1 (resolving its
        certificate) and dispatch pass 2 without reading it, so pass 2
        overlaps the next tiles' pass 1. ``finalize`` also takes the raw
        ``retrieve_tile_async`` payload and then runs both stages back to
        back. Idempotent on advanced payloads."""
        if payload[0] != "bmx":
            return payload
        _, p1, tau1, dropped1, ov, sparsified, topk = payload
        s1, r1 = _read_pass(p1)
        k = s1.shape[1]
        tau_hat1 = s1[:, k - 1]
        # pass 1 exhaustive above tau1: every dropped segment's UB < tau1
        # <= tau_hat1 means nothing dropped can reach the top-k
        done = (~dropped1) | (tau_hat1 >= tau1)
        self.n_pruned_tiles += 1
        self.n_q_total += len(done)
        self.n_q_certified += int(done.sum())
        if done.all():
            self.n_pass1_final += 1
            return ("p1done", s1, r1)
        # pass 2: only the uncertified queries (compacted to an NQ_RUNGS
        # row count), keeping everything with UB >= their pass-1 k-th (a
        # superset of their pass-1 kept set). A -inf k-th (under-filled
        # pass 1) keeps everything; +inf for certified queries nothing.
        tau2 = np.minimum(tau_hat1, tau1)
        tau2 = np.where(np.isfinite(tau2), tau2, 0.0)
        tau2_f = np.where(done, np.inf, tau2).astype(np.float32)
        kept2 = self._timed("keep", keep_entries, ov, tau2_f)
        notdone_entries = int((~done)[ov["e_q"]].sum())
        if kept2.sum() > self.gate * max(notdone_entries, 1):
            # gated tiles fetch everything through the base path: count
            # them at 1.0 so mean_kept_frac reflects fetched work
            self.kept_frac_sum += 1.0
            self.n_gated_tiles += 1
            return self._base(topk, sparsified)
        # fetched-work fraction of the full tile's windows (certified
        # queries fetch nothing in pass 2)
        self.kept_frac_sum += float(kept2.mean())
        self.n_pass2_tiles += 1
        self.n_q_pass2 += int((~done).sum())
        nd_idx = np.flatnonzero(~done)
        q_rows = np.full(len(done), -1, np.int64)
        q_rows[nd_idx] = np.arange(len(nd_idx))
        plan2 = self._timed("job_table", job_table, ov, kept2, q_rows)
        p2 = self._dispatch_jobs(plan2, sparsified[0].shape[1], k)
        return ("p2", p2, s1, r1, nd_idx)

    def finalize(self, payload):
        payload = self.continue_async(payload)
        if payload[0] == "base":
            return super().finalize(payload[1])
        if payload[0] == "p1done":
            return payload[1], payload[2]
        _, p2, s1, r1, nd_idx = payload
        # strip rung padding, scatter the compact rows back
        s2, r2 = _read_pass(p2)
        s_out, r_out = s1.copy(), r1.copy()
        s_out[nd_idx] = s2[:len(nd_idx)]
        r_out[nd_idx] = r2[:len(nd_idx)]
        return s_out, r_out

    def stats(self) -> dict:
        return {"pruned_tiles": self.n_pruned_tiles,
                "gated_tiles": self.n_gated_tiles,
                "pass1_final_tiles": self.n_pass1_final,
                "pass2_tiles": self.n_pass2_tiles,
                "n_q_total": self.n_q_total,
                "n_q_certified": self.n_q_certified,
                "n_q_pass2": self.n_q_pass2,
                "mean_kept1_frac": round(
                    self.kept1_frac_sum / max(1, self.n_pruned_tiles), 4),
                "mean_kept_frac": round(
                    self.kept_frac_sum / max(1, self.n_pruned_tiles), 4),
                "host_ms": {k_: round(v, 1)
                            for k_, v in self.host_ms.items()}}
