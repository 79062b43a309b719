"""Sort-based inverted-index scoring, the "segsort" engine (port of
ops/segsort_scoring.py).

Work is proportional to the postings a query tile matches. Per tile:
  1. query terms are ordered by term id (monotone fetch addresses);
  2. posting fetch: each (query, term) slice is one contiguous CSR range,
     copied by fixed-size jobs (ops/fetch.py, kernels B1/B2/B3 for the
     f32, q8 and bf16-pair layouts) with the valid mask, sentinel row and
     query weight fused in;
  3. per-query sort of (doc row, contribution) by doc row;
  4. segmented sum + run-end mask (ops/segsum.py, kernel B4): each doc's
     score at the end of its run, -inf elsewhere;
  5. per-block top-m (ops/topm.py, kernel B5), merged with ``torch.topk``
     and certified exact; a tile whose certificate fails takes the full
     ``torch.topk`` over the slab instead.

Results equal brute force whenever T covers all query nonzeros and the job
table covers every matched posting (the engine sizes it from host offsets).

The reference picks between the blocked merge and the full top-k with an
on-device ``lax.cond``. Eager PyTorch would need a device->host read for
that branch, which would serialize dispatch behind the device, so the
asynchronous entry points return the certificate with the result and the
full top-k runs at finalize time, only for a tile whose certificate
failed (the slab stays alive until then).

``ops`` selects the kernels (``KERNELS``, the default) or their plain
PyTorch versions (``PLAIN``) for the functions that take it; the plain path
exists to hold the kernels against on the card. On CPU tensors the kernel
wrappers take the plain versions themselves.

``ShardedSegsortEngine`` runs one engine per doc-range shard of the index
over a list of devices (one card may hold several shards) and merges the
shards' top-k on the host.
"""

from __future__ import annotations

import functools
import sys
import threading
from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.ops.fetch import (
    CHUNK, CHUNK2, Q8_ROW_LIMIT, fetch_jobs, fetch_jobs_bf16,
    fetch_jobs_bf16_plain, fetch_jobs_plain, fetch_jobs_q8,
    fetch_jobs_q8_plain, fetch_postings_dma, fetch_postings_dma_bf16,
    fetch_postings_dma_q8,
)
from scaling_retriever_tpu_torch.ops.segsum import (
    _run_end_mask, _segsum_passes, eligible, segsum_mask, segsum_mask_plain,
)
from scaling_retriever_tpu_torch.ops.topm import block_topm, block_topm_plain
from scaling_retriever_tpu_torch.parallel.mesh import local_devices
from scaling_retriever_tpu_torch.utils.profiling import profile_span
from scaling_retriever_tpu_torch.utils.utils import force_materialized

# fetch_bmx is B1 at its block-max call site (ops/blockmax.py): the same
# kernel, counted under a launch key of its own
Ops = namedtuple("Ops", "fetch fetch_q8 fetch_bf16 fetch_bmx segsum topm")
KERNELS = Ops(fetch_jobs, fetch_jobs_q8, fetch_jobs_bf16,
              functools.partial(fetch_jobs, site="fetch_f32_blockmax"),
              segsum_mask, block_topm)
PLAIN = Ops(fetch_jobs_plain, fetch_jobs_q8_plain, fetch_jobs_bf16_plain,
            fetch_jobs_plain, segsum_mask_plain, block_topm_plain)


def bucket_jobs(need: int) -> int:
    """Round a per-tile DMA job need up to the {2^k, 1.5*2^k} grid (at
    least 64): bounded sort-input inflation (<= 1.33x) with about two
    distinct tile shapes per octave."""
    b = max(64, 1 << int(np.ceil(np.log2(max(need, 1)))))
    b75 = (b // 4) * 3
    return b75 if b75 >= max(need, 64) else b


def sparsify_reps(q_dense: np.ndarray, T: int = 64
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Dense reps [nq, V] → (terms int32, vals f32) [nq, T], values
    descending, weight 0 ⇒ unused slot. T widens to the max row nnz
    (multiple of 8), so the result is exact, never a truncation."""
    nq, V = q_dense.shape
    r, c = np.nonzero(q_dense > 0)
    per = np.bincount(r, minlength=nq)
    mx = int(per.max(initial=0))
    if mx > T:
        T = -(-mx // 8) * 8
    idx = np.zeros((nq, T), np.int64)
    vals = np.zeros((nq, T), np.float32)
    starts = np.zeros(nq + 1, np.int64)
    np.cumsum(per, out=starts[1:])
    slot = np.arange(len(r)) - starts[r]
    idx[r, slot] = c
    vals[r, slot] = q_dense[r, c]
    order = np.argsort(-vals, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    idx = np.where(vals > 0, idx, 0)
    return idx.astype(np.int32), vals


def pack_postings(offsets: np.ndarray, doc_rows: np.ndarray,
                  values: np.ndarray) -> np.ndarray:
    """CSR postings → the gather path's packed int32 matrix [nnz, 2]:
    column 0 the doc row, column 1 the f32 value bits."""
    nnz = doc_rows.shape[0]
    packed = np.zeros((nnz, 2), np.int32)
    packed[:, 0] = doc_rows.astype(np.int32)
    packed[:, 1] = values.astype(np.float32).view(np.int32)
    return packed


def _q8_scales(offsets: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Per-term q8 dequant scale, max_val / 255 (1.0 for empty terms)."""
    lens = np.diff(offsets).astype(np.int64)
    vmax = np.ones(len(lens), np.float32)
    nz = lens > 0
    if nz.any():
        vmax[nz] = np.maximum.reduceat(values, offsets[:-1][nz])
    return np.where(nz & (vmax > 0), vmax / 255.0, 1.0).astype(np.float32)


def sparsify_reps_device(q_dense: torch.Tensor, T: int = 64
                         ) -> tuple[np.ndarray, np.ndarray]:
    """``sparsify_reps`` of a [nq, V] tensor, computed where it lives (a
    stable descending sort per row) and read back as the same numpy
    (terms, vals) [nq, T'] arrays: values descending, ties in term order,
    T' widened to the max row nnz (multiple of 8) beyond T."""
    nq, V = q_dense.shape
    pos = q_dense > 0
    mx = int(pos.sum(dim=1).max()) if nq else 0
    if mx > T:
        T = -(-mx // 8) * 8
    w = torch.where(pos, q_dense.float(), 0.0)
    vals, idx = torch.sort(w, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :T], idx[:, :T]
    idx = torch.where(vals > 0, idx, 0)
    if T > V:
        vals = torch.nn.functional.pad(vals, (0, T - V))
        idx = torch.nn.functional.pad(idx, (0, T - V))
    return (idx.to(torch.int32).cpu().numpy(),
            vals.cpu().numpy().astype(np.float32, copy=False))


def pack_postings_q8(offsets: np.ndarray, doc_rows: np.ndarray,
                     values: np.ndarray, n_docs: int, pad_to: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """CSR → the q8 single-word layout: one int32 word per posting,
    ``(row24 << 8) | code8`` with ``code = clip(round(val / scale), 1, 255)``
    and per-term ``scale = max_val / 255`` (empty terms: 1.0). Returns
    (packed int32 [>= pad_to], scales f32 [V]); pad words hold the n_docs
    sentinel row and code 0. Callers fold ``scales[q_terms]`` into the
    query weights."""
    if n_docs >= Q8_ROW_LIMIT:
        raise ValueError(f"q8 rows are 24-bit: n_docs {n_docs} >= "
                         f"{Q8_ROW_LIMIT}; shard the corpus")
    offsets = np.asarray(offsets)
    rows = np.asarray(doc_rows, np.uint32)
    vals = np.asarray(values, np.float32)
    lens = np.diff(offsets).astype(np.int64)
    scales = _q8_scales(offsets, vals)
    per_post = np.repeat(scales, lens)
    codes = np.clip(np.rint(vals / per_post), 1, 255).astype(np.uint32)
    n = max(int(pad_to), len(rows))
    packed = np.full(n, np.uint32(n_docs) << np.uint32(8), np.uint32)
    packed[:len(rows)] = (rows << np.uint32(8)) | codes
    return packed.view(np.int32), scales


def pack_values_bf16(values: np.ndarray, pad_to: int) -> np.ndarray:
    """f32 values → bf16 pairs in int32 words (round to nearest even),
    padded with zeros so ``2 * len(out) >= pad_to``. Value 2i is the low
    half of word i: the uint16 halves are viewed as int32 on a
    little-endian host, the order the fetch kernel unpacks."""
    if sys.byteorder != "little":
        raise RuntimeError("pack_values_bf16 assumes a little-endian host")
    values = np.asarray(values, np.float32)
    n = max(int(pad_to), len(values) + (len(values) & 1))
    n += n & 1
    v16 = np.zeros(n, np.uint16)
    v16[:len(values)] = torch.from_numpy(values).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)
    return v16.view(np.int32)


def _segmented_sum_scan(vals: torch.Tensor,
                        starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum of a 1-D array, restarting where ``starts``
    is true: the reference's associative scan of (value, flag) pairs, as
    Hillis-Steele doubling passes over the same operator. Kept as the
    reference's API (its tests hold it there); the engines sum through
    ``ops/segsum.py``."""
    v = vals
    f = starts.to(vals.dtype)
    n = v.shape[0]
    shift = 1
    while shift < n:
        pv = torch.cat([v.new_zeros(shift), v[:-shift]])
        pf = torch.cat([f.new_zeros(shift), f[:-shift]])
        v, f = v + (1.0 - f) * pv, torch.maximum(f, pf)
        shift *= 2
    return v


def _segmented_sum_bounded(vals: torch.Tensor, keys: torch.Tensor,
                           max_run: int) -> torch.Tensor:
    """Inclusive segmented sum of a 1-D array sorted by ``keys``, for runs
    of at most ``max_run`` equal keys: ceil(log2(max_run)) doubling
    passes. Kept as the reference's API, like ``_segmented_sum_scan``."""
    return _segsum_passes(vals[None], keys[None], 1, max_run)[0]


def segsort_retrieve(packed: torch.Tensor, offsets: torch.Tensor,
                     q_terms: torch.Tensor, q_vals: torch.Tensor, k: int,
                     p_budget: int, n_docs: int, ops: Ops = KERNELS):
    """The gather path: packed [nnz, 2] int32 postings (row, value bits),
    offsets [V+1] int64, q_terms/q_vals [nq, T] (weight 0 ⇒ unused slot),
    all on one device. Each query's matched postings are laid out in
    term order over ``p_budget`` slots (slot -> (term, offset) by one
    ``searchsorted`` over the cumulative list lengths, where the reference
    scans T steps) and fetched with one row gather; the rank tail is the
    DMA path's (``_rank_tail``, B4 and B5 under ``ops``). Returns (scores
    [nq, k], rows [nq, k], matched [nq])."""
    nq, T = q_terms.shape
    q_terms, q_vals = _sort_query_terms(q_terms, q_vals)
    qt = q_terms.long()
    lens = (offsets[qt + 1] - offsets[qt]) * (q_vals > 0)
    cum = torch.cumsum(lens, dim=1)
    total = cum[:, -1]
    pos = torch.arange(p_budget, device=qt.device).expand(nq, p_budget)
    slot = torch.searchsorted(cum.contiguous(), pos.contiguous(),
                              right=True).clamp_max(T - 1)
    valid = pos < total[:, None]
    flat_idx = offsets[qt].gather(1, slot) + pos - (cum - lens).gather(1, slot)
    flat_idx = torch.where(valid, flat_idx, 0)
    qw = q_vals.gather(1, slot)
    fetched = packed[flat_idx.reshape(-1)]
    rows = fetched[:, 0].view(nq, p_budget)
    vals = fetched[:, 1].contiguous().view(torch.float32).view(nq, p_budget)
    contrib = torch.where(valid, vals * qw, 0.0)
    rows = torch.where(valid, rows, n_docs)
    scores, top_rows = _rank_tail(rows, contrib, n_docs, k, T, ops)
    return scores, top_rows, total


def _blocked_certificate(bv: torch.Tensor, v: torch.Tensor, m: int,
                         k: int) -> torch.Tensor:
    """Row q is exact when every block either had its m-th kept value
    strictly below the merged k-th (nothing it dropped can be in the top-k)
    or kept all its finite candidates (m-th kept value is -inf)."""
    tau = v[:, k - 1]
    bm = bv[:, :, m - 1]
    return ((bm < tau[:, None]) | ~torch.isfinite(bm)).all(dim=1)


def _rank_tail_async(rows: torch.Tensor, contrib: torch.Tensor,
                     sentinel: int, k: int, max_run: int, ops: Ops = KERNELS,
                     sel_block: int = 4096, sel_m: int = 32):
    """(rows, contrib) [nq, P] → (scores [nq, k], rows [nq, k], fallback)
    with no device->host read. ``fallback`` is None when the result is
    final, else ``(row_ok, score, srow)`` for ``_finish``."""
    nq, P = rows.shape
    srow, perm = torch.sort(rows, dim=1)
    scontrib = contrib.gather(1, perm)
    if eligible(P, max_run):
        score = ops.segsum(srow, scontrib, sentinel, max_run)
    else:
        score = _run_end_mask(_segsum_passes(scontrib, srow, 1, max_run),
                              srow, sentinel)
    # select the top-m of every sel_block slots, merge, and certify; m is
    # the smallest value whose certificate holds for hash-like doc ids
    B = P // sel_block if P % sel_block == 0 else 0
    m = max(sel_m, -(-k // max(B, 1)))
    if B >= 4 and m <= sel_block and B * m >= k:
        if m <= 128:
            bv, bi = ops.topm(score, m, sel_block)
        else:
            bv, bi = torch.topk(score.view(nq, B, sel_block), m)
        base = (torch.arange(B, device=score.device) * sel_block)[None, :, None]
        gi = (bi.long() + base).reshape(nq, B * m)
        v, sel = torch.topk(bv.reshape(nq, B * m), k)
        top_rows = srow.gather(1, gi.gather(1, sel))
        ok = _blocked_certificate(bv, v, m, k)
        return v, top_rows, (ok, score, srow)
    top_scores, top_idx = torch.topk(score, k)
    return top_scores, srow.gather(1, top_idx), None


def _certified(fallback) -> bool:
    """Whether a ``_rank_tail_async`` result stands as merged: one small
    device->host read of the blocked certificate, where there is one."""
    if fallback is None:
        return True
    with profile_span("engine.certify"):
        return bool(fallback[0].all())


def _full_topk(fallback, k: int):
    """The full top-k over the slab, for a tile whose certificate failed."""
    _, score, srow = fallback
    with profile_span("engine.fallback"):
        scores, idx = torch.topk(score, k)
        return scores, srow.gather(1, idx)


def _finish(scores, rows, fallback, k: int):
    """Resolve a ``_rank_tail_async`` result: the full top-k over the slab
    where the blocked certificate failed."""
    if not _certified(fallback):
        scores, rows = _full_topk(fallback, k)
    return scores, rows


def _rank_tail(rows, contrib, sentinel: int, k: int, max_run: int,
               ops: Ops = KERNELS):
    """(rows, contrib) [nq, P] → (scores, rows) [nq, k], exact."""
    return _finish(*_rank_tail_async(rows, contrib, sentinel, k, max_run,
                                     ops), k)


def _sort_query_terms(q_terms: torch.Tensor, q_vals: torch.Tensor):
    q_terms, order = torch.sort(q_terms, dim=1, stable=True)
    return q_terms, q_vals.gather(1, order)


def _fetch_layout(layout: str, flat, valbits_flat, q_terms, offsets, q_vals,
                  jobs_per_query: int, n_docs: int, ops: Ops):
    if layout == "q8":
        return fetch_postings_dma_q8(flat, q_terms, offsets, q_vals,
                                     jobs_per_query, n_docs,
                                     fetch=ops.fetch_q8)
    if layout == "bf16":
        return fetch_postings_dma_bf16(flat, valbits_flat, q_terms, offsets,
                                       q_vals, jobs_per_query, n_docs,
                                       fetch=ops.fetch_bf16)
    return fetch_postings_dma(flat, valbits_flat, q_terms, offsets, q_vals,
                              jobs_per_query, n_docs, fetch=ops.fetch)


def _retrieve_async(layout: str, flat, valbits_flat, offsets, q_terms,
                    q_vals, k: int, jobs_per_query: int, n_docs: int,
                    ops: Ops):
    """Shared dispatch of the three layouts: "f32" (``flat`` rows,
    ``valbits_flat`` value bits), "bf16" (``valbits_flat`` the packed
    pairs) and "q8" (``flat`` the packed word stream, ``valbits_flat``
    None, ``q_vals`` scale-folded). Returns (scores, rows, fallback, total,
    q_terms, q_vals) with the query terms sorted."""
    T = q_terms.shape[1]
    q_terms, q_vals = _sort_query_terms(q_terms, q_vals)
    rows, contrib, total = _fetch_layout(layout, flat, valbits_flat, q_terms,
                                         offsets, q_vals, jobs_per_query,
                                         n_docs, ops)
    scores, top_rows, fallback = _rank_tail_async(rows, contrib, n_docs, k, T,
                                                  ops)
    return scores, top_rows, fallback, total, q_terms, q_vals


def segsort_retrieve_dma(rows_flat, valbits_flat, offsets, q_terms, q_vals,
                         k: int, jobs_per_query: int, n_docs: int,
                         ops: Ops = KERNELS):
    """rows_flat/valbits_flat [nnz + CHUNK] int32 (value bits), offsets
    [V+1] int64, q_terms/q_vals [nq, T] (weight 0 ⇒ unused slot), all on
    one device. Returns (scores [nq, k], rows [nq, k], total [nq])."""
    s, r, fb, total, _, _ = _retrieve_async(
        "f32", rows_flat, valbits_flat, offsets, q_terms, q_vals, k,
        jobs_per_query, n_docs, ops)
    s, r = _finish(s, r, fb, k)
    return s, r, total


def segsort_retrieve_dma_bf16(rows_flat, valpacked_flat, offsets, q_terms,
                              q_vals, k: int, jobs_per_query: int,
                              n_docs: int, ops: Ops = KERNELS):
    """segsort over the bf16-pair layout (rows [nnz + CHUNK2] int32, two
    bf16 values per int32 word, CHUNK2-posting jobs): exact over the
    bf16-rounded index, and equal to the f32 engine wherever the stored
    values are bf16-representable."""
    s, r, fb, total, _, _ = _retrieve_async(
        "bf16", rows_flat, valpacked_flat, offsets, q_terms, q_vals, k,
        jobs_per_query, n_docs, ops)
    s, r = _finish(s, r, fb, k)
    return s, r, total


def segsort_retrieve_dma_q8(packed_flat, offsets, q_terms, q_vals, k: int,
                            jobs_per_query: int, n_docs: int,
                            ops: Ops = KERNELS):
    """segsort over the q8 word layout; ``q_vals`` must arrive scale-folded
    (qw * scale[term]), so scores are exact over the stored codes."""
    s, r, fb, total, _, _ = _retrieve_async(
        "q8", packed_flat, None, offsets, q_terms, q_vals, k, jobs_per_query,
        n_docs, ops)
    s, r = _finish(s, r, fb, k)
    return s, r, total


def _job_need(offsets, q_terms, q_vals) -> torch.Tensor:
    """Per-query DMA job count [nq] on device (host ``job_need``'s twin for
    the CHUNK layouts, the only ones the device handoff rides)."""
    qt = q_terms.long()
    lens = (offsets[qt + 1] - offsets[qt]) * (q_vals > 0)
    head = offsets[qt] % CHUNK
    return torch.where(lens > 0, -(-(head + lens) // CHUNK), 0).sum(dim=1)


def _packed_handoff_tail(flat, valbits_flat, offsets, q_terms, q_vals,
                         k: int, jobs_per_query: int, n_docs: int, ops: Ops):
    """Shared tail of the two device-handoff programs (f32 and q8): fetch,
    rank tail, on-device job need, and the packed (score bits | rows |
    need) [nq, 2k+1] int32 result. Returns (buf, fallback)."""
    s, r, fb, _, q_terms, q_vals = _retrieve_async(
        "f32" if valbits_flat is not None else "q8", flat, valbits_flat,
        offsets, q_terms, q_vals, k, jobs_per_query, n_docs, ops)
    need = _job_need(offsets, q_terms, q_vals)
    buf = torch.cat([s.view(torch.int32), r.to(torch.int32),
                     need[:, None].to(torch.int32)], dim=1)
    return buf, fb


def _resolve_handoff(buf: torch.Tensor, k: int, fallback) -> tuple:
    """(the packed buffer with the full top-k where the certificate
    failed, whether it held)."""
    if _certified(fallback):
        return buf, True
    s, r = _full_topk(fallback, k)
    buf = buf.clone()
    buf[:, :k] = s.view(torch.int32)
    buf[:, k:2 * k] = r
    return buf, False


def segsort_retrieve_dma_packed(rows_flat, valbits_flat, offsets, q_terms,
                                q_vals, k: int, jobs_per_query: int,
                                n_docs: int, ops: Ops = KERNELS):
    """Device-handoff variant of ``segsort_retrieve_dma`` for query tiles
    that live on the device (the encoder's top-T output): a standing job
    bucket chosen by the caller, and ONE packed int32 [nq, 2k+1] result
    (score bits | rows | true job need). Rows whose need exceeds the bucket
    were truncated; the caller re-routes them."""
    buf, fb = _packed_handoff_tail(rows_flat, valbits_flat, offsets, q_terms,
                                   q_vals, k, jobs_per_query, n_docs, ops)
    return _resolve_handoff(buf, k, fb)[0]


def segsort_retrieve_dma_packed_q8(packed_flat, scales_dev, offsets,
                                   q_terms, q_vals, k: int,
                                   jobs_per_query: int, n_docs: int,
                                   ops: Ops = KERNELS):
    """q8 twin of ``segsort_retrieve_dma_packed``: the per-term dequant
    scales ([V] f32 on device) fold into the weights on device."""
    q_vals = q_vals * scales_dev[q_terms.long()]
    buf, fb = _packed_handoff_tail(packed_flat, None, offsets, q_terms,
                                   q_vals, k, jobs_per_query, n_docs, ops)
    return _resolve_handoff(buf, k, fb)[0]


def _pack_score_rows(scores: torch.Tensor, rows: torch.Tensor,
                     cols: int) -> torch.Tensor:
    """(scores f32 [nq, k], rows [nq, k]) → one int32 [nq, cols] buffer
    (score bits | rows | zero pad), read back in one copy."""
    buf = torch.cat([scores.view(torch.int32), rows.to(torch.int32)], dim=1)
    if cols > buf.shape[1]:
        buf = torch.nn.functional.pad(buf, (0, cols - buf.shape[1]))
    return buf


UPLOAD_CHUNK = 1 << 27      # postings per host->device step of the layouts


def _chunks(n: int, step: int = UPLOAD_CHUNK):
    return ((s, min(s + step, n)) for s in range(0, n, step))


def _upload_dma(index, n_docs: int, pad: int, val_dtype: str, dev):
    """The f32 or bf16-pair DMA layout of a host index on ``dev``: rows
    int32 [nnz + pad] (the n_docs sentinel past nnz) and the value words
    (f32 bits [nnz + pad], or ``pack_values_bf16``'s pairs of the same
    length, rounded to bf16 by torch on the device)."""
    nnz = index.nnz
    rows = torch.full((nnz + pad,), n_docs, dtype=torch.int32, device=dev)
    rows[:nnz].copy_(torch.from_numpy(index.doc_rows))
    if val_dtype == "bf16":
        n = max(nnz + pad, nnz + (nnz & 1))
        n += n & 1
        half = torch.zeros(n, dtype=torch.bfloat16, device=dev)
        for s, e in _chunks(nnz):
            half[s:e].copy_(torch.from_numpy(index.values[s:e]).to(dev))
        return rows, half.view(torch.int32)
    vals = torch.zeros(nnz + pad, dtype=torch.int32, device=dev)
    vals[:nnz].copy_(torch.from_numpy(index.values.view(np.int32)))
    return rows, vals


def _upload_q8(index, n_docs: int, pad_to: int, dev):
    """``pack_postings_q8`` of a host index, computed on ``dev`` (the
    per-term scales on the host): (packed int32 [>= pad_to], scales)."""
    nnz = index.nnz
    scales = _q8_scales(index.offsets, index.values)
    pad_word = (n_docs << 8) - ((1 << 32) if n_docs << 8 >= 1 << 31 else 0)
    packed = torch.full((max(pad_to, nnz),), pad_word, dtype=torch.int32,
                        device=dev)
    offsets = torch.from_numpy(index.offsets).to(dev)
    scales_dev = torch.from_numpy(scales).to(dev)
    for s, e in _chunks(nnz):
        pos = torch.arange(s, e, device=dev)
        term = torch.searchsorted(offsets, pos, right=True) - 1
        v = torch.from_numpy(index.values[s:e]).to(dev)
        codes = torch.clamp(torch.round(v / scales_dev[term]), 1, 255).long()
        w = (torch.from_numpy(index.doc_rows[s:e]).to(dev).long() << 8) | codes
        packed[s:e] = torch.where(w >= 1 << 31, w - (1 << 32), w).to(
            torch.int32)
    return packed, scales


def _upload_packed(index, dev) -> torch.Tensor:
    """``pack_postings`` of a host index on ``dev``: [nnz, 2] int32."""
    packed = torch.empty((index.nnz, 2), dtype=torch.int32, device=dev)
    for s, e in _chunks(index.nnz):
        packed[s:e, 0] = torch.from_numpy(index.doc_rows[s:e]).to(dev)
        packed[s:e, 1] = torch.from_numpy(
            index.values[s:e].view(np.int32)).to(dev)
    return packed


class SegsortEngine:
    """Owns the flat CSR on the device and runs query tiles over it.

    ``val_dtype="f32"`` keeps rows int32 and value bits int32 (8 B per
    posting); ``"bf16"`` keeps rows int32 and two bf16 values per int32
    word (6 B per posting, CHUNK2-posting jobs; scores are exact over the
    bf16-rounded values); ``"q8"`` keeps one ``(row24 << 8) | code8`` word
    per posting (4 B) and folds the per-term dequant scales into the query
    weights.

    ``device_csr=(rows_flat, valbits_flat, offsets, n_docs)`` builds the
    engine over flat arrays that already live on the device (padded by at
    least one job, CHUNK or CHUNK2 for bf16, past ``offsets[-1]`` with the
    n_docs sentinel; ``offsets`` a host [V+1] array); for bf16
    ``valbits_flat`` is the packed pair array (``pack_values_bf16``), for
    q8 pass ``(packed_flat, scales, offsets, n_docs)`` with the host [V]
    scales of ``pack_postings_q8``. ``index`` is then ignored.

    The parameters up to ``val_dtype`` are the reference's, in its order.
    ``packed_read`` and ``pack_pad_bytes`` are its too, but this engine's
    read has no such choice: a value other than the default raises.

    ``ops`` selects the kernels (default) or their plain versions for every
    tile this engine runs. ``sync_upload=False`` (or ``sync=False``, which
    wins where given) returns with the upload still queued (the
    ``sync_upload()`` method waits for it), so that several engines'
    uploads overlap.

    ``fetch`` picks the posting fetch: ``"dma"`` (the job-table fetch over
    the kernels above), ``"gather"`` (``segsort_retrieve``: one row gather
    from a packed [nnz, 2] matrix, budgeted in powers of two from
    ``min_budget``, then the DMA path's rank tail) or ``"auto"`` (dma on
    a CUDA device, gather on the CPU, as the reference picks by backend).
    bf16 and q8 exist only on the DMA path, so they force it. A host index is laid out on ``device``
    by torch ops there, bit-identical to ``pack_values_bf16`` and
    ``pack_postings_q8``.

    ``stats()`` counts what the reads saw: ``tiles``,
    ``cert_fallback_tiles`` (the full top-k ran), ``jobs_real`` (the jobs
    the tiles' real rows need, a truncated row's capped at the bucket) and
    ``jobs_slab`` (rows times jobs a query of each DMA tile, padded rows
    included), from numbers the host already holds. Each read's own are
    the attrs of its ``engine.copy_out`` span.
    """

    def __init__(self, index=None, topk: int = 1000,
                 query_terms_budget: int = 64, min_budget: int = 1 << 17,
                 fetch: str = "dma", sync_upload: bool = True,
                 device_csr=None, val_dtype: str = "f32",
                 packed_read: Optional[bool] = None,
                 pack_pad_bytes: int = 1 << 19, *, device="cuda",
                 ops: Ops = KERNELS, sync: Optional[bool] = None):
        if packed_read is not None or pack_pad_bytes != 1 << 19:
            raise ValueError("packed_read and pack_pad_bytes: this engine "
                             "reads scores and rows as they are; it has no "
                             "packed read to choose")
        if val_dtype not in ("f32", "bf16", "q8"):
            raise ValueError(f"val_dtype {val_dtype!r}: f32, bf16 or q8")
        if fetch not in ("auto", "dma", "gather"):
            raise ValueError(f"fetch {fetch!r}: auto, dma or gather")
        self.topk = topk
        self.T = query_terms_budget
        self.val_dtype = val_dtype
        self.ops = ops
        self.min_budget = min_budget
        self.fetch = "dma"
        self.packed = None
        # job granularity of the value layout (job_need, bucket sizing, pad)
        self._chunk = CHUNK2 if val_dtype == "bf16" else CHUNK
        self._host_scales = None
        self._scales_dev = None
        self._counts = dict.fromkeys(
            ("tiles", "cert_fallback_tiles", "jobs_real", "jobs_slab"), 0)
        self._counts_lock = threading.Lock()
        if device_csr is not None:
            flat, second, offsets, n_docs = device_csr
            self.device = flat.device
            self.n_docs = int(n_docs)
            host_offsets = np.asarray(offsets, np.int64)
            if val_dtype == "q8":
                if self.n_docs >= Q8_ROW_LIMIT:
                    raise ValueError(f"q8 rows are 24-bit: n_docs "
                                     f"{self.n_docs}")
                self._host_scales = np.asarray(second, np.float32)
                second = None
            elif val_dtype == "bf16":
                if 2 * second.shape[0] < flat.shape[0]:
                    raise ValueError(f"bf16 pairs {tuple(second.shape)} hold "
                                     f"fewer values than rows "
                                     f"{tuple(flat.shape)}")
            elif second.shape != flat.shape:
                raise ValueError(f"rows {tuple(flat.shape)} and value bits "
                                 f"{tuple(second.shape)} differ")
            if flat.shape[0] < int(host_offsets[-1]) + self._chunk:
                raise ValueError(
                    f"device_csr arrays must be padded >= one job "
                    f"({self._chunk} postings) past offsets[-1] with the "
                    "n_docs sentinel (an aligned fetch window near the end "
                    "reads past the last posting)")
            self.rows_flat, self.valbits_flat = flat, second
        else:
            self.device = torch.device(device)
            self.n_docs = index.nb_docs()
            host_offsets = np.asarray(index.offsets, np.int64)
            if fetch == "auto":
                fetch = "dma" if self.device.type == "cuda" else "gather"
            self.fetch = "dma" if val_dtype != "f32" else fetch
            if self.fetch == "gather":
                self.packed = _upload_packed(index, self.device)
                self.rows_flat = self.valbits_flat = None
            elif val_dtype == "q8":
                if self.n_docs >= Q8_ROW_LIMIT:
                    raise ValueError(f"q8 rows are 24-bit: n_docs "
                                     f"{self.n_docs} >= {Q8_ROW_LIMIT}; "
                                     "shard the corpus")
                self.rows_flat, self._host_scales = _upload_q8(
                    index, self.n_docs, index.nnz + self._chunk, self.device)
                self.valbits_flat = None
            else:
                self.rows_flat, self.valbits_flat = _upload_dma(
                    index, self.n_docs, self._chunk, val_dtype, self.device)
        flat = self.packed if self.fetch == "gather" else self.rows_flat
        if flat.shape[0] >= 2 ** 31:
            raise ValueError("nnz exceeds int32: shard the index")
        self._host_offsets = host_offsets
        self._host_lens = np.diff(host_offsets)
        self.offsets = torch.from_numpy(host_offsets).to(self.device)
        if sync_upload if sync is None else sync:
            self.sync_upload()

    def sync_upload(self) -> None:
        """Block until the index buffers are on the device."""
        force_materialized(self.rows_flat, self.valbits_flat, self.packed,
                           self.offsets)

    def sparsify_queries(self, q_dense: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        return sparsify_reps(q_dense, self.T)

    def job_need(self, q_terms: np.ndarray, q_vals: np.ndarray) -> np.ndarray:
        """Per-query DMA job count [nq] from the host offsets: the cost
        model of the serving broker and of this engine's bucket choice.
        bf16 counts CHUNK2-posting jobs."""
        c = self._chunk
        starts = self._host_offsets[q_terms]
        lens = self._host_lens[q_terms] * (q_vals > 0)
        heads = starts % c
        return np.sum(-(-(heads + lens) // c) * (lens > 0), axis=1)

    def stats(self) -> dict:
        with self._counts_lock:
            return dict(self._counts)

    def _count(self, certified: bool, rows: int, jobs: int,
               jobs_real: int) -> dict:
        """Add one read's tile to the counts; returns its own."""
        tile = {"rows": rows, "jobs": jobs, "jobs_real": jobs_real,
                "jobs_slab": rows * jobs, "cert_fallback": not certified}
        with self._counts_lock:
            c = self._counts
            c["tiles"] += 1
            c["cert_fallback_tiles"] += not certified
            c["jobs_real"] += jobs_real
            c["jobs_slab"] += rows * jobs
        return tile

    def _scales_on_device(self) -> torch.Tensor:
        if self._scales_dev is None:
            self._scales_dev = torch.from_numpy(self._host_scales).to(
                self.device)
        return self._scales_dev

    def retrieve_tile(self, q_dense: np.ndarray, topk: Optional[int] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """q_dense [nq, V] → (scores [nq, k], rows [nq, k]); exact."""
        return self.finalize(self.retrieve_tile_async(q_dense, topk))

    def retrieve_tile_async(self, q_dense: Optional[np.ndarray],
                            topk: Optional[int] = None, sparsified=None):
        """Dispatch a host query tile without any device->host read.
        ``sparsified=(q_terms, q_vals)`` skips the sparsify. The job table
        is sized exactly from host offsets (rounded up by bucket_jobs), so
        no posting is dropped. Returns a payload for ``finalize``."""
        k = min(topk or self.topk, self.n_docs)
        q_terms, q_vals = (sparsified if sparsified is not None
                           else self.sparsify_queries(q_dense))
        q_terms = np.ascontiguousarray(q_terms, np.int32)
        q_vals = np.ascontiguousarray(q_vals, np.float32)
        if self.fetch == "gather":
            # exact posting budget from the host lengths, a power of two
            need = int((self._host_lens[q_terms] * (q_vals > 0)).sum(
                axis=1).max(initial=0))
            p_budget = self.min_budget
            while p_budget < need:
                p_budget *= 2
            with profile_span("engine.launch"):
                s, r, _ = segsort_retrieve(
                    self.packed, self.offsets,
                    torch.from_numpy(q_terms).to(self.device),
                    torch.from_numpy(q_vals).to(self.device), k, p_budget,
                    self.n_docs, self.ops)
            return s, r, None, k, 0, 0
        with profile_span("engine.plan"):
            need = self.job_need(q_terms, q_vals)
            jobs = bucket_jobs(int(need.max(initial=0)))
            if self.val_dtype == "q8":
                # exact fold: the device scores plain qw' * code
                q_vals = q_vals * self._host_scales[q_terms]
            qt = torch.from_numpy(q_terms).to(self.device)
            qv = torch.from_numpy(q_vals).to(self.device)
        with profile_span("engine.launch"):
            s, r, fb, _, _, _ = _retrieve_async(
                self.val_dtype, self.rows_flat, self.valbits_flat,
                self.offsets, qt, qv, k, jobs, self.n_docs, self.ops)
        return s, r, fb, k, int(need.sum()), jobs

    def finalize(self, payload) -> tuple[np.ndarray, np.ndarray]:
        """Resolve and read back a ``retrieve_tile_async`` payload."""
        scores, rows, fallback, k, jobs_real, jobs = payload
        with profile_span("engine.read"):
            certified = _certified(fallback)
            if not certified:
                scores, rows = _full_topk(fallback, k)
            with profile_span("engine.copy_out") as sp:
                buf = _pack_score_rows(scores, rows, 2 * k).cpu().numpy()
                sp.attrs.update(self._count(certified, buf.shape[0], jobs,
                                            jobs_real))
        return buf[:, :k].copy().view(np.float32), buf[:, k:2 * k]

    def retrieve_tile_handoff_async(self, q_terms_dev, q_vals_dev,
                                    jobs_per_query: int,
                                    topk: Optional[int] = None,
                                    n_real: Optional[int] = None):
        """Dispatch a device-resident query tile (terms int32 / vals f32
        [nq, T], e.g. the encoder's top-T) at a caller-chosen standing job
        bucket, with no host read or upload. ``finalize_handoff`` reads the
        packed result; rows whose need exceeded the bucket were truncated
        and must be re-routed by the caller (the text frontend does). f32
        and q8 layouts only, as in the reference. ``n_real``: the tile's
        leading rows that are queries (all by default); the rest pad it
        and count in ``jobs_slab`` only."""
        if self.val_dtype == "bf16":
            raise ValueError("the device handoff rides the f32/q8 layouts")
        if self.fetch != "dma":
            raise ValueError("the device handoff needs fetch='dma'")
        k = min(topk or self.topk, self.n_docs)
        with profile_span("engine.launch"):
            if self.val_dtype == "q8":
                q_vals_dev = q_vals_dev * self._scales_on_device()[
                    q_terms_dev.long()]
            buf, fb = _packed_handoff_tail(
                self.rows_flat, self.valbits_flat, self.offsets, q_terms_dev,
                q_vals_dev, k, jobs_per_query, self.n_docs, self.ops)
        n = q_terms_dev.shape[0]
        return buf, k, fb, self, n if n_real is None else n_real, \
            jobs_per_query

    @staticmethod
    def finalize_handoff(payload) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        """One read of a handoff payload → (scores [nq, k], rows [nq, k],
        need [nq]); counted by the engine that dispatched it."""
        buf, k, fallback, engine, n_real, jobs = payload
        with profile_span("engine.read"):
            buf, certified = _resolve_handoff(buf, k, fallback)
            with profile_span("engine.copy_out") as sp:
                buf = buf.cpu().numpy()
                need = buf[:, 2 * k]
                sp.attrs.update(engine._count(
                    certified, buf.shape[0], jobs,
                    int(np.minimum(need[:n_real], jobs).sum())))
        return buf[:, :k].copy().view(np.float32), buf[:, k:2 * k], need


class ShardedSegsortEngine:
    """Doc-sharded segsort over a list of devices (repeats allowed; every
    visible card by default, as the reference defaults to every device).

    ``SparseIndex.shard_by_rows`` splits the corpus into doc-range shards
    with local rows, each posting list in its order; each shard gets its
    own ``SegsortEngine`` on its device (full [V+1] offsets, so query term
    ids are valid on every shard). A tile runs on every shard and the
    per-shard top-k lists merge on the host. ``ops`` and ``fetch`` go to
    every shard; a shard whose kernel fails raises. ``index`` may also be
    the list of its doc-range shards, one per device in row order (what
    ``shard_by_rows`` returns), to build several layouts from one split.
    """

    def __init__(self, index, devices=None, topk: int = 1000,
                 query_terms_budget: int = 64, min_budget: int = 1 << 17,
                 val_dtype: str = "f32", ops: Ops = KERNELS,
                 fetch: str = "dma"):
        self.devices = [torch.device(d)
                        for d in devices or local_devices()]
        self.topk = topk
        shards = (list(index) if isinstance(index, (list, tuple))
                  else index.shard_by_rows(len(self.devices)))
        if len(shards) != len(self.devices):
            raise ValueError(f"{len(shards)} shards for "
                             f"{len(self.devices)} devices")
        sizes = [s.nb_docs() for s in shards]
        self.row_offsets = np.cumsum([0] + sizes[:-1]).tolist()
        self.shards = [SegsortEngine(
            shard, topk=topk, query_terms_budget=query_terms_budget,
            val_dtype=val_dtype, device=dev, ops=ops, fetch=fetch,
            min_budget=min_budget, sync=False)
            for shard, dev in zip(shards, self.devices)]
        # each shard queued its upload; wait for all of them once
        for eng in self.shards:
            eng.sync_upload()
        self.n_docs = sum(sizes)

    @property
    def T(self) -> int:
        return self.shards[0].T

    def sparsify_queries(self, q_dense: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        return self.shards[0].sparsify_queries(q_dense)

    def retrieve_tile_async(self, q_dense: Optional[np.ndarray],
                            topk: Optional[int] = None, sparsified=None):
        """Sparsify once, then dispatch the tile on every shard with no
        host read in between. Returns a payload for ``finalize``."""
        topk = topk or self.topk
        if sparsified is None and q_dense is not None:
            sparsified = self.sparsify_queries(q_dense)
        in_flight = [eng.retrieve_tile_async(None, topk,
                                             sparsified=sparsified)
                     for eng in self.shards]
        return in_flight, topk

    def finalize(self, payload) -> tuple[np.ndarray, np.ndarray]:
        """Each shard's top-k read through its engine, local rows made
        global, then a stable merge by score (ties keep shard order)."""
        in_flight, topk = payload
        all_scores, all_rows = [], []
        for flight, eng, off in zip(in_flight, self.shards,
                                    self.row_offsets):
            s, r = eng.finalize(flight)
            valid = np.isfinite(s) & (r < eng.n_docs)
            all_scores.append(np.where(valid, s, -np.inf))
            all_rows.append(np.where(valid, r + off, self.n_docs))
        scores = np.concatenate(all_scores, axis=1)
        rows = np.concatenate(all_rows, axis=1)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :topk]
        return (np.take_along_axis(scores, order, axis=1),
                np.take_along_axis(rows, order, axis=1))

    def retrieve_tile(self, q_dense: np.ndarray, topk: Optional[int] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        return self.finalize(self.retrieve_tile_async(q_dense, topk))
