"""Sort-based inverted-index scoring, the "segsort" engine (port of
ops/segsort_scoring.py).

Work is proportional to the postings a query tile matches. Per tile:
  1. query terms are ordered by term id (monotone fetch addresses);
  2. posting fetch: each (query, term) slice is one contiguous CSR range,
     copied by CHUNK-posting jobs (ops/fetch.py, kernels B1/B2) with the
     valid mask, sentinel row and query weight fused in;
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
"""

from __future__ import annotations

from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.ops.fetch import (
    ALIGN, CHUNK, Q8_ROW_LIMIT, fetch_jobs, fetch_jobs_plain, fetch_jobs_q8,
    fetch_jobs_q8_plain, fetch_postings_dma, fetch_postings_dma_q8,
)
from scaling_retriever_tpu_torch.ops.segsum import (
    _run_end_mask, _segsum_passes, eligible, segsum_mask, segsum_mask_plain,
)
from scaling_retriever_tpu_torch.ops.topm import block_topm, block_topm_plain
from scaling_retriever_tpu_torch.utils.utils import force_materialized

Ops = namedtuple("Ops", "fetch fetch_q8 segsum topm")
KERNELS = Ops(fetch_jobs, fetch_jobs_q8, segsum_mask, block_topm)
PLAIN = Ops(fetch_jobs_plain, fetch_jobs_q8_plain, segsum_mask_plain,
            block_topm_plain)


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
    vmax = np.ones(len(lens), np.float32)
    nz = lens > 0
    if nz.any():
        vmax[nz] = np.maximum.reduceat(vals, offsets[:-1][nz])
    scales = np.where(nz & (vmax > 0), vmax / 255.0, 1.0).astype(np.float32)
    per_post = np.repeat(scales, lens)
    codes = np.clip(np.rint(vals / per_post), 1, 255).astype(np.uint32)
    n = max(int(pad_to), len(rows))
    packed = np.full(n, np.uint32(n_docs) << np.uint32(8), np.uint32)
    packed[:len(rows)] = (rows << np.uint32(8)) | codes
    return packed.view(np.int32), scales


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


def _finish(scores, rows, fallback, k: int):
    """Resolve a ``_rank_tail_async`` result: the full top-k over the slab
    where the blocked certificate failed (one small device->host read)."""
    if fallback is not None:
        ok, score, srow = fallback
        if not bool(ok.all()):
            scores, idx = torch.topk(score, k)
            rows = srow.gather(1, idx)
    return scores, rows


def _rank_tail(rows, contrib, sentinel: int, k: int, max_run: int,
               ops: Ops = KERNELS):
    """(rows, contrib) [nq, P] → (scores, rows) [nq, k], exact."""
    return _finish(*_rank_tail_async(rows, contrib, sentinel, k, max_run,
                                     ops), k)


def _sort_query_terms(q_terms: torch.Tensor, q_vals: torch.Tensor):
    q_terms, order = torch.sort(q_terms, dim=1, stable=True)
    return q_terms, q_vals.gather(1, order)


def _retrieve_async(flat, valbits_flat, offsets, q_terms, q_vals, k: int,
                    jobs_per_query: int, n_docs: int, ops: Ops):
    """Shared f32/q8 dispatch: ``valbits_flat`` None selects the q8 layout
    (``flat`` is then the packed word stream and ``q_vals`` scale-folded).
    Returns (scores, rows, fallback, total, q_terms, q_vals) with the query
    terms sorted."""
    T = q_terms.shape[1]
    q_terms, q_vals = _sort_query_terms(q_terms, q_vals)
    if valbits_flat is None:
        rows, contrib, total = fetch_postings_dma_q8(
            flat, q_terms, offsets, q_vals, jobs_per_query, n_docs,
            fetch=ops.fetch_q8)
    else:
        rows, contrib, total = fetch_postings_dma(
            flat, valbits_flat, q_terms, offsets, q_vals, jobs_per_query,
            n_docs, fetch=ops.fetch)
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
        rows_flat, valbits_flat, offsets, q_terms, q_vals, k, jobs_per_query,
        n_docs, ops)
    s, r = _finish(s, r, fb, k)
    return s, r, total


def segsort_retrieve_dma_q8(packed_flat, offsets, q_terms, q_vals, k: int,
                            jobs_per_query: int, n_docs: int,
                            ops: Ops = KERNELS):
    """segsort over the q8 word layout; ``q_vals`` must arrive scale-folded
    (qw * scale[term]), so scores are exact over the stored codes."""
    s, r, fb, total, _, _ = _retrieve_async(
        packed_flat, None, offsets, q_terms, q_vals, k, jobs_per_query,
        n_docs, ops)
    s, r = _finish(s, r, fb, k)
    return s, r, total


def _job_need(offsets, q_terms, q_vals) -> torch.Tensor:
    """Per-query DMA job count [nq] on device (host ``job_need``'s twin)."""
    qt = q_terms.long()
    lens = (offsets[qt + 1] - offsets[qt]) * (q_vals > 0)
    starts = offsets[qt]
    head = starts - (starts // ALIGN) * ALIGN
    return torch.where(lens > 0, -(-(head + lens) // CHUNK), 0).sum(dim=1)


def _packed_handoff_tail(flat, valbits_flat, offsets, q_terms, q_vals,
                         k: int, jobs_per_query: int, n_docs: int, ops: Ops):
    """Shared tail of the two device-handoff programs (f32 and q8): fetch,
    rank tail, on-device job need, and the packed (score bits | rows |
    need) [nq, 2k+1] int32 result. Returns (buf, fallback)."""
    s, r, fb, _, q_terms, q_vals = _retrieve_async(
        flat, valbits_flat, offsets, q_terms, q_vals, k, jobs_per_query,
        n_docs, ops)
    need = _job_need(offsets, q_terms, q_vals)
    buf = torch.cat([s.view(torch.int32), r.to(torch.int32),
                     need[:, None].to(torch.int32)], dim=1)
    return buf, fb


def _resolve_handoff(buf: torch.Tensor, k: int, fallback) -> torch.Tensor:
    if fallback is not None:
        ok, score, srow = fallback
        if not bool(ok.all()):
            s, idx = torch.topk(score, k)
            buf = buf.clone()
            buf[:, :k] = s.view(torch.int32)
            buf[:, k:2 * k] = srow.gather(1, idx)
    return buf


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
    return _resolve_handoff(buf, k, fb)


def segsort_retrieve_dma_packed_q8(packed_flat, scales_dev, offsets,
                                   q_terms, q_vals, k: int,
                                   jobs_per_query: int, n_docs: int,
                                   ops: Ops = KERNELS):
    """q8 twin of ``segsort_retrieve_dma_packed``: the per-term dequant
    scales ([V] f32 on device) fold into the weights on device."""
    q_vals = q_vals * scales_dev[q_terms.long()]
    buf, fb = _packed_handoff_tail(packed_flat, None, offsets, q_terms,
                                   q_vals, k, jobs_per_query, n_docs, ops)
    return _resolve_handoff(buf, k, fb)


def _pack_score_rows(scores: torch.Tensor, rows: torch.Tensor,
                     cols: int) -> torch.Tensor:
    """(scores f32 [nq, k], rows [nq, k]) → one int32 [nq, cols] buffer
    (score bits | rows | zero pad), read back in one copy."""
    buf = torch.cat([scores.view(torch.int32), rows.to(torch.int32)], dim=1)
    if cols > buf.shape[1]:
        buf = torch.nn.functional.pad(buf, (0, cols - buf.shape[1]))
    return buf


class SegsortEngine:
    """Owns the flat CSR on the device and runs query tiles over it.

    ``val_dtype="f32"`` keeps rows int32 and value bits int32 (8 B per
    posting); ``"q8"`` keeps one ``(row24 << 8) | code8`` word per posting
    (4 B) and folds the per-term dequant scales into the query weights.
    The bf16-pair layout is not ported yet.

    ``device_csr=(rows_flat, valbits_flat, offsets, n_docs)`` builds the
    engine over flat arrays that already live on the device (padded by at
    least CHUNK past ``offsets[-1]`` with the n_docs sentinel; ``offsets`` a
    host [V+1] array); for q8 pass ``(packed_flat, scales, offsets,
    n_docs)`` with the host [V] scales of ``pack_postings_q8``. ``index``
    is then ignored.
    """

    def __init__(self, index=None, topk: int = 1000,
                 query_terms_budget: int = 64, val_dtype: str = "f32",
                 device="cuda", device_csr=None):
        if val_dtype not in ("f32", "q8"):
            raise NotImplementedError(
                f"val_dtype {val_dtype!r}: the port has the f32 and q8 "
                "layouts (bf16 is not ported yet)")
        self.topk = topk
        self.T = query_terms_budget
        self.val_dtype = val_dtype
        self.fetch = "dma"
        self._host_scales = None
        self._scales_dev = None
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
            elif second.shape != flat.shape:
                raise ValueError(f"rows {tuple(flat.shape)} and value bits "
                                 f"{tuple(second.shape)} differ")
            if flat.shape[0] < int(host_offsets[-1]) + CHUNK:
                raise ValueError(
                    "device_csr arrays must be padded >= one CHUNK past "
                    "offsets[-1] with the n_docs sentinel (an aligned fetch "
                    "window near the end reads past the last posting)")
            self.rows_flat, self.valbits_flat = flat, second
        else:
            self.device = torch.device(device)
            self.n_docs = index.nb_docs()
            host_offsets = np.asarray(index.offsets, np.int64)
            pad = CHUNK
            if val_dtype == "q8":
                packed, self._host_scales = pack_postings_q8(
                    index.offsets, index.doc_rows, index.values, self.n_docs,
                    index.nnz + pad)
                self.rows_flat = torch.from_numpy(packed).to(self.device)
                self.valbits_flat = None
            else:
                rows = np.concatenate([index.doc_rows.astype(np.int32),
                                       np.full(pad, self.n_docs, np.int32)])
                vals = np.concatenate([index.values.astype(np.float32),
                                       np.zeros(pad, np.float32)])
                self.rows_flat = torch.from_numpy(rows).to(self.device)
                self.valbits_flat = torch.from_numpy(
                    vals.view(np.int32)).to(self.device)
        if self.rows_flat.shape[0] >= 2 ** 31:
            raise ValueError("nnz exceeds int32: shard the index")
        self._host_offsets = host_offsets
        self._host_lens = np.diff(host_offsets)
        self.offsets = torch.from_numpy(host_offsets).to(self.device)
        self.sync_upload()

    def sync_upload(self) -> None:
        """Block until the index buffers are on the device."""
        force_materialized(self.rows_flat, self.valbits_flat, self.offsets)

    def sparsify_queries(self, q_dense: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        return sparsify_reps(q_dense, self.T)

    def job_need(self, q_terms: np.ndarray, q_vals: np.ndarray) -> np.ndarray:
        """Per-query DMA job count [nq] from the host offsets: the cost
        model of the serving broker and of this engine's bucket choice."""
        starts = self._host_offsets[q_terms]
        lens = self._host_lens[q_terms] * (q_vals > 0)
        heads = starts % CHUNK
        return np.sum(-(-(heads + lens) // CHUNK) * (lens > 0), axis=1)

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
        jobs = bucket_jobs(int(self.job_need(q_terms, q_vals).max(initial=0)))
        if self.val_dtype == "q8":
            # exact fold: the device scores plain qw' * code
            q_vals = q_vals * self._host_scales[q_terms]
        qt = torch.from_numpy(q_terms).to(self.device)
        qv = torch.from_numpy(q_vals).to(self.device)
        s, r, fb, _, _, _ = _retrieve_async(
            self.rows_flat, self.valbits_flat, self.offsets, qt, qv, k, jobs,
            self.n_docs, KERNELS)
        return s, r, fb, k

    def finalize(self, payload) -> tuple[np.ndarray, np.ndarray]:
        """Resolve and read back a ``retrieve_tile_async`` payload."""
        scores, rows, fallback, k = payload
        scores, rows = _finish(scores, rows, fallback, k)
        buf = _pack_score_rows(scores, rows, 2 * k).cpu().numpy()
        return buf[:, :k].copy().view(np.float32), buf[:, k:2 * k]

    def retrieve_tile_handoff_async(self, q_terms_dev, q_vals_dev,
                                    jobs_per_query: int,
                                    topk: Optional[int] = None):
        """Dispatch a device-resident query tile (terms int32 / vals f32
        [nq, T], e.g. the encoder's top-T) at a caller-chosen standing job
        bucket, with no host read or upload. ``finalize_handoff`` reads the
        packed result; rows whose need exceeded the bucket were truncated
        and must be re-routed by the caller (the text frontend does)."""
        k = min(topk or self.topk, self.n_docs)
        if self.val_dtype == "q8":
            q_vals_dev = q_vals_dev * self._scales_on_device()[
                q_terms_dev.long()]
        buf, fb = _packed_handoff_tail(
            self.rows_flat, self.valbits_flat, self.offsets, q_terms_dev,
            q_vals_dev, k, jobs_per_query, self.n_docs, KERNELS)
        return buf, k, fb

    @staticmethod
    def finalize_handoff(payload) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        """One read of a handoff payload → (scores [nq, k], rows [nq, k],
        need [nq])."""
        buf, k, fallback = payload
        buf = _resolve_handoff(buf, k, fallback).cpu().numpy()
        return buf[:, :k].copy().view(np.float32), buf[:, k:2 * k], \
            buf[:, 2 * k]
