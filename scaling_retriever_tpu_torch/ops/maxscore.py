"""Impact-ordered pruned scoring, the "maxscore" engine (port of
ops/maxscore.py): exact top-k with TA-style upper-bound certificates.

* Prune: posting lists sorted by impact descending and cut at ``prefix``
  entries per term; the segsort engine (on the kernels, at topk = C)
  scores the prefixes and returns the top-C partial scores per query.
* Certificate: u_t is the largest impact term t left out (the impact at
  rank ``prefix``, 0 if the list fits). Any doc's true score is at most
  its partial score plus bound = sum_t qw_t * u_t, so a doc outside the
  top C (partial <= max(partial@C, 0)) cannot reach the top k when
  max(partial@C, 0) + bound < partial@k; bound == 0 is trivially exact.
* Rescore: the C candidates' full doc-major rows are gathered and scored
  exactly (a T-step compare scan, no scatter), then the top k.
* Fallback: queries whose certificate fails rerun on the exhaustive
  doc-major scan (``ops/sparse_scoring.retrieve_doc_major``), so results
  are always exact; ``.tiles`` / ``.fallbacks`` count how often.

The reference does the rescore and the fallback in XLA with no Pallas
kernel, so they are plain PyTorch here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    SegsortEngine, _finish,
)
from scaling_retriever_tpu_torch.ops.sparse_scoring import retrieve_doc_major


def build_impact_prefix(index: SparseIndex, prefix: int, device=None,
                        chunk: int = 1 << 27
                        ) -> tuple[SparseIndex, np.ndarray]:
    """(the index with each posting list sorted by impact descending, ties
    in list order, and cut at ``prefix`` entries; u_arr [V] f32, the first
    impact cut from each list, 0 where nothing was cut).

    ``device=None`` runs the reference's numpy lexsort over the whole
    index. A torch device sorts there instead, bit-identically: whole
    terms in chunks of about ``chunk`` postings, by one stable sort of an
    int64 key (term, then impact descending)."""
    dim = index.dim
    sizes = np.diff(index.offsets)
    if device is None:
        term_of = np.repeat(np.arange(dim, dtype=np.int64), sizes)
        order = np.lexsort((-index.values, term_of))
        rows_s = index.doc_rows[order]
        vals_s = index.values[order]
        pos = np.arange(index.nnz, dtype=np.int64) - np.repeat(
            index.offsets[:-1], sizes)
        keep = pos < prefix
        u_arr = np.zeros(dim, np.float32)
        at_boundary = pos == prefix
        u_arr[term_of[at_boundary]] = vals_s[at_boundary]
        rows_k, vals_k = rows_s[keep], vals_s[keep]
    else:
        rows_k, vals_k, u_arr = _impact_prefix_torch(index, prefix,
                                                     torch.device(device),
                                                     chunk)
    new_sizes = np.minimum(sizes, prefix)
    new_offsets = np.zeros(dim + 1, np.int64)
    np.cumsum(new_sizes, out=new_offsets[1:])
    pruned = SparseIndex(new_offsets, rows_k, vals_k, index.doc_ids, dim)
    return pruned, u_arr


def _impact_prefix_torch(index: SparseIndex, prefix: int, dev, chunk: int):
    offsets = index.offsets
    u_arr = np.zeros(index.dim, np.float32)
    rows_out, vals_out = [], []
    t0 = 0
    while t0 < index.dim:
        # whole terms, about ``chunk`` postings (a longer list alone)
        t1 = int(np.searchsorted(offsets, offsets[t0] + chunk, side="right"))
        t1 = min(max(t1 - 1, t0 + 1), index.dim)
        s, e = int(offsets[t0]), int(offsets[t1])
        if e > s:
            off = torch.from_numpy(offsets[t0:t1 + 1] - s).to(dev)
            n = e - s
            idx = torch.arange(n, device=dev)
            term = torch.searchsorted(off, idx, right=True) - 1
            v = torch.from_numpy(index.values[s:e]).to(dev)
            bits = (v + 0.0).view(torch.int32).long()      # -0.0 -> +0.0
            asc = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
            key = (term << 33) + ((1 << 31) - asc)          # impact desc
            _, order = torch.sort(key, stable=True)
            pos = idx - off[term]
            keep = pos < prefix
            rows_s = torch.from_numpy(index.doc_rows[s:e]).to(dev)[order]
            vals_s = v[order]
            at = pos == prefix
            u_arr[(term[at] + t0).cpu().numpy()] = vals_s[at].cpu().numpy()
            rows_out.append(rows_s[keep].cpu().numpy())
            vals_out.append(vals_s[keep].cpu().numpy())
        t0 = t1
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return cat(rows_out, np.int32), cat(vals_out, np.float32), u_arr


def rescore_candidates(doc_terms: torch.Tensor, doc_vals: torch.Tensor,
                       partial_scores: torch.Tensor, cand_rows: torch.Tensor,
                       q_terms: torch.Tensor, q_vals: torch.Tensor,
                       bound: torch.Tensor, k: int, n_docs: int):
    """Exact top-k over the candidate set plus the per-query certificate.

    doc_terms/doc_vals: [N_pad, K] doc-major index with an all-zero row at
    ``n_docs`` (the sentinel's target); partial_scores/cand_rows [nq, C]:
    the prefix pass's output, descending (invalid slots -inf / n_docs);
    q_terms/q_vals [nq, T]; bound [nq]. Returns (scores [nq, k], rows
    [nq, k], ok [nq] bool)."""
    nq, C = cand_rows.shape
    safe_rows = cand_rows.clamp_max(n_docs).long()
    t = doc_terms[safe_rows]                       # [nq, C, K] row gather
    v = doc_vals[safe_rows].float()
    exact = torch.zeros((nq, C), device=cand_rows.device)
    for j in range(q_terms.shape[1]):
        tq, vq = q_terms[:, j], q_vals[:, j]
        hit = (t == tq[:, None, None]) & (vq > 0)[:, None, None]
        exact = exact + vq[:, None] * torch.where(hit, v, 0.0).sum(-1)
    valid = (cand_rows < n_docs) & torch.isfinite(partial_scores)
    exact = torch.where(valid, exact, float("-inf"))
    top_s, idx = torch.topk(exact, k, dim=1)
    top_r = cand_rows.gather(1, idx)
    top_r = torch.where(torch.isfinite(top_s), top_r, n_docs)
    ps_k = partial_scores[:, k - 1]
    ps_C = partial_scores[:, C - 1]
    ub_outside = torch.clamp_min(ps_C, 0.0) + bound
    ok = (bound <= 0.0) | (ub_outside < ps_k)
    return top_s, top_r, ok


class MaxScoreEngine:
    """Impact-ordered prefix scoring + exact candidate rescore with the
    exhaustive fallback. Output convention as SegsortEngine's: unmatched
    slots carry (-inf, n_docs).

    Knobs: ``prefix`` (per-term fetch depth: deeper = fewer fallbacks,
    more sort work) and ``candidates`` (C >= topk: wider = stronger
    certificate, more rescore work). The prefix engine is a SegsortEngine
    at topk = C (``fetch`` and ``device`` go to it); the
    doc-major arrays and the impact prefix are built on ``device``."""

    def __init__(self, index: SparseIndex, topk: int = 1000,
                 prefix: int = 4096, candidates: Optional[int] = None,
                 query_terms_budget: int = 64, min_budget: int = 1 << 17,
                 fetch: str = "auto", block: int = 4096,
                 doc_value_dtype=torch.float32, device="cuda"):
        self.topk = topk
        self.C = int(candidates or max(2 * topk, topk + 64))
        if self.C < topk:
            raise ValueError(f"candidates {self.C} < topk {topk}")
        self.n_docs = index.nb_docs()
        self.block = block
        self.device = torch.device(device)

        pruned, u_arr = build_impact_prefix(index, prefix, device=self.device)
        self._seg = SegsortEngine(pruned, topk=self.C,
                                  query_terms_budget=query_terms_budget,
                                  min_budget=min_budget, fetch=fetch,
                                  device=self.device)
        self.u_arr = u_arr
        # at least one zero row past n_docs (the sentinel's target), padded
        # to a block multiple for the exhaustive scan
        n_pad = -(-(self.n_docs + 1) // block) * block
        terms, vals = index.to_doc_major(device=self.device, n_rows=n_pad)
        self.doc_terms = terms
        self.doc_vals = vals.to(doc_value_dtype)
        del vals
        self.tiles = 0
        self.fallbacks = 0

    # cost-model passthroughs for SparseRetrieval's tile scheduler
    @property
    def _host_lens(self):
        return self._seg._host_lens

    @property
    def T(self) -> int:
        return self._seg.T

    def sparsify_queries(self, q_dense):
        return self._seg.sparsify_queries(q_dense)

    def retrieve_tile(self, q_dense: np.ndarray, topk: Optional[int] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """q_dense [nq, V] → (scores [nq, k], rows [nq, k]); always exact."""
        packed, rows = self._retrieve_tile_pruned(q_dense, topk)
        self.tiles += 1
        packed = packed.cpu().numpy()
        scores, ok = packed[:, :-1], packed[:, -1] > 0.5
        if not bool(ok.all()):
            self.fallbacks += 1
            return self._retrieve_tile_exhaustive(q_dense, topk)
        return scores, rows.cpu().numpy()

    def retrieve_batch(self, q_dense: np.ndarray, topk: Optional[int] = None,
                       tile: int = 64) -> tuple[np.ndarray, np.ndarray]:
        """Every tile runs the pruned path first; then the uncertified
        queries of all tiles are packed densely into exhaustive tiles (the
        doc-major scan costs about the same for any tile width)."""
        k = min(topk or self.topk, self.C, self.n_docs)
        nq = q_dense.shape[0]
        out_s = np.empty((nq, k), np.float32)
        out_r = np.empty((nq, k), np.int64)
        in_flight = []
        for start in range(0, nq, tile):
            q_tile = q_dense[start:start + tile]
            pad = tile - q_tile.shape[0]
            if pad:
                q_tile = np.pad(q_tile, ((0, pad), (0, 0)))
            in_flight.append((start, self._retrieve_tile_pruned(q_tile, k)))
        retry: list[int] = []
        for start, (packed, r) in in_flight:
            self.tiles += 1
            packed = packed.cpu().numpy()
            s, ok = packed[:, :-1], packed[:, -1] > 0.5
            r = r.cpu().numpy()
            n_real = min(tile, nq - start)
            out_s[start:start + n_real] = s[:n_real]
            out_r[start:start + n_real] = r[:n_real]
            retry.extend(start + i for i in range(n_real) if not ok[i])
        for rstart in range(0, len(retry), tile):
            sel = retry[rstart:rstart + tile]
            self.fallbacks += 1
            q_tile = q_dense[sel]
            pad = tile - q_tile.shape[0]
            if pad:
                q_tile = np.pad(q_tile, ((0, pad), (0, 0)))
            s, r = self._retrieve_tile_exhaustive(q_tile, k)
            out_s[sel] = s[:len(sel)]
            out_r[sel] = r[:len(sel)]
        return out_s, out_r

    def _retrieve_tile_pruned(self, q_dense: np.ndarray,
                              topk: Optional[int] = None):
        """Prune + rescore (no fallback): device (packed [nq, k+1] with the
        certificate in the last column, rows [nq, k])."""
        k = min(topk or self.topk, self.C, self.n_docs)
        q_terms, q_vals = self._seg.sparsify_queries(q_dense)
        bound = (self.u_arr[q_terms] * q_vals * (q_vals > 0)).sum(1)
        # the top-C partials, with the prefix pass's certificate resolved
        ps, pr = _finish(*self._seg.retrieve_tile_async(
            None, self.C, sparsified=(q_terms, q_vals))[:4])
        dev = self.device
        scores, rows, ok = rescore_candidates(
            self.doc_terms, self.doc_vals, ps, pr,
            torch.from_numpy(np.ascontiguousarray(q_terms)).to(dev),
            torch.from_numpy(np.ascontiguousarray(q_vals)).to(dev),
            torch.from_numpy(bound.astype(np.float32)).to(dev), k,
            self.n_docs)
        packed = torch.cat([scores, ok[:, None].float()], dim=1)
        return packed, rows

    def _retrieve_tile_exhaustive(self, q_dense: np.ndarray,
                                  topk: Optional[int] = None
                                  ) -> tuple[np.ndarray, np.ndarray]:
        """Certified-exact fallback: the full doc-major scan of the tile."""
        k = min(topk or self.topk, self.n_docs)
        q_t = torch.from_numpy(np.ascontiguousarray(q_dense.T,
                                                    np.float32)).to(
            self.device)
        scores, rows = retrieve_doc_major(self.doc_terms, self.doc_vals, q_t,
                                          k=k, block=self.block)
        scores = scores.cpu().numpy()
        rows = rows.cpu().numpy()
        # the segsort convention: no-overlap / padding slots (score 0 over
        # nonnegative impacts) become (-inf, n_docs)
        invalid = (scores <= 0.0) | (rows >= self.n_docs)
        return (np.where(invalid, -np.inf, scores),
                np.where(invalid, self.n_docs, rows))
