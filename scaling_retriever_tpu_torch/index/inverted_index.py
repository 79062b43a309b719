"""CSR impact index (port of index/inverted_index.py, numpy only).

``offsets[V+1]`` into concatenated ``doc_rows``/``values`` arrays, plus the
row → external doc id map. ``save``/``load`` write and read the same files
as the JAX package (``csr_index.npz`` with the same keys and dtypes,
``doc_ids.json``, ``index_dist.json``, ``index_stats.json``), so an index
written by either package loads in the other. ``to_doc_major`` inverts it
into the [N, K] doc-major layout of the doc-major scan.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

INDEX_FILE = "csr_index.npz"
DOC_IDS_FILE = "doc_ids.json"


class SparseIndex:
    """CSR impact index over (doc_row, term, value) triples. ``doc_ids``
    is a list aligned to rows 0..n-1, or a {row: id} dict densified with
    ``None`` holes."""

    def __init__(self, offsets: np.ndarray, doc_rows: np.ndarray,
                 values: np.ndarray, doc_ids, dim: int):
        if offsets.shape[0] != dim + 1:
            raise ValueError(f"offsets {offsets.shape} for dim {dim}")
        self.offsets = offsets.astype(np.int64, copy=False)
        self.doc_rows = doc_rows.astype(np.int32, copy=False)
        self.values = values.astype(np.float32, copy=False)
        if isinstance(doc_ids, dict):
            n = (max(int(k) for k in doc_ids) + 1) if doc_ids else 0
            dense: list = [None] * n
            for row, docid in doc_ids.items():
                dense[int(row)] = docid
            self.doc_ids = dense
        else:
            self.doc_ids = list(doc_ids)
        self.dim = int(dim)

    @classmethod
    def from_triples(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     doc_ids: Sequence[str], dim: int) -> "SparseIndex":
        """Build CSR from unsorted triples (one stable sort by term)."""
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        counts = np.bincount(cols, minlength=dim)
        offsets = np.zeros(dim + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        order = np.argsort(cols, kind="stable")
        return cls(offsets, rows[order], vals[order], doc_ids, dim)

    @property
    def nnz(self) -> int:
        return int(self.doc_rows.shape[0])

    def nb_docs(self) -> int:
        return len(self.doc_ids)

    def posting(self, term: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.offsets[term], self.offsets[term + 1]
        return self.doc_rows[s:e], self.values[s:e]

    def l0_d(self) -> float:
        """Average non-zeros per doc."""
        return self.nnz / max(1, self.nb_docs())

    def index_dist(self) -> dict:
        """Posting-list sizes of the non-empty terms, keyed by term id."""
        sizes = np.diff(self.offsets)
        nz = np.nonzero(sizes)[0]
        return {int(t): int(sizes[t]) for t in nz}

    def to_doc_major(self, k: Optional[int] = None, pad_multiple: int = 8,
                     device=None, n_rows: Optional[int] = None,
                     chunk: int = 1 << 27):
        """Invert to the doc-major layout [n_rows, K] (terms int32, vals
        f32): row d holds doc d's postings in CSR order (terms ascending),
        then zeros; K is the max per-doc nnz rounded up to ``pad_multiple``
        unless given; rows past ``nb_docs()`` (``n_rows``, default
        ``nb_docs()``) are all zero.

        ``device=None`` builds numpy arrays on the host with the
        reference's stable argsort. A torch device builds tensors there
        instead, bit-identical: the postings stream through in CSR chunks
        of ``chunk`` and each lands at its doc's running fill count, so no
        sort of the whole index is needed."""
        n = self.nb_docs()
        n_rows = n if n_rows is None else int(n_rows)
        if n_rows < n:
            raise ValueError(f"n_rows {n_rows} < {n} docs")
        if device is None:
            per_doc = np.bincount(self.doc_rows, minlength=n)
        else:
            dev = torch.device(device)
            per_doc = torch.zeros(max(n, 1), dtype=torch.int64, device=dev)
            for s in range(0, self.nnz, chunk):
                per_doc += torch.bincount(
                    torch.from_numpy(self.doc_rows[s:s + chunk]).to(dev),
                    minlength=per_doc.shape[0])
        kmax = int(per_doc.max()) if n else 1
        if k is None:
            k = max(pad_multiple, -(-kmax // pad_multiple) * pad_multiple)
        if kmax > k:
            raise ValueError(f"a doc holds {kmax} postings > k {k}")
        if device is not None:
            return self._to_doc_major_torch(dev, n_rows, k, chunk)
        terms = np.zeros((n_rows, k), np.int32)
        vals = np.zeros((n_rows, k), np.float32)
        order = np.argsort(self.doc_rows, kind="stable")
        sorted_rows = self.doc_rows[order]
        term_of = np.repeat(np.arange(self.dim, dtype=np.int64),
                            np.diff(self.offsets))
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(per_doc, out=starts[1:])
        slot = np.arange(len(sorted_rows)) - starts[sorted_rows]
        terms[sorted_rows, slot] = term_of[order].astype(np.int32)
        vals[sorted_rows, slot] = self.values[order]
        return terms, vals

    def _to_doc_major_torch(self, dev, n_rows: int, k: int, chunk: int):
        terms = torch.zeros((n_rows, k), dtype=torch.int32, device=dev)
        vals = torch.zeros((n_rows, k), dtype=torch.float32, device=dev)
        offsets = torch.from_numpy(self.offsets).to(dev)
        # postings of each doc placed so far (CSR order = terms ascending)
        fill = torch.zeros(max(self.nb_docs(), 1), dtype=torch.int64,
                           device=dev)
        flat_t, flat_v = terms.view(-1), vals.view(-1)
        for s in range(0, self.nnz, chunk):
            e = min(s + chunk, self.nnz)
            rows = torch.from_numpy(self.doc_rows[s:e]).to(dev).long()
            rs, perm = torch.sort(rows, stable=True)
            idx = torch.arange(e - s, device=dev)
            new_run = torch.ones_like(rs, dtype=torch.bool)
            new_run[1:] = rs[1:] != rs[:-1]
            run_start = torch.cummax(torch.where(new_run, idx, 0), 0)[0]
            dst = rs * k + fill[rs] + (idx - run_start)
            pos = perm + s
            flat_t[dst] = (torch.searchsorted(offsets, pos, right=True)
                           - 1).to(torch.int32)
            flat_v[dst] = torch.from_numpy(self.values[s:e]).to(dev)[perm]
            fill += torch.bincount(rows, minlength=fill.shape[0])
        return terms, vals

    def save(self, index_dir: str) -> None:
        os.makedirs(index_dir, exist_ok=True)
        np.savez(os.path.join(index_dir, INDEX_FILE),
                 offsets=self.offsets, doc_rows=self.doc_rows,
                 values=self.values, dim=np.int64(self.dim))
        with open(os.path.join(index_dir, DOC_IDS_FILE), "w") as f:
            json.dump(self.doc_ids, f)
        with open(os.path.join(index_dir, "index_dist.json"), "w") as f:
            json.dump(self.index_dist(), f)
        with open(os.path.join(index_dir, "index_stats.json"), "w") as f:
            json.dump({"L0_d": self.l0_d()}, f)

    @classmethod
    def load(cls, index_dir: str) -> "SparseIndex":
        """Load a ``save``d index. (The reference's h5py layout is read by
        the JAX package only so far.)"""
        with np.load(os.path.join(index_dir, INDEX_FILE)) as data:
            offsets, doc_rows = data["offsets"], data["doc_rows"]
            values, dim = data["values"], int(data["dim"])
        with open(os.path.join(index_dir, DOC_IDS_FILE)) as f:
            doc_ids = json.load(f)
        return cls(offsets, doc_rows, values, doc_ids, dim)
