"""CSR impact index (port of index/inverted_index.py, numpy only).

``offsets[V+1]`` into concatenated ``doc_rows``/``values`` arrays, plus the
row → external doc id map. ``save``/``load`` write and read the same files
as the JAX package (``csr_index.npz`` with the same keys and dtypes,
``doc_ids.json``, ``index_dist.json``, ``index_stats.json``), so an index
written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

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
