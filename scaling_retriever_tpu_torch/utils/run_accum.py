"""Array-native run accumulation for the offline driver (port of
utils/run_accum.py, numpy only).

The driver drains device tiles inside a dispatch-ahead pipeline, so the
drain must stay cheap: it masks each tile's (query indices, doc rows,
scores) with numpy and keeps the arrays. The ``{qid: {doc_id: score}}``
run dict (the reference's run.json layout) is built once, after the
pipeline, with bulk ``tolist`` conversions. A doc-id list is indexed
directly at build time (the reference first turns all of it into an
array, seconds at MSMARCO scale); the strings come out the same.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class RunAccumulator:
    """Accumulates per-tile top-k arrays; defers the run-dict build.

    qids: query ids (any type; stringified at build time). doc_ids: doc
    row -> doc id (stringified at build time; rows are masked before
    indexing, so the sentinel row ``n_docs`` never touches it). Rows
    >= n_docs are invalid. threshold: keep only scores strictly above it
    (None = no score filter, for engines that applied their own).
    keep_empty: emit ``{qid: {}}`` for a query with no surviving entry
    instead of omitting it.
    """

    def __init__(self, qids: Sequence, doc_ids, n_docs: int,
                 threshold: Optional[float] = 0.0, keep_empty: bool = False):
        self.qids = qids
        # the doc-id array is built lazily: np.asarray over an 8.8M-entry
        # list takes seconds, and only the run-dict build needs it
        self._doc_ids_raw = doc_ids
        self._doc_ids_np = None
        self.n_docs = n_docs
        self.threshold = threshold
        self.keep_empty = keep_empty
        self._tiles: list = []

    @property
    def doc_ids(self) -> np.ndarray:
        if self._doc_ids_np is None:
            self._doc_ids_np = np.asarray(self._doc_ids_raw)
        return self._doc_ids_np

    def add_tile(self, q_idx, rows, scores, valid=None) -> None:
        """Record one tile: q_idx [m] global query indices, rows/scores
        [m, k] (numpy)."""
        q_idx = np.asarray(q_idx)
        rows = np.asarray(rows)
        scores = np.asarray(scores, np.float32)
        if valid is None:
            valid = (rows >= 0) & (rows < self.n_docs) & np.isfinite(scores)
            if self.threshold is not None:
                valid &= scores > self.threshold
        self._tiles.append((q_idx, rows, scores, np.asarray(valid)))

    def __len__(self) -> int:
        return sum(t[0].shape[0] for t in self._tiles)

    def to_run(self) -> dict:
        """The ``{str(qid): {str(doc_id): float(score)}}`` run dict; a
        query with no surviving entry is omitted (unless keep_empty)."""
        raw = self._doc_ids_raw
        if isinstance(raw, np.ndarray):
            def lookup(r):
                return raw[r].tolist()
        else:
            # a list: index it directly, no array over every doc id
            def lookup(r):
                return [raw[j] for j in r.tolist()]
        res: dict = {}
        for q_idx, rows, scores, valid in self._tiles:
            for i, qi in enumerate(q_idx):
                v = valid[i]
                if not v.any():
                    if self.keep_empty:
                        res[str(self.qids[qi])] = {}
                    continue
                ids = lookup(rows[i][v])
                if not isinstance(ids[0], str):
                    ids = [str(d) for d in ids]
                res[str(self.qids[qi])] = dict(
                    zip(ids, scores[i][v].astype(np.float64).tolist()))
        return res
