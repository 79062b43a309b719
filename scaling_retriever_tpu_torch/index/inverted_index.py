"""CSR impact index (port of index/inverted_index.py, numpy only).

``offsets[V+1]`` into concatenated ``doc_rows``/``values`` arrays, plus the
row → external doc id map. ``save``/``load`` write and read the same files
as the JAX package (``csr_index.npz`` with the same keys and dtypes,
``doc_ids.json``, ``index_dist.json``, ``index_stats.json``), so an index
written by either package loads in the other; ``save_h5py``/``load_h5py``
write and read the original retriever's per-term HDF5 layout with a
pickled doc-id list. ``to_doc_major`` inverts it into the [N, K]
doc-major layout of the doc-major scan, and ``merge_indexes`` joins the
shards of a rank-sharded build.
"""

from __future__ import annotations

import json
import os
import pickle
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

    @classmethod
    def from_doc_major(cls, terms: np.ndarray, vals: np.ndarray,
                       doc_ids: Sequence[str], dim: int) -> "SparseIndex":
        """From [N, K] (terms, vals); slots with a value <= 0 are empty."""
        mask = vals > 0
        rows = np.broadcast_to(
            np.arange(terms.shape[0], dtype=np.int32)[:, None],
            terms.shape)[mask]
        return cls.from_triples(rows, terms[mask].astype(np.int64),
                                vals[mask], doc_ids, dim)

    @property
    def nnz(self) -> int:
        return int(self.doc_rows.shape[0])

    def nb_docs(self) -> int:
        return len(self.doc_ids)

    def __len__(self) -> int:
        """The number of non-empty posting lists."""
        return int(np.sum(np.diff(self.offsets) > 0))

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

    def shard_by_rows(self, n_shards: int, chunk_postings: int = 1 << 26
                      ) -> list["SparseIndex"]:
        """Split into ``n_shards`` doc-range shards with LOCAL rows (shard d
        owns rows [d*per, (d+1)*per), per = ceil(n / n_shards)).

        Each shard's CSR is built directly, without an [nnz] term array or
        a sort: one counting pass over term-aligned chunks of at most
        ``chunk_postings`` postings (a longer term gets a chunk of its
        own), a cumsum per shard, then a fill pass. Term-major source and
        destination orders coincide, so each (chunk, shard) selection
        lands in one contiguous slice, in source order (posting lists
        unsorted within a term, as a merged index has, stay so)."""
        n = self.nb_docs()
        per = -(-n // n_shards) if n else 1
        dim = self.dim
        sizes = np.diff(self.offsets)

        bounds = [0]
        acc = 0
        for t in range(dim):
            acc += int(sizes[t])
            if acc >= chunk_postings:
                bounds.append(t + 1)
                acc = 0
        if bounds[-1] != dim:
            bounds.append(dim)

        counts = np.zeros((n_shards, dim), np.int64)
        for t0, t1 in zip(bounds[:-1], bounds[1:]):
            s, e = int(self.offsets[t0]), int(self.offsets[t1])
            if s == e:
                continue
            shard_of = np.minimum(self.doc_rows[s:e] // per, n_shards - 1)
            term_local = np.repeat(np.arange(t1 - t0, dtype=np.int64),
                                   sizes[t0:t1])
            c = np.bincount(term_local * n_shards + shard_of,
                            minlength=(t1 - t0) * n_shards)
            counts[:, t0:t1] += c.reshape(t1 - t0, n_shards).T

        shards = []
        for d in range(n_shards):
            off = np.zeros(dim + 1, np.int64)
            np.cumsum(counts[d], out=off[1:])
            shards.append((off, np.empty(int(off[-1]), np.int32),
                           np.empty(int(off[-1]), np.float32)))

        for t0, t1 in zip(bounds[:-1], bounds[1:]):
            s, e = int(self.offsets[t0]), int(self.offsets[t1])
            if s == e:
                continue
            r = self.doc_rows[s:e]
            v = self.values[s:e]
            shard_of = np.minimum(r // per, n_shards - 1)
            for d, (off, rows_out, vals_out) in enumerate(shards):
                sel = shard_of == d
                lo_dst, hi_dst = int(off[t0]), int(off[t1])
                rows_out[lo_dst:hi_dst] = r[sel] - d * per
                vals_out[lo_dst:hi_dst] = v[sel]

        out = []
        for d in range(n_shards):
            off, rows_out, vals_out = shards[d]
            shards[d] = None  # release as consumed: no second copy alive
            lo, hi = d * per, min((d + 1) * per, n)
            out.append(type(self)(off, rows_out, vals_out,
                                  self.doc_ids[lo:hi], dim))
        return out

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
        """Load a ``save``d index, or else the h5py layout; doc ids from
        ``doc_ids.json``, or else the reference's ``doc_ids.pkl``."""
        npz_path = os.path.join(index_dir, INDEX_FILE)
        if not os.path.exists(npz_path):
            return cls.load_h5py(index_dir)
        with np.load(npz_path) as data:
            offsets, doc_rows = data["offsets"], data["doc_rows"]
            values, dim = data["values"], int(data["dim"])
        ids_path = os.path.join(index_dir, DOC_IDS_FILE)
        if os.path.exists(ids_path):
            with open(ids_path) as f:
                doc_ids = json.load(f)
        else:
            doc_ids = _load_reference_doc_ids(index_dir)
        return cls(offsets, doc_rows, values, doc_ids, dim)

    def save_h5py(self, index_dir: str,
                  filename: str = "array_index.h5py") -> None:
        """Write the original retriever's layout: one pair of datasets per
        non-empty term, a ``dim`` scalar, and a pickled doc-id list."""
        import h5py

        os.makedirs(index_dir, exist_ok=True)
        with h5py.File(os.path.join(index_dir, filename), "w") as f:
            f.create_dataset("dim", data=int(self.dim))
            for t in np.nonzero(np.diff(self.offsets))[0]:
                rows, vals = self.posting(int(t))
                f.create_dataset(f"index_doc_id_{t}",
                                 data=rows.astype(np.int32))
                f.create_dataset(f"index_doc_value_{t}",
                                 data=vals.astype(np.float32))
        with open(os.path.join(index_dir, "doc_ids.pkl"), "wb") as f:
            pickle.dump(list(self.doc_ids), f)
        with open(os.path.join(index_dir, "index_dist.json"), "w") as f:
            json.dump(self.index_dist(), f)
        with open(os.path.join(index_dir, "index_stats.json"), "w") as f:
            json.dump({"L0_d": self.l0_d()}, f)

    @classmethod
    def load_h5py(cls, index_dir: str, filename: str = "array_index.h5py",
                  dim_voc: Optional[int] = None) -> "SparseIndex":
        """Read an index in the original retriever's h5py layout."""
        import h5py

        rows_list, vals_list = [], []
        with h5py.File(os.path.join(index_dir, filename), "r") as f:
            dim = dim_voc if dim_voc is not None else int(f["dim"][()])
            offsets = np.zeros(dim + 1, np.int64)
            for t in range(dim):
                key = f"index_doc_id_{t}"
                if key in f:
                    r = np.asarray(f[key], np.int32)
                    rows_list.append(r)
                    vals_list.append(np.asarray(f[f"index_doc_value_{t}"],
                                                np.float32))
                    offsets[t + 1] = offsets[t] + len(r)
                else:
                    offsets[t + 1] = offsets[t]
        doc_rows = (np.concatenate(rows_list) if rows_list
                    else np.zeros(0, np.int32))
        values = (np.concatenate(vals_list) if vals_list
                  else np.zeros(0, np.float32))
        return cls(offsets, doc_rows, values,
                   _load_reference_doc_ids(index_dir), dim)


def _load_reference_doc_ids(index_dir: str) -> list:
    """``doc_ids.pkl``: a list, or the {row: id} dict a merge writes. The
    pickle is one this package or the original retriever wrote."""
    pkl = os.path.join(index_dir, "doc_ids.pkl")
    if not os.path.exists(pkl):
        raise FileNotFoundError(f"no doc id map in {index_dir}")
    with open(pkl, "rb") as f:
        ids = pickle.load(f)
    if isinstance(ids, dict):
        out = [None] * (max(ids.keys()) + 1)
        for row, docid in ids.items():
            out[int(row)] = docid
        return out
    return list(ids)


def merge_indexes(index_dirs: Sequence[str], out_dir: Optional[str],
                  dim_voc: int) -> SparseIndex:
    """Concatenate per-shard indexes into one. Shard postings carry global
    interleaved rows (``g = local * n_shards + shard``) and shard doc-id
    maps are {global_row: id} with ``None`` holes, so the merge joins
    posting lists in shard order and unions the maps: no renumbering."""
    parts = [SparseIndex.load(d) for d in index_dirs]
    offsets = np.zeros(dim_voc + 1, np.int64)
    sizes = np.zeros(dim_voc, np.int64)
    for p in parts:
        if p.dim > dim_voc:
            raise ValueError(f"a shard's dim {p.dim} > dim_voc {dim_voc}")
        sizes[:p.dim] += np.diff(p.offsets)
    np.cumsum(sizes, out=offsets[1:])
    nnz = int(offsets[-1])
    doc_rows = np.zeros(nnz, np.int32)
    values = np.zeros(nnz, np.float32)
    cursor = offsets[:-1].copy()
    for p in parts:
        for t in np.nonzero(np.diff(p.offsets))[0]:
            r, v = p.posting(int(t))
            c = cursor[t]
            doc_rows[c:c + len(r)] = r
            values[c:c + len(r)] = v
            cursor[t] += len(r)
    merged_ids: dict = {}
    for p in parts:
        merged_ids.update({row: d for row, d in enumerate(p.doc_ids)
                           if d is not None})
    merged = SparseIndex(offsets, doc_rows, values, merged_ids, dim_voc)
    if out_dir:
        merged.save(out_dir)
    return merged
