"""The offline sparse retrieval driver (port of index/sparse_retrieval.py).

A query stream (token batches, dense reps or sparse (q_terms, q_vals)
batches) goes through one engine over a ``SparseIndex`` and comes out as
the reference's ``run.json`` ({qid: {doc_id: score}}) and
``q_stats.json``. Engines:

  * "auto"     — "segsort" on a CUDA device, "xla" on the CPU;
  * "xla"      — the doc-major scan (ops/sparse_scoring.py): one sweep of
                 the whole index per tile, whatever the query;
  * "segsort"  — the sort-based engine over the posting-fetch, segsum and
                 top-m kernels (ops/segsort_scoring.py), f32, bf16 or q8
                 (``index_val_dtype``);
  * "maxscore" — impact-ordered pruning with an exact rescore and a
                 certified fallback (ops/maxscore.py);
  * "bmx"      — block-max doc-range pruning for clustered corpora
                 (ops/blockmax.py), run through the staged pipeline;
  * "cpp"      — the host C++ CSR engine (index/cpp_engine.py), all
                 queries in one call.

``mesh=`` (a ``parallel.mesh.Mesh`` of more than one entry) shards the
corpus by doc ranges over its entries: "segsort" runs a
``ShardedSegsortEngine``, "xla" the doc-sharded scan of
``make_sharded_retrieve`` over rows padded to ``block`` times the entry
count; the other engines ignore it, as in the reference. Queries are then
prepared on the mesh's first device.

The driver keeps the reference's schedule: the stream is sorted by
estimated cost (matched postings), packed into (width, job bucket) tiles,
the first tile of each (width, bucket) variant runs alone before the
dispatch-ahead pipeline (``warmup_tiles``), and a query whose matched
postings exceed ``hot_postings`` leaves the sort-based engine for the
doc-major scan (``hot_queries``). Dense reps (and encoder output) are
sparsified batch by batch where they live, to the same (terms, vals) as
the reference's whole-stream ``sparsify_reps``.

Everything runs on ``device`` (default "cuda"); asked for CUDA on a
machine without it, construction raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops.segsort_scoring import \
    sparsify_reps_device
from scaling_retriever_tpu_torch.ops.sparse_scoring import (
    make_sharded_retrieve, pad_docs, retrieve_doc_major,
)
from scaling_retriever_tpu_torch.utils.profiling import (
    profile_span, timings,
)
from scaling_retriever_tpu_torch.utils.run_accum import RunAccumulator
from scaling_retriever_tpu_torch.utils.utils import (
    depth2_pipeline, force_materialized, staged_pipeline,
)


def resolve_engine(engine: str, backend=None) -> str:
    """"auto" → "segsort" on a CUDA device, the doc-major scan ("xla") on
    the CPU. ``backend`` is a device or device type (default "cuda")."""
    if engine != "auto":
        return engine
    backend = torch.device(backend or "cuda").type
    return "xla" if backend == "cpu" else "segsort"


def _doc_major_on(index: SparseIndex, device, block: int, value_dtype,
                  n_shards: int = 1):
    """The doc-major arrays on ``device``, rows padded to a multiple of
    ``block * n_shards``, values in ``value_dtype``."""
    n_pad = -(-index.nb_docs() // (block * n_shards)) * block * n_shards
    terms, vals = index.to_doc_major(device=device, n_rows=n_pad)
    vals = vals.to(value_dtype)
    return pad_docs(terms, vals, block)


class SparseRetrieval:
    def __init__(self, model, index: SparseIndex | str,
                 out_dir: Optional[str] = None, topk: int = 1000,
                 engine: str = "auto", query_tile: int = 32,
                 block: int = 4096, mesh=None, data_axis: str = "data",
                 value_dtype=torch.bfloat16,
                 hot_postings: Optional[int] = None,
                 index_val_dtype: str = "f32", device="cuda"):
        self.model = model
        t_setup = time.perf_counter()
        self.device = mesh.device if mesh is not None else torch.device(
            device)
        sharded = mesh is not None and mesh.size > 1
        self.index = SparseIndex.load(index) if isinstance(index, str) \
            else index
        self.out_dir = out_dir
        self.topk = topk
        engine = resolve_engine(engine, self.device)
        self.engine = engine
        self.query_tile = query_tile
        self.block = block
        self.mesh = mesh
        self.data_axis = data_axis
        self.value_dtype = value_dtype
        # per-query routing (sort-based engines): a query matching more
        # than hot_postings postings goes to the doc-major scan, whose
        # cost is one index sweep per tile whatever the query; the
        # doc-major arrays are built on the first hot query
        self.hot_postings = (hot_postings if hot_postings is not None
                             else 8 * 1024 * 1024)
        self._hot_terms = None
        self._hot_vals = None
        self.hot_queries = 0
        # cost-sized tile packing cap: width * job bucket per tile
        self.job_slots = 32768
        # (width, bucket) variants already run by an earlier retrieve() on
        # this object: a warm pass has no warmup tiles
        self._seen_variants: set = set()

        if engine == "segsort":
            from scaling_retriever_tpu_torch.ops.segsort_scoring import (
                SegsortEngine, ShardedSegsortEngine,
            )

            if sharded:
                self._seg = ShardedSegsortEngine(
                    self.index, mesh.devices, topk=topk,
                    val_dtype=index_val_dtype, fetch="auto")
            else:
                self._seg = SegsortEngine(self.index, topk=topk,
                                          val_dtype=index_val_dtype,
                                          device=self.device, fetch="auto")
            self.n_docs = self.index.nb_docs()
        elif engine == "maxscore":
            from scaling_retriever_tpu_torch.ops.maxscore import \
                MaxScoreEngine

            self._seg = MaxScoreEngine(self.index, topk=topk,
                                       device=self.device)
            self.n_docs = self.index.nb_docs()
        elif engine == "bmx":
            from scaling_retriever_tpu_torch.ops.blockmax import \
                BlockMaxSegsortEngine

            self._seg = BlockMaxSegsortEngine(self.index, topk=topk,
                                              device=self.device)
            self.n_docs = self.index.nb_docs()
        elif engine == "xla":
            self.n_docs = self.index.nb_docs()
            self.terms, self.vals = _doc_major_on(
                self.index, self.device, block, value_dtype,
                mesh.size if sharded else 1)
            self._sharded_fn = None
            if sharded:
                # equal doc ranges, each a view on its own entry's device
                per = self.terms.shape[0] // mesh.size
                self.terms = [self.terms[i * per:(i + 1) * per].to(d)
                              for i, d in enumerate(mesh.devices)]
                self.vals = [self.vals[i * per:(i + 1) * per].to(d)
                             for i, d in enumerate(mesh.devices)]
                self.row_ids = [torch.arange(i * per, (i + 1) * per,
                                             device=d)
                                for i, d in enumerate(mesh.devices)]
                self._sharded_fn = make_sharded_retrieve(
                    mesh, data_axis, k=topk, block=block)
                force_materialized(*self.terms, *self.vals, *self.row_ids)
            else:
                force_materialized(self.terms, self.vals)
        elif engine == "cpp":
            from scaling_retriever_tpu_torch.index.cpp_engine import \
                CppSparseEngine

            self._cpp = CppSparseEngine(self.index)
            self.n_docs = self.index.nb_docs()
        else:
            raise ValueError(engine)
        # disk load + host prep + device upload, completed (engines
        # synchronize their uploads); q_stats reports it as setup_s
        self._setup_s = time.perf_counter() - t_setup

    # ------------------------------------------------------------------

    def _encode_queries(self, q_loader: Iterable):
        """Query batches → (qids, q_dense or None, q_sparse or None, L0_q).

        A batch carries ``q_terms``/``q_vals`` (sparse reps [bz, T],
        values descending, 0 ⇒ unused), ``rep`` (dense reps [bz, V]) or
        ``input_ids``/``attention_mask`` for ``model.encode``. For the
        sort-based engines dense reps are sparsified batch by batch where
        they live, so a Dev-size stream never gathers [nq, V] on the host;
        the doc-major scan takes them dense, as in the reference."""
        sparse_engine = self.engine in ("segsort", "maxscore", "bmx")
        T = self._seg.T if sparse_engine else 0
        qids, reps, sterms, svals = [], [], [], []
        l0 = 0.0
        kinds = set()
        for batch in q_loader:
            if "q_terms" in batch:
                kinds.add("sparse")
                sterms.append(np.asarray(batch["q_terms"], np.int32))
                svals.append(np.asarray(batch["q_vals"], np.float32))
                l0 += float((svals[-1] > 0).sum())
            else:
                kinds.add("dense")
                if "rep" in batch:
                    rep = batch["rep"]
                else:
                    rep = self.model.encode(batch["input_ids"],
                                            batch["attention_mask"])
                rep = torch.as_tensor(rep)
                l0 += float((rep != 0).sum())
                if sparse_engine:
                    t, v = sparsify_reps_device(rep.to(self.device), T)
                    sterms.append(t)
                    svals.append(v)
                else:
                    reps.append(rep.float().cpu().numpy())
            ids = batch["ids"]
            qids.extend(ids if isinstance(ids, list) else list(ids))
        if len(kinds) > 1:
            raise ValueError("mixed dense/sparse query batches")
        l0_q = l0 / len(qids) if qids else 0.0
        if sterms:
            tmax = max(t.shape[1] for t in sterms)
            q_terms = np.concatenate(
                [np.pad(t, ((0, 0), (0, tmax - t.shape[1]))) for t in sterms])
            q_vals = np.concatenate(
                [np.pad(v, ((0, 0), (0, tmax - v.shape[1]))) for v in svals])
            return qids, None, (q_terms, q_vals), l0_q
        q_dense = (np.concatenate(reps, 0) if reps
                   else np.zeros((0, self.index.dim), np.float32))
        return qids, q_dense, None, l0_q

    def _densify(self, q_sparse, rows_sel=None) -> np.ndarray:
        """Sparse (terms, vals) → dense [m, V] on the host. Duplicate term
        ids add up (``np.add.at``), as they do in the sort-based engines.
        ``rows_sel`` restricts to a subset."""
        terms, vals = q_sparse
        if rows_sel is not None:
            terms, vals = terms[rows_sel], vals[rows_sel]
        m = terms.shape[0]
        out = np.zeros((m, self.index.dim), np.float32)
        rr = np.repeat(np.arange(m), terms.shape[1])
        tt, vv = terms.ravel(), vals.ravel()
        keep = vv > 0
        np.add.at(out, (rr[keep], tt[keep]), vv[keep])
        return out

    def _ensure_doc_major(self):
        """The doc-major arrays for hot-query routing, built on the first
        hot query (about N * K * 6 bytes at bf16 values)."""
        if self._hot_terms is None:
            self._hot_terms, self._hot_vals = _doc_major_on(
                self.index, self.device, self.block, self.value_dtype)
            force_materialized(self._hot_terms, self._hot_vals)
        return self._hot_terms, self._hot_vals

    def _doc_major_tile(self, terms, vals, q_tile: np.ndarray, topk: int):
        q_t = torch.from_numpy(np.ascontiguousarray(q_tile.T)).to(
            self.device)
        scores, rows = retrieve_doc_major(terms, vals, q_t,
                                          k=min(topk, self.n_docs),
                                          block=self.block)
        return scores.cpu().numpy(), rows.cpu().numpy()

    def _retrieve_hot(self, hot_idx: np.ndarray, q_dense, q_sparse,
                      topk: int, acc: RunAccumulator) -> None:
        """The doc-major scan for queries whose matched postings exceed
        ``hot_postings``: one full-index sweep per tile, so a hot stream's
        cost is bounded by design. Exact, like every engine."""
        self.hot_queries += int(hot_idx.size)
        terms_d, vals_d = self._ensure_doc_major()
        tile = self.query_tile
        for start in range(0, hot_idx.size, tile):
            sel = hot_idx[start:start + tile]
            q_tile = (q_dense[sel] if q_dense is not None
                      else self._densify(q_sparse, rows_sel=sel))
            pad = tile - q_tile.shape[0]
            if pad:
                q_tile = np.pad(q_tile, ((0, pad), (0, 0)))
            with profile_span("hot_doc_major_tile"):
                scores, rows = self._doc_major_tile(terms_d, vals_d, q_tile,
                                                    topk)
            acc.add_tile(sel, rows[:len(sel)], scores[:len(sel)])

    def _pack_tiles(self, order: np.ndarray, q_terms_all, q_vals_all,
                    tile: int) -> list:
        """Cost-sized tile schedule [(start, end, width, bucket), ...] over
        the cost-sorted stream (bucket None off the DMA path): the widest
        width (halving from ``tile`` down to 16) whose width * job bucket
        fits ``job_slots``, on the engine's {2^k, 1.5*2^k} bucket grid."""
        if (self.engine != "segsort"
                or not hasattr(self._seg, "job_need")
                or getattr(self._seg, "fetch", None) != "dma"
                or not len(order)):
            return [(s, min(s + tile, len(order)), tile, None)
                    for s in range(0, len(order), tile)]
        from scaling_retriever_tpu_torch.ops.segsort_scoring import \
            bucket_jobs

        need_sorted = self._seg.job_need(q_terms_all[order], q_vals_all[order])
        widths = [tile]
        while widths[-1] > 16:
            widths.append(widths[-1] // 2)
        sched = []
        s0 = 0
        while s0 < len(order):
            for width in widths:
                hi = min(s0 + width, len(order))
                bucket = bucket_jobs(int(need_sorted[s0:hi].max()))
                if width * bucket <= self.job_slots or width == widths[-1]:
                    sched.append((s0, hi, width, bucket))
                    s0 = hi
                    break
        return sched

    def retrieve(self, q_loader: Iterable, topk: Optional[int] = None,
                 threshold: float = 0.0, return_run: bool = True,
                 write_run: bool = True) -> tuple[dict, dict]:
        """Run retrieval; writes run.json + q_stats.json when out_dir is
        set. The tile drains only mask arrays (RunAccumulator); the run
        dict is built after the pipeline. ``write_run=False`` skips both
        the run-dict build and the run.json dump."""
        topk = topk or self.topk
        t0 = time.perf_counter()
        with profile_span("query_encode"):
            qids, q_dense, q_sparse, l0_q = self._encode_queries(q_loader)
        t_enc = time.perf_counter()
        nq = len(qids)
        stats = {"L0_q": l0_q}

        acc = RunAccumulator(qids, self.index.doc_ids, self.n_docs,
                             threshold=threshold)
        if self.engine in ("segsort", "maxscore", "bmx"):
            tile = self.query_tile
            # cost-sorted scheduling: tiles of similar cost keep each
            # tile's job bucket near its members' need (results are exact
            # per query, keyed by qid)
            order = np.arange(nq)
            hot_idx = np.zeros(0, np.int64)
            host_lens = getattr(self._seg, "_host_lens", None)
            if nq and host_lens is not None:
                q_terms, q_vals = q_sparse
                cost = (host_lens[q_terms] * (q_vals > 0)).sum(axis=1)
                if self.engine in ("segsort", "bmx"):
                    hot = cost > self.hot_postings
                    hot_idx = np.nonzero(hot)[0]
                    normal_idx = np.nonzero(~hot)[0]
                else:
                    normal_idx = order
                order = normal_idx[np.argsort(cost[normal_idx],
                                              kind="stable")]
            if self.engine == "maxscore" and nq:
                # every tile's pruned pass first, then the uncertified
                # queries of all tiles together through the exhaustive scan
                q_dense = self._densify(q_sparse)
                with profile_span("maxscore_retrieve_batch"):
                    scores, rows = self._seg.retrieve_batch(
                        q_dense[order], topk, tile=tile)
                acc.add_tile(order, rows, scores)
            else:
                q_terms_all, q_vals_all = q_sparse if q_sparse else (None,
                                                                     None)
                sched = self._pack_tiles(order, q_terms_all, q_vals_all, tile)

                def _dispatch(item):
                    s0, hi, width = item[0], item[1], item[2]
                    sel = order[s0:hi]
                    qt, qv = q_terms_all[sel], q_vals_all[sel]
                    pad = width - qt.shape[0]
                    if pad:
                        qt = np.pad(qt, ((0, pad), (0, 0)))
                        qv = np.pad(qv, ((0, pad), (0, 0)))
                    with profile_span(f"{self.engine}_dispatch_tile"):
                        return sel, self._seg.retrieve_tile_async(
                            None, topk, sparsified=(qt, qv))

                def _drain(pending):
                    sel, payload = pending
                    with profile_span(f"{self.engine}_drain_tile"):
                        scores, rows = self._seg.finalize(payload)
                    acc.add_tile(sel, rows[:len(sel)], scores[:len(sel)])

                # warmup: the first tile of each (width, bucket) variant
                # runs alone before the pipeline (kernel builds, library
                # workspaces, allocator growth land there); its results
                # are kept, and steady_qps covers the other tiles
                t_w = time.perf_counter()
                seen_variants = self._seen_variants
                warm, steady = [], []
                for item in sched:
                    key = (item[2], item[3])
                    if key in seen_variants:
                        steady.append(item)
                    else:
                        seen_variants.add(key)
                        warm.append(item)
                n_warm_q = sum(hi - s0 for s0, hi, _, _ in warm)
                for item in warm:
                    with profile_span("warmup_compile"):
                        _drain(_dispatch(item))
                stats["warmup_s"] = round(time.perf_counter() - t_w, 4)
                stats["warmup_tiles"] = len(warm)
                t_s = time.perf_counter()
                if hasattr(self._seg, "continue_async"):
                    # two-pass engine (bmx): pass 2 gets its own stage
                    staged_pipeline(
                        steady, _dispatch,
                        lambda p: (p[0], self._seg.continue_async(p[1])),
                        _drain)
                else:
                    depth2_pipeline(steady, _dispatch, _drain)
                steady_s = time.perf_counter() - t_s
                stats["steady_s"] = round(steady_s, 4)
                stats["steady_qps"] = (round(
                    (nq - n_warm_q - hot_idx.size) / max(steady_s, 1e-9), 2)
                    if steady else None)

                if hot_idx.size:
                    self._retrieve_hot(hot_idx, q_dense, q_sparse, topk, acc)
                stats["hot_queries"] = int(hot_idx.size)
        elif self.engine == "cpp":
            if q_dense is None:
                q_dense = self._densify(q_sparse)
            rows_k, scores_k = self._cpp.retrieve(q_dense, topk, threshold)
            # the C++ engine applied the threshold itself and pads with -1
            acc.add_tile(np.arange(nq), rows_k, scores_k, valid=rows_k >= 0)
        else:
            tile = self.query_tile
            if q_dense is None:
                q_dense = self._densify(q_sparse)
            for start in range(0, nq, tile):
                q_tile = q_dense[start:start + tile]
                pad = tile - q_tile.shape[0]
                if pad:
                    q_tile = np.pad(q_tile, ((0, pad), (0, 0)))
                with profile_span("doc_major_retrieve_tile"):
                    if self._sharded_fn is not None:
                        q_t = torch.from_numpy(np.ascontiguousarray(
                            q_tile.T)).to(self.device)
                        s, r = self._sharded_fn(self.terms, self.vals,
                                                self.row_ids, q_t)
                        scores, rows = s.cpu().numpy(), r.cpu().numpy()
                    else:
                        scores, rows = self._doc_major_tile(
                            self.terms, self.vals, q_tile, topk)
                n_real = min(tile, nq - start)
                acc.add_tile(np.arange(start, start + n_real),
                             rows[:n_real], scores[:n_real])

        t_ret = time.perf_counter()
        stats["setup_s"] = round(self._setup_s, 4)
        stats["encode_s"] = round(t_enc - t0, 4)
        stats["retrieval_s"] = round(t_ret - t_enc, 4)
        stats["retrieval_qps"] = round(nq / max(t_ret - t_enc, 1e-9), 2)
        stats["spans"] = {k: {"count": v["count"],
                              "total_s": round(v["total_sec"], 3),
                              "max_s": round(v["max_sec"], 3)}
                          for k, v in timings().items()}
        res = None
        if (self.out_dir and write_run) or return_run:
            with profile_span("run_dict_build"):
                res = acc.to_run()
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            if write_run:
                with open(os.path.join(self.out_dir, "run.json"), "w") as f:
                    json.dump(res, f)
            with open(os.path.join(self.out_dir, "q_stats.json"), "w") as f:
                json.dump(stats, f)
        return (res, stats) if return_run else ({}, stats)
