"""Exact inner-product dense index (port of index/dense_index.py).

Flat inner-product search is a matrix product per doc chunk followed by a
running top-k merge:

    scores = Q @ D^T  (f32 out), chunk by chunk over the docs.

``_search_chunked_blocked`` selects the top ``m`` of every ``block`` docs of
a chunk's score slab first (kernel B5, ``ops/topm.block_topm``, on a CUDA
device) and merges only those, with a per-query certificate;
``_search_chunked`` is the always-exact direct path. The products are
library calls, as the reference leaves them to XLA: an f32-output product
for f32 and bf16 docs (``torch.mm(..., out_dtype=torch.float32)`` for bf16
on the card; the CPU widens to f32, exact for the products), and the exact
s32 dot over int8 codes (``torch._int_mm``). f32 products assume PyTorch's
default ``torch.backends.cuda.matmul.allow_tf32 = False``.

``DenseFlatIndexer`` keeps the vectors as they were added (f32, or bf16 when
a bf16 tensor is added) in a store of ``[chunk, D]`` chunks, filled in
place; the padding to a chunk multiple is the zero tail of the last chunk.
The store lives on the index's device when the rows come as tensors there;
otherwise (numpy input, as ``deserialize`` and eval_dense give, or CPU
tensors) it stays on the host, as the reference keeps its f32 batches, and
full chunks of an added host array are kept without a copy. The search
layout lives on the device: the store itself when it is there in the
layout's dtype, else a cast (bf16) or int8 quantization of it built chunk
by chunk, ``MOVE_ROWS`` rows at a time (host rows through two pinned
buffers, one filled while the other is copied), and rebuilt after an add
or a change of ``dtype`` / ``quantize``. So for file-based input the card
holds the layout only and the host the f32 store. ``serialize`` writes the
f32 widening of the store, so an ``index_srt.npz`` and
``index_meta_srt.json`` written by either package load in the other.

``make_sharded_dense_search`` is the doc-sharded search over a mesh: the
direct search per shard, the shards' top-k merged on the mesh's first
device.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from scaling_retriever_tpu_torch.ops.sparse_scoring import merge_shards
from scaling_retriever_tpu_torch.ops.topm import block_topm
from scaling_retriever_tpu_torch.utils.utils import (
    depth2_pipeline, force_materialized,
)

# rows moved to the device, cast or quantized per step when the layout is
# built from the store: the f32 temporaries stay near 0.3 GB at D = 2048
MOVE_ROWS = 32768


def _quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (codes int8, scales f32). ``torch.round``
    rounds half to even, as ``np.rint`` does. The scale's divisor is a
    tensor: CUDA multiplies by the reciprocal of a Python scalar divisor,
    which can differ from the true quotient in the last bit."""
    v = v.float()
    amax = v.abs().amax(dim=1)
    scales = amax / torch.full_like(amax, 127.0)
    scales = torch.where(scales > 0, scales, 1.0)
    return torch.round(v / scales[:, None]).to(torch.int8), scales


def quantize_embeddings_int8(vectors):
    """Per-doc symmetric int8 quantization: codes = round(v / s), s =
    max|v| / 127; zero rows get scale 1 (all-zero codes). Returns (codes int8
    [N, D], scales f32 [N]): numpy for numpy input, tensors on the input's
    device for a tensor, bit-identical to the reference's."""
    if isinstance(vectors, torch.Tensor):
        return _quantize_rows(vectors)
    codes, scales = _quantize_rows(
        torch.from_numpy(np.asarray(vectors, np.float32)))
    return codes.numpy(), scales.numpy()


def _quantize_queries_int8(q):
    """Per-query symmetric int8: (codes int8 [nq, D], scales f32 [nq])."""
    return quantize_embeddings_int8(q)


def _int_mm_rows(nq: int) -> int:
    """Rows ``torch._int_mm`` takes on CUDA for ``nq`` queries: more than
    16, a multiple of 8."""
    return max(24, -(-nq // 8) * 8)


def _score_slab(queries: torch.Tensor, blk: torch.Tensor, q_scale,
                blk_scales) -> torch.Tensor:
    """[nq, chunk] f32 score slab for one doc chunk. f32/bf16 docs: one
    product with f32 output. int8 docs (scales present): the exact s32 dot
    over the codes (|dot| <= 127 * 127 * D < 2^25 at D = 2048, so the f32
    cast is exact), times the outer product of the scales, in the
    reference's order of operations. A query tile the int8 product does not
    take is padded with zero-code rows, sliced off again."""
    if blk_scales is None:
        if queries.dtype == torch.float32:
            return queries @ blk.T
        if queries.device.type == "cuda":
            return torch.mm(queries, blk.T, out_dtype=torch.float32)
        return queries.float() @ blk.float().T
    nq = queries.shape[0]
    rows = _int_mm_rows(nq)
    q = queries
    if rows != nq:
        q = torch.cat([q, q.new_zeros(rows - nq, q.shape[1])])
    s = torch._int_mm(q, blk.T)[:nq]
    return s.float() * (q_scale[:, None] * blk_scales[None, :])


def _chunks(docs, chunk: int, doc_scales):
    """docs as [N, D] (N a multiple of chunk) or as a list of [chunk, D]
    chunks → (chunks, scale chunks or None)."""
    if isinstance(docs, torch.Tensor):
        if docs.shape[0] % chunk:
            raise ValueError(f"{docs.shape[0]} docs is not a multiple of the "
                             f"chunk {chunk}")
        return (docs.split(chunk),
                None if doc_scales is None else doc_scales.split(chunk))
    return list(docs), None if doc_scales is None else list(doc_scales)


def _select(s: torch.Tensor, m: int, block: int, topm: str):
    """Per-block top-m of the slab: "pallas" (and "pallas_interpret", the
    reference's interpreted kernel) = ``block_topm``: kernel B5 on a CUDA
    tensor, its plain version on a CPU one; "xla" = ``torch.topk`` over the
    reshaped slab."""
    if topm in ("pallas", "pallas_interpret"):
        return block_topm(s, m, block, site="topm_dense")
    if topm == "xla":
        return torch.topk(s.view(s.shape[0], -1, block), m, dim=2)
    raise ValueError(f"topm {topm!r}: xla, pallas or pallas_interpret")


def _search_chunked_blocked(docs, queries: torch.Tensor, k: int,
                            chunk: int = 262144, m: int = 32,
                            block: int = 4096, topm: str = "xla",
                            doc_scales=None, q_scale=None):
    """Exact-when-certified IP top-k with block-local selection: the top
    ``m`` of each ``block`` docs per chunk, then a top-k merge. Exact
    whenever no block's m-th kept value reaches the merged k-th value: the
    per-query certificate ``ok`` compares the largest dropped-candidate
    bound with the FINAL k-th score. Callers must rerun uncertified rows on
    ``_search_chunked`` (DenseFlatIndexer does).

    Returns (scores f32 [nq, k], rows int32 [nq, k], ok bool [nq])."""
    chunks, scale_chunks = _chunks(docs, chunk, doc_scales)
    nq = queries.shape[0]
    nblk = chunk // block
    dev = queries.device
    top_s = torch.full((nq, k), float("-inf"), device=dev)
    top_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    max_bm = torch.full((nq,), float("-inf"), device=dev)
    base = torch.arange(nblk, device=dev)[None, :, None] * block
    for c, blk in enumerate(chunks):
        s = _score_slab(queries, blk, q_scale,
                        None if scale_chunks is None else scale_chunks[c])
        bv, bi = _select(s, m, block, topm)              # [nq, nblk, m]
        del s
        gi = bi.long() + (base + c * chunk)
        cat_s = torch.cat([top_s, bv.reshape(nq, nblk * m)], dim=1)
        cat_i = torch.cat([top_i, gi.reshape(nq, nblk * m)], dim=1)
        top_s, sel = torch.topk(cat_s, k, dim=1)
        top_i = cat_i.gather(1, sel)
        max_bm = torch.maximum(max_bm, bv[:, :, m - 1].amax(dim=1))
    ok = max_bm < top_s[:, k - 1]
    return top_s, top_i.to(torch.int32), ok


def _search_chunked(docs, queries: torch.Tensor, k: int,
                    chunk: int = 262144, doc_scales=None, q_scale=None):
    """Exact IP top-k: docs [N, D] (N a multiple of chunk) or its chunks,
    queries [nq, D]. With ``doc_scales``/``q_scale`` (int8 layout) the slab
    is the exact s32 dot over the codes, scale-folded in f32. The merge
    takes the top k of [running top-k | the chunk's slab], as the
    reference does, without materializing the slab's row ids. Returns
    (scores f32 [nq, k], rows int32 [nq, k])."""
    chunks, scale_chunks = _chunks(docs, chunk, doc_scales)
    nq = queries.shape[0]
    dev = queries.device
    top_s = torch.full((nq, k), float("-inf"), device=dev)
    top_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    for c, blk in enumerate(chunks):
        s = _score_slab(queries, blk, q_scale,
                        None if scale_chunks is None else scale_chunks[c])
        top_s, sel = torch.topk(torch.cat([top_s, s], dim=1), k, dim=1)
        del s
        top_i = torch.where(sel < k, top_i.gather(1, sel.clamp(max=k - 1)),
                            sel - k + c * chunk)
    return top_s, top_i.to(torch.int32)


def make_sharded_dense_search(mesh, axis: str, k: int, chunk: int = 262144,
                              quantize: Optional[str] = None):
    """Doc-sharded exact IP search over ``mesh``: each shard runs the
    direct ``_search_chunked`` over its rows on its device, maps its rows
    to global ones (rows < 0 stay -1), and the shards' top-k merge on
    ``mesh.device`` (``merge_shards``: stable, ties to the lower shard).

    Returns fn(docs_shards, row_ids_shards, queries) → (scores [nq, k],
    global rows [nq, k]); with ``quantize="int8"`` fn(code_shards,
    row_ids_shards, scale_shards, queries, q_scale), queries being the
    int8 query codes. Where the reference takes arrays sharded over
    ``axis``, this takes one entry per mesh entry, in mesh order: a shard's
    docs are [N_s, D] (N_s a multiple of chunk; pad rows zero, their row
    ids -1) or a list of its [chunk, D] chunks, on its device."""
    del axis                                 # the shards are the lists

    def _merge(scores, rows, row_ids):
        out_s, out_r = [], []
        for s, r, ids in zip(scores, rows, row_ids):
            out_s.append(s)
            out_r.append(torch.where(r >= 0, ids[r.clamp(min=0).long()],
                                     -1))
        return merge_shards(out_s, out_r, k, mesh.device)

    def _device(docs):
        return (docs if isinstance(docs, torch.Tensor) else docs[0]).device

    if quantize == "int8":
        def fn8(code_shards, row_id_shards, scale_shards, queries, q_scale):
            res = [_search_chunked(docs, queries.to(_device(docs)), k=k,
                                   chunk=chunk, doc_scales=scales,
                                   q_scale=q_scale.to(_device(docs)))
                   for docs, scales in zip(code_shards, scale_shards)]
            return _merge([s for s, _ in res], [r for _, r in res],
                          row_id_shards)

        return fn8

    def fn(doc_shards, row_id_shards, queries):
        res = [_search_chunked(docs, queries.to(_device(docs)), k=k,
                               chunk=chunk) for docs in doc_shards]
        return _merge([s for s, _ in res], [r for _, r in res],
                      row_id_shards)

    return fn


class DenseIndexer:
    """Abstract surface matching the reference DenseIndexer."""

    def __init__(self, buffer_size: int = 50000):
        self.buffer_size = buffer_size
        self.index_id_to_db_id: List = []

    def init_index(self, vector_sz: int):
        raise NotImplementedError

    def index_data(self, data: List[Tuple[object, np.ndarray]]):
        raise NotImplementedError

    def search_knn(self, query_vectors: np.ndarray, top_docs: int):
        raise NotImplementedError

    def _update_id_mapping(self, db_ids: List) -> int:
        self.index_id_to_db_id.extend(db_ids)
        self._id_map_np = None
        return len(self.index_id_to_db_id)

    @property
    def _id_map(self) -> np.ndarray:
        # cached object array: search_knn runs once per serving micro-batch
        if getattr(self, "_id_map_np", None) is None:
            self._id_map_np = np.asarray(self.index_id_to_db_id, dtype=object)
        return self._id_map_np


class DenseFlatIndexer(DenseIndexer):
    """Exact IP flat index, a drop-in for the reference's faiss version.

    ``selection="auto"`` takes the certified block-local selection when the
    chunk tiles into ``sel_block`` blocks holding >= k candidates, with an
    exact rerun of any tile whose real rows fail the certificate
    (``fallbacks`` counts them); ``"direct"`` is the plain per-chunk top-k.
    ``topm`` picks the per-block selection: "auto" = kernel B5 on a CUDA
    device for blocks that are a multiple of 128 and m <= 128, else
    ``torch.topk``; "xla" or "pallas" force one (see ``_select``).
    ``quantize="int8"``: per-doc symmetric int8 codes + f32 scales, exact
    over the codes; a layout choice, ``serialize`` still writes f32.
    ``device``: where the layout and the search live (default "cuda"); the
    store is there too for rows added as tensors on it, else on the host."""

    INDEX_FILE = "index_srt.npz"
    META_FILE = "index_meta_srt.json"

    def __init__(self, buffer_size: int = 50000, dtype=torch.bfloat16,
                 chunk: int = 262144, query_tile: int = 256,
                 selection: str = "auto", block_m: int = 32,
                 sel_block: int = 4096, topm: str = "auto",
                 quantize: Optional[str] = None, device="cuda"):
        super().__init__(buffer_size)
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize {quantize!r}: None or 'int8'")
        self.device = torch.device(device)
        self.vector_sz: Optional[int] = None
        self.dtype = dtype
        self.chunk = chunk
        # queries are scored in fixed tiles: one [nq, chunk] f32 slab per
        # tile bounds the temporaries (7+ GB at 6,980 queries untiled)
        self.query_tile = query_tile
        self.selection = selection
        self.block_m = block_m
        self.sel_block = sel_block
        self.topm = topm
        self.quantize = quantize
        self.fallbacks = 0
        self._store: List[torch.Tensor] = []
        self._n = 0
        # (layout key, doc chunks, scale chunks or None)
        self._layout = None

    def init_index(self, vector_sz: int):
        self.vector_sz = vector_sz
        self._store = []
        self._n = 0
        self.index_id_to_db_id = []
        self._id_map_np = None
        self._layout = None

    @property
    def ntotal(self) -> int:
        return self._n

    def _append(self, vectors) -> None:
        """Write rows (numpy → f32; a tensor keeps f32 or bf16) into the
        chunk store, allocating zeroed chunks as it fills. The store's
        first rows place it: on ``self.device`` if they are a tensor there,
        else on the host. A full chunk of rows already where the store is
        is kept as a view, not copied, as the reference keeps the arrays it
        is given."""
        if not isinstance(vectors, torch.Tensor):
            vectors = np.asarray(vectors, np.float32)
        v = torch.as_tensor(vectors)
        if v.dtype not in (torch.float32, torch.bfloat16):
            v = v.float()
        if v.dim() != 2:
            raise ValueError(f"vectors must be [n, D], got {tuple(v.shape)}")
        if self.vector_sz is None:
            self.vector_sz = v.shape[1]
        if v.shape[1] != self.vector_sz:
            raise ValueError(f"vectors of width {v.shape[1]} added to an "
                             f"index of width {self.vector_sz}")
        if self._store and self._store[0].dtype != v.dtype:
            raise ValueError(f"{v.dtype} vectors added to a store of "
                             f"{self._store[0].dtype}")
        self._layout = None
        if self._store:
            where = self._store[0].device
        else:
            where = (v.device if v.device.type == self.device.type
                     else torch.device("cpu"))
        v = v.contiguous()
        pos = 0
        while pos < v.shape[0]:
            c, r = divmod(self._n, self.chunk)
            take = min(self.chunk - r, v.shape[0] - pos)
            if c == len(self._store):
                if take == self.chunk and v.device == where:
                    self._store.append(v[pos:pos + take])
                    pos += take
                    self._n += take
                    continue
                self._store.append(torch.zeros(self.chunk, self.vector_sz,
                                               dtype=v.dtype, device=where))
            self._store[c][r:r + take].copy_(v[pos:pos + take])
            pos += take
            self._n += take

    def index_data(self, data: Sequence[Tuple[object, np.ndarray]]):
        """Buffered add of (db_id, vector) pairs."""
        for i in range(0, len(data), self.buffer_size):
            part = data[i:i + self.buffer_size]
            db_ids = [t[0] for t in part]
            self._append(np.stack([np.reshape(t[1], -1) for t in part])
                         .astype(np.float32))
            self._update_id_mapping(db_ids)

    def add_batch(self, db_ids: Sequence, vectors):
        """Add rows: ``vectors`` is a numpy array (stored f32) or a tensor
        on any device (f32 or bf16 kept, copied into the store)."""
        db_ids = list(db_ids)
        if len(db_ids) != len(vectors):
            raise ValueError(f"{len(db_ids)} ids for {len(vectors)} vectors")
        self._append(vectors)
        self._update_id_mapping(db_ids)

    def _materialize(self) -> List[torch.Tensor]:
        """The search layout's doc chunks on ``self.device`` (built once per
        store state and layout choice; the scale chunks of the int8 layout
        are ``self._layout[2]``). A store chunk that is already on the
        device in the layout's dtype is used as it is; any other is moved
        (from the host through pinned buffers), cast or quantized
        ``MOVE_ROWS`` rows at a time."""
        key = (self.quantize, self.dtype)
        if self._layout is None or self._layout[0] != key:
            self._layout = None
            store = self._store or [torch.zeros(
                self.chunk, self.vector_sz or 0, device=self.device)]
            int8 = self.quantize == "int8"
            docs, scales = [], [] if int8 else None
            # host rows reach the card through two pinned buffers in turn:
            # one is filled while the other's copy runs
            stage = [None, None]
            for blk in store:
                if (not int8 and blk.dtype == self.dtype
                        and blk.device.type == self.device.type):
                    docs.append(blk)
                    continue
                out = torch.empty(blk.shape, device=self.device,
                                  dtype=torch.int8 if int8 else self.dtype)
                sc = (torch.empty(blk.shape[0], device=self.device) if int8
                      else None)
                for r0 in range(0, blk.shape[0], MOVE_ROWS):
                    part = blk[r0:r0 + MOVE_ROWS]
                    if (self.device.type == "cuda"
                            and part.device.type == "cpu"):
                        part = self._stage(stage, part)
                    part = part.to(self.device)
                    if int8:
                        out[r0:r0 + MOVE_ROWS], sc[r0:r0 + MOVE_ROWS] = \
                            _quantize_rows(part)
                    else:
                        out[r0:r0 + MOVE_ROWS] = part
                docs.append(out)
                if int8:
                    scales.append(sc)
            force_materialized(*docs)
            self._layout = (key, docs, scales)
        return self._layout[1]

    def _stage(self, stage: list, rows: torch.Tensor) -> torch.Tensor:
        """Host ``rows`` to the card through the pinned buffer of ``stage``
        (two entries, (buffer, event) or None, the older copy first): wait
        for that buffer's last copy, fill it, queue its copy without
        blocking. Returns the rows on the card."""
        entry = stage.pop(0)
        if entry is None:
            buf = torch.empty(min(MOVE_ROWS, self.chunk), rows.shape[1],
                              dtype=rows.dtype, pin_memory=True)
        else:
            buf, done = entry
            done.synchronize()
        view = buf[:rows.shape[0]]
        view.copy_(rows)
        on_card = view.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        stage.append((buf, done))
        return on_card

    def _blocked(self, k: int) -> bool:
        # certified block-local selection only when the chunk tiles cleanly
        # and can hold >= k candidates per chunk
        return (self.selection == "auto"
                and self.chunk % self.sel_block == 0
                and (self.chunk // self.sel_block) * self.block_m >= k)

    def _topm(self) -> str:
        if self.topm != "auto":
            return self.topm
        return ("pallas" if self.device.type == "cuda"
                and self.sel_block % 128 == 0 and self.block_m <= 128
                else "xla")

    def dispatch_tile(self, q_tile, k: int):
        """Asynchronous dispatch of one query tile (numpy or a tensor):
        the device work is queued, nothing is read back. Returns a handle
        for ``drain_tile``."""
        docs = self._materialize()
        doc_scales = self._layout[2]
        blocked = self._blocked(k)
        q = torch.as_tensor(q_tile).to(self.device, torch.float32)
        if self.quantize == "int8":
            q_dev, qs_dev = _quantize_queries_int8(q)
        else:
            q_dev, qs_dev = q.to(self.dtype), None
        if blocked:
            scores, rows, ok = _search_chunked_blocked(
                docs, q_dev, k=k, chunk=self.chunk, m=self.block_m,
                block=self.sel_block, topm=self._topm(),
                doc_scales=doc_scales, q_scale=qs_dev)
            # the certificate rides the scores' read: one transfer per tile
            payload = (torch.cat([scores, ok[:, None].float()], dim=1), rows)
        else:
            payload = _search_chunked(docs, q_dev, k=k, chunk=self.chunk,
                                      doc_scales=doc_scales, q_scale=qs_dev)
        return blocked, payload, q_dev, qs_dev, k

    def drain_tile(self, handle, n_real: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Read a ``dispatch_tile`` handle → (scores f32 [n, k], rows i32
        [n, k]) with the certificate honored: if a real row is uncertified,
        the tile reruns on the always-exact direct path. Padded rows do not
        count (a zero query row always fails: tau = max_bm = 0)."""
        blocked, payload, q_dev, qs_dev, k = handle
        if blocked:
            packed = payload[0].cpu().numpy()
            scores_np, ok = packed[:, :-1], packed[:, -1] > 0.5
            if not bool(ok[:n_real].all()):
                self.fallbacks += 1
                scores, rows = _search_chunked(
                    self._materialize(), q_dev, k=k, chunk=self.chunk,
                    doc_scales=self._layout[2], q_scale=qs_dev)
                return scores.cpu().numpy(), rows.cpu().numpy()
            return scores_np, payload[1].cpu().numpy()
        scores, rows = payload
        return scores.cpu().numpy(), rows.cpu().numpy()

    def tile_results(self, scores: np.ndarray, rows: np.ndarray,
                     n_real: int) -> List[Tuple[List, List[float]]]:
        """(scores, rows) → [(db_ids, scores), ...] for the real rows."""
        id_map = self._id_map
        out: List[Tuple[List, List[float]]] = []
        for qi in range(n_real):
            valid = (rows[qi] >= 0) & (rows[qi] < self._n)
            out.append((id_map[rows[qi][valid]].tolist(),
                        scores[qi][valid].tolist()))
        return out

    def search_knn(self, query_vectors, top_docs: int
                   ) -> List[Tuple[List, List[float]]]:
        """[(db_ids, scores), ...] per query. Query tiles run in a
        dispatch-ahead pipeline (tile i+1 queued before tile i is read);
        the id mapping runs once after it."""
        if self._n == 0:
            raise ValueError("index is empty")
        self._materialize()
        q_all = torch.as_tensor(query_vectors, dtype=torch.float32)
        nq = q_all.shape[0]
        k = min(top_docs, self._n)
        tile = self.query_tile
        tiles: List[Tuple[np.ndarray, np.ndarray, int]] = []

        def _dispatch(start):
            q_tile = q_all[start:start + tile]
            n_real = q_tile.shape[0]
            if nq > tile and n_real < tile:
                q_tile = torch.cat([q_tile, q_tile.new_zeros(
                    tile - n_real, q_tile.shape[1])])
            return self.dispatch_tile(q_tile, k), n_real

        def _drain(pending):
            handle, n_real = pending
            tiles.append((*self.drain_tile(handle, n_real), n_real))

        depth2_pipeline(range(0, nq, tile), _dispatch, _drain)
        out: List[Tuple[List, List[float]]] = []
        for scores, rows, n_real in tiles:
            out.extend(self.tile_results(scores, rows, n_real))
        return out

    def _host_chunks(self, dtype=np.float32):
        """The added vectors on the host as ``dtype``, one store chunk at
        a time (an f32 host chunk comes out as the stored array itself)."""
        for c, blk in enumerate(self._store):
            rows = blk[:max(0, min(self.chunk, self._n - c * self.chunk))]
            yield rows.float().cpu().numpy().astype(dtype, copy=False)

    def _host_vectors(self) -> np.ndarray:
        """The added vectors, widened to f32, on the host: [n, D]."""
        parts = list(self._host_chunks())
        return (np.concatenate(parts) if parts
                else np.zeros((0, self.vector_sz or 0), np.float32))

    def serialize(self, index_dir: str, store_dtype=np.float32):
        """Persist the vectors (f32 by default, the f32 widening of what was
        added) and the row → db id list, in the reference's files: an
        ``np.savez`` archive with members ``vectors`` [n, D] and
        ``vector_sz``. The ``vectors`` member is streamed into the archive
        chunk by chunk (an npy header, then each chunk's bytes), so the
        host never holds a second copy of the store."""
        os.makedirs(index_dir, exist_ok=True)
        dtype = np.dtype(store_dtype)
        dim = self.vector_sz or 0
        header = {"descr": np.lib.format.dtype_to_descr(dtype),
                  "fortran_order": False, "shape": (self._n, dim)}
        with zipfile.ZipFile(os.path.join(index_dir, self.INDEX_FILE), "w",
                             zipfile.ZIP_STORED, allowZip64=True) as zf:
            with zf.open("vectors.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                for part in self._host_chunks(dtype):
                    f.write(np.ascontiguousarray(part).data)
                    del part  # one chunk's host copy at a time
            with zf.open("vector_sz.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asarray(np.int64(dim)))
        with open(os.path.join(index_dir, self.META_FILE), "w") as f:
            json.dump(self.index_id_to_db_id, f)

    def deserialize(self, index_dir: str):
        data = np.load(os.path.join(index_dir, self.INDEX_FILE))
        self.init_index(int(data["vector_sz"]))
        # no second host copy: the store keeps the loaded array's chunks
        vectors = np.asarray(data["vectors"], np.float32)
        with open(os.path.join(index_dir, self.META_FILE)) as f:
            ids = json.load(f)
        if len(ids):
            self.add_batch(ids, vectors)
        if self._n != len(self.index_id_to_db_id):
            raise ValueError("deserialized index size mismatch")
