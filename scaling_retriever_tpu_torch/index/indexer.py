"""Corpus indexing (port of index/indexer.py): the sparse index
build (``SparseIndexer``) and the dense embedding writer (``store_embs``
and the ``plan.json`` reader).

Batches come from any iterable yielding ``{"input_ids", "attention_mask",
"ids"}`` (the collator convention). The artifacts are the reference's,
byte for byte: the sparse index's files (``SparseIndex.save``), and
``embs_{rank}_{chunk}.npy`` (f32, or f16 with ``use_fp16``),
``ids_{rank}_{chunk}.npy`` (a pickled object array) and a ``plan.json``
manifest. Sharded builds keep the interleaved global rows
``g = local * world_size + rank``, so shard indexes merge by
concatenation (``inverted_index.merge_indexes``).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.utils.profiling import profile_span
from scaling_retriever_tpu_torch.utils.utils import depth2_pipeline


def _pack_sparse_topk(reps: torch.Tensor, t: int) -> torch.Tensor:
    """[bz, V] reps → ONE [bz, 2t+1] f32 buffer on their device: each
    row's top-t term ids (exact f32 integers below 2^24), their values,
    and the row's true nonzero count. The host reads bz*(2t+1)*4 bytes in
    place of bz*V*4 (0.5 MB against 32.8 MB at bz 64, t 1024 and the
    128,256 vocab); the count column shows when a row holds more than t
    nonzeros, and the caller then reads the full reps."""
    vals, terms = torch.topk(reps, t, dim=1)
    nnz = (reps != 0).sum(dim=1, dtype=torch.float32)
    return torch.cat([terms.float(), vals, nnz[:, None]], dim=1)


class SparseIndexer:
    """Encode a corpus shard and build its impact index.

    ``device_sparsify_t`` > 0 turns on the top-t packed read
    (``_pack_sparse_topk``), which is exact: a batch with a row of more
    than t nonzeros falls back to the full [bz, V] read and is counted in
    ``n_fallback_batches``. The batch loop dispatches ahead
    (``utils.depth2_pipeline``), so batch i+1's encode runs on the device
    while batch i is read and appended on the host.

    The index does not depend on the order ``torch.topk`` gives tied
    values: a row's postings are every nonzero of the row, and
    ``SparseIndex.from_triples`` orders each posting list by row."""

    def __init__(self, model, index_dir: Optional[str],
                 compute_stats: bool = True, dim_voc: Optional[int] = None,
                 rank: int = 0, world_size: int = 1,
                 device_sparsify_t: int = 0):
        self.model = model
        self.index_dir = index_dir
        self.compute_stats = compute_stats
        self.dim_voc = dim_voc or model.vocab_size
        self.rank = rank
        self.world_size = world_size
        self.device_sparsify_t = int(device_sparsify_t)
        self.n_fallback_batches = 0

    def index(self, collection_loader: Iterable) -> dict:
        rows_parts, cols_parts, vals_parts = [], [], []
        doc_ids: dict[int, object] = {}
        state = {"count": 0, "l0_sum": 0.0, "n_batches": 0}
        t = min(self.device_sparsify_t, self.dim_voc)
        if 2 * t + 1 >= self.dim_voc:
            t = 0  # the packed buffer would not be smaller than the reps

        def dispatch(batch):
            with profile_span("corpus_encode_dispatch"):
                reps_dev = self.model.encode(batch["input_ids"],
                                             batch["attention_mask"])
                packed = _pack_sparse_topk(reps_dev, t) if t > 0 else None
            return packed, reps_dev, batch["ids"]

        def drain(pending):
            packed, reps_dev, ids = pending
            count = state["count"]
            state["n_batches"] += 1
            r = c = v = None
            if packed is not None:
                with profile_span("corpus_read_packed"):
                    buf = packed.cpu().numpy()
                nnz = buf[:, -1]
                if float(nnz.max(initial=0.0)) <= t:
                    terms = buf[:, :t].astype(np.int64)
                    vals = buf[:, t:2 * t]
                    r, slot = np.nonzero(vals > 0)
                    c, v = terms[r, slot], vals[r, slot]
                    if self.compute_stats:
                        state["l0_sum"] += float(nnz.mean())
                else:
                    # a row overflowed the top-t budget: read the full
                    # reps of this batch only
                    self.n_fallback_batches += 1
            if r is None:
                with profile_span("corpus_read_full"):
                    reps = reps_dev.float().cpu().numpy()     # [bz, V]
                if self.compute_stats:
                    state["l0_sum"] += float((reps != 0).sum(axis=-1).mean())
                r, c = np.nonzero(reps)
                v = reps[r, c]
            with profile_span("corpus_csr_append"):
                g_rows = (r + count) * self.world_size + self.rank
                rows_parts.append(g_rows.astype(np.int64))
                cols_parts.append(np.asarray(c, np.int64))
                vals_parts.append(np.asarray(v, np.float32))
                for local, did in enumerate(ids):
                    doc_ids[(count + local) * self.world_size
                            + self.rank] = did
            state["count"] += len(ids)

        depth2_pipeline(collection_loader, dispatch, drain)
        rows = (np.concatenate(rows_parts) if rows_parts
                else np.zeros(0, np.int64))
        cols = (np.concatenate(cols_parts) if cols_parts
                else np.zeros(0, np.int64))
        vals = (np.concatenate(vals_parts) if vals_parts
                else np.zeros(0, np.float32))
        index = SparseIndex.from_triples(rows, cols, vals, doc_ids,
                                         self.dim_voc)
        stats = ({"L0_d": state["l0_sum"] / max(1, state["n_batches"])}
                 if self.compute_stats else None)
        if self.index_dir is not None:
            index.save(self.index_dir)
            if stats is not None:
                with open(os.path.join(self.index_dir, "index_stats.json"),
                          "w") as f:
                    json.dump(stats, f)
        out = {"index": index, "ids_mapping": dict(enumerate(index.doc_ids))}
        if stats is not None:
            out["stats"] = stats
        return out


def store_embs(model, collection_loader: Iterable, local_rank: int,
               out_dir: str, chunk_size: int = 2_000_000,
               use_fp16: bool = False, world_size: int = 1) -> None:
    """Encode a corpus shard and write its embedding chunks (a chunk every
    ``chunk_size // batch_size`` batches) and ``plan.json``."""
    os.makedirs(out_dir, exist_ok=True)
    write_freq = max(1, chunk_size // _infer_batch_size(collection_loader))

    embs, ids = [], []
    chunk_idx = 0
    for i, batch in enumerate(collection_loader):
        reps = torch.as_tensor(model.encode(batch["input_ids"],
                                            batch["attention_mask"]))
        reps = reps.float().cpu().numpy()
        embs.append(reps.astype(np.float16) if use_fp16 else reps)
        ids.extend(batch["ids"])
        if (i + 1) % write_freq == 0:
            _flush(out_dir, local_rank, chunk_idx, embs, ids)
            embs, ids = [], []
            chunk_idx += 1
    if embs:
        _flush(out_dir, local_rank, chunk_idx, embs, ids)
        chunk_idx += 1

    plan = {"nranks": world_size, "num_chunks": chunk_idx, "index_path": None}
    with open(os.path.join(out_dir, "plan.json"), "w") as f:
        json.dump(plan, f)


def _infer_batch_size(loader) -> int:
    return getattr(loader, "batch_size", 128) or 128


def _flush(out_dir: str, rank: int, chunk_idx: int, embs: list,
           ids: list) -> None:
    arr = np.concatenate(embs, axis=0)
    np.save(os.path.join(out_dir, f"embs_{rank}_{chunk_idx}.npy"), arr)
    np.save(os.path.join(out_dir, f"ids_{rank}_{chunk_idx}.npy"),
            np.asarray(ids, dtype=object), allow_pickle=True)


def obtain_doc_vec_dir_files(doc_embed_dir: str
                             ) -> tuple[list[str], list[str]]:
    """Read plan.json → ordered (emb_files, id_files)."""
    with open(os.path.join(doc_embed_dir, "plan.json")) as f:
        plan = json.load(f)
    emb_files, id_files = [], []
    for rank in range(plan["nranks"]):
        for chunk in range(plan["num_chunks"]):
            emb = os.path.join(doc_embed_dir, f"embs_{rank}_{chunk}.npy")
            idf = os.path.join(doc_embed_dir, f"ids_{rank}_{chunk}.npy")
            if os.path.exists(emb):
                emb_files.append(emb)
                id_files.append(idf)
    return emb_files, id_files
