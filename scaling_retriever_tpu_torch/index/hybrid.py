"""Hybrid (sparse + dense) encoders, indexing and retrieval (port of
index/hybrid.py).

``DecoderOnlyBiHybrid`` runs ONE transformer forward and derives both
heads from it: the LM-head logits pooled SPLADE-style (``sparse_pool``, the
chunked masked max) and the hidden states mean-pooled (``dense_pool``).
``HybridIndexer`` builds the CSR impact index and the dense embedding
chunks in the same corpus pass, in the reference's files (the sparse
index's, ``embs_{rank}_{chunk}.npy`` / ``ids_{rank}_{chunk}.npy`` and
``plan.json``; global rows ``(r + count) * world_size + rank``).
``HybridRetriever`` answers through ``SparseRetrieval`` (its default
engine "xla", the doc-major scan, as in the reference; "segsort" runs the
fetch, segsum and top-m kernels) and the dense flat index (kernel B5 at
its dense site), into ``sparse/run.json`` and ``dense/run.json``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from scaling_retriever_tpu_torch.index.dense_index import DenseFlatIndexer
from scaling_retriever_tpu_torch.index.indexer import (
    _flush, _infer_batch_size, obtain_doc_vec_dir_files)
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.index.sparse_retrieval import SparseRetrieval
from scaling_retriever_tpu_torch.models.encoder import LLM2Retriever
from scaling_retriever_tpu_torch.ops.pooling import dense_pool, sparse_pool


class DecoderOnlyBiHybrid(LLM2Retriever):
    """One forward, two heads: ``encode`` → (sparse [B, V], dense [B, H]),
    both f32."""

    POOLING = "hybrid"

    def encode_pure(self, params, lora, input_ids, attention_mask,
                    dropout_seed: Optional[int] = None):
        on = lora is not None and self.lora_config is not None
        scale = self.lora_config.scaling if on else 0.0
        drop = self.lora_config.lora_dropout if on else 0.0
        hidden = params.forward_hidden(input_ids, attention_mask, lora, scale,
                                       drop, dropout_seed)
        head = (params.embed_tokens if params.lm_head is None
                else params.lm_head)
        logits = F.linear(hidden, head.weight.to(hidden.dtype))
        return (sparse_pool(logits, attention_mask, self.config.hidden_size),
                dense_pool(hidden, attention_mask))

    def rerank_forward(self, tokenized_queries: dict, tokenized_docs: dict,
                       alpha: float = 1.0) -> torch.Tensor:
        """Sparse dot product plus ``alpha`` times the dense one."""
        qs, qd = self.encode(**tokenized_queries)
        ds, dd = self.encode(**tokenized_docs)
        return (qs * ds).sum(dim=-1) + alpha * (qd * dd).sum(dim=-1)


class LlamaBiHybrid(DecoderOnlyBiHybrid):
    MODEL_TYPE = "llama"
    BASE_MODEL_CLASS = "LlamaBiModel"


class Qwen2BiHybrid(DecoderOnlyBiHybrid):
    MODEL_TYPE = "qwen2"
    BASE_MODEL_CLASS = "Qwen2BiModel"


LlamaBiHybridRetrieverForNCE = LlamaBiHybrid   # the reranker CLI's name


class HybridIndexer:
    """Build the impact index and the dense embedding chunks in one corpus
    pass (a chunk every ``chunk_size // batch_size`` batches, f16 with
    ``use_fp16``)."""

    def __init__(self, model, sparse_index_dir: str, dense_index_dir: str,
                 chunk_size: int = 2_000_000, compute_stats: bool = True,
                 dim_voc: Optional[int] = None, rank: int = 0,
                 world_size: int = 1, use_fp16: bool = False):
        self.model = model
        self.sparse_index_dir = sparse_index_dir
        self.dense_index_dir = dense_index_dir
        self.chunk_size = chunk_size
        self.compute_stats = compute_stats
        self.dim_voc = dim_voc or model.vocab_size
        self.rank = rank
        self.world_size = world_size
        self.use_fp16 = use_fp16

    def index(self, collection_loader: Iterable) -> dict:
        os.makedirs(self.dense_index_dir, exist_ok=True)
        rows_p, cols_p, vals_p = [], [], []
        doc_ids: dict = {}
        embs, emb_ids = [], []
        chunk_idx = count = n_batches = 0
        l0_sum = 0.0
        write_freq = max(1, self.chunk_size
                         // _infer_batch_size(collection_loader))
        for i, batch in enumerate(collection_loader):
            sparse, dense = self.model.encode(batch["input_ids"],
                                              batch["attention_mask"])
            sparse = sparse.float().cpu().numpy()
            dense = dense.float().cpu().numpy()
            ids = batch["ids"]
            n_batches += 1
            if self.compute_stats:
                l0_sum += float((sparse != 0).sum(-1).mean())
            r, c = np.nonzero(sparse)
            rows_p.append(((r + count) * self.world_size
                           + self.rank).astype(np.int64))
            cols_p.append(c.astype(np.int64))
            vals_p.append(sparse[r, c])
            for local, did in enumerate(ids):
                doc_ids[(count + local) * self.world_size + self.rank] = did
            count += len(ids)
            embs.append(dense.astype(np.float16) if self.use_fp16 else dense)
            emb_ids.extend(ids)
            if (i + 1) % write_freq == 0:
                _flush(self.dense_index_dir, self.rank, chunk_idx, embs,
                       emb_ids)
                embs, emb_ids = [], []
                chunk_idx += 1
        if embs:
            _flush(self.dense_index_dir, self.rank, chunk_idx, embs, emb_ids)
            chunk_idx += 1
        with open(os.path.join(self.dense_index_dir, "plan.json"), "w") as f:
            json.dump({"nranks": self.world_size, "num_chunks": chunk_idx,
                       "index_path": None}, f)

        def cat(parts, dtype):
            return np.concatenate(parts) if parts else np.zeros(0, dtype)

        index = SparseIndex.from_triples(
            cat(rows_p, np.int64), cat(cols_p, np.int64),
            cat(vals_p, np.float32), doc_ids, self.dim_voc)
        index.save(self.sparse_index_dir)
        if self.compute_stats:
            with open(os.path.join(self.sparse_index_dir,
                                   "index_stats.json"), "w") as f:
                json.dump({"L0_d": l0_sum / max(1, n_batches)}, f)
        return {"index": index}


class _SparseView:
    """The hybrid model's sparse head as a sparse encoder, for
    ``SparseRetrieval``."""

    def __init__(self, model):
        self.model = model
        self.vocab_size = model.vocab_size

    def encode(self, input_ids, attention_mask):
        return self.model.encode(input_ids, attention_mask)[0]


class HybridRetriever:
    """Sparse and dense retrieval from one hybrid model, into
    ``out_dir/sparse/run.json`` (and ``q_stats.json``) and
    ``out_dir/dense/run.json``. ``device`` (default "cuda") holds both
    indexes; asked for CUDA without it, construction raises."""

    def __init__(self, model, sparse_index_dir: str, dense_embed_dir: str,
                 out_dir: str, topk: int = 1000, engine: str = "xla",
                 device="cuda"):
        self.model = model
        self.out_dir = out_dir
        self.topk = topk
        self.sparse_retrieval = SparseRetrieval(
            _SparseView(model), sparse_index_dir,
            out_dir=os.path.join(out_dir, "sparse"), topk=topk,
            engine=engine, device=device)
        self.dense_indexer = DenseFlatIndexer(device=device)
        emb_files, id_files = obtain_doc_vec_dir_files(dense_embed_dir)
        self.dense_indexer.init_index(np.load(emb_files[0]).shape[1])
        for emb_f, id_f in zip(emb_files, id_files):
            self.dense_indexer.add_batch(
                np.load(id_f, allow_pickle=True).tolist(),
                np.load(emb_f).astype(np.float32))

    def retrieve(self, q_loader: Iterable,
                 topk: Optional[int] = None) -> dict:
        topk = topk or self.topk
        batches = list(q_loader)
        qids, dense_reps = [], []
        for batch in batches:
            _, d = self.model.encode(batch["input_ids"],
                                     batch["attention_mask"])
            dense_reps.append(d.float().cpu().numpy())
            qids.extend(batch["ids"])
        sparse_run, _ = self.sparse_retrieval.retrieve(iter(batches),
                                                       topk=topk)
        dense_run = {
            str(qid): {str(d): float(s) for d, s in zip(db_ids, scores)}
            for qid, (db_ids, scores) in zip(
                qids, self.dense_indexer.search_knn(
                    np.concatenate(dense_reps), topk))}
        os.makedirs(os.path.join(self.out_dir, "dense"), exist_ok=True)
        with open(os.path.join(self.out_dir, "dense", "run.json"), "w") as f:
            json.dump(dense_run, f)
        return {"sparse": sparse_run, "dense": dense_run}
