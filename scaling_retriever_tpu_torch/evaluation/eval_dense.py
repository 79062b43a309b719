"""Dense evaluation CLI (port of evaluation/eval_dense.py):
write_doc_embeds | retrieval | evaluate_msmarco | evaluate_beir, with the
same flags plus ``--device`` (default "cuda").

  * ``write_doc_embeds`` — corpus encode → ``embs_{rank}_{chunk}.npy``
    chunks + ``plan.json`` (``index/indexer.store_embs``);
  * ``retrieval`` — load the chunks into the exact flat inner-product index
    (``LocalDenseRetriever``) → top-k ``run.json``;
  * ``evaluate_msmarco`` / ``evaluate_beir`` — ``perf.json``.

``write_doc_embeds`` and ``dense_retrieval`` take the encoder and the
tokenizer as arguments, or load them from ``--model_name_or_path`` (plus
``--lora_name_or_path``; a LoRA directory loads its base model) onto
``--device``; the tokenizer is the checkpoint directory's, which
``transformers`` loads. ``--use_mesh`` searches with
``MeshDenseRetriever`` (the doc-sharded search) over every device of
``--device``'s type (``parallel.mesh.local_devices``) when there is more
than one, and with ``LocalDenseRetriever`` otherwise, as the reference
does on one chip.
"""

from __future__ import annotations

import argparse
import ast
import json
import os

import numpy as np
import torch

from scaling_retriever_tpu_torch import constants
from scaling_retriever_tpu_torch.data.collators import \
    LlamaDenseCollectionCollator
from scaling_retriever_tpu_torch.data.datasets import (
    BeirDataset, CollectionDataset, MSMARCOQueryDataset, WikiQueryDataset,
)
from scaling_retriever_tpu_torch.data.io import load_beir_dataset
from scaling_retriever_tpu_torch.data.loader import DataLoader
from scaling_retriever_tpu_torch.data.prefetch import PrefetchLoader
from scaling_retriever_tpu_torch.evaluation.metrics import (
    evaluate_beir, load_and_evaluate,
)
from scaling_retriever_tpu_torch.index.dense_index import (
    DenseFlatIndexer, make_sharded_dense_search,
)
from scaling_retriever_tpu_torch.index.indexer import (
    obtain_doc_vec_dir_files, store_embs,
)
from scaling_retriever_tpu_torch.parallel import mesh as mesh_lib
from scaling_retriever_tpu_torch.utils.utils import depth2_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--corpus_path", default="")
    p.add_argument("--doc_embed_dir", default=None)
    p.add_argument("--index_dir", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--query_path", default=None)
    p.add_argument("--data_source", default=None)
    p.add_argument("--lora_name_or_path", default=None)
    p.add_argument("--is_beir", action="store_true")
    p.add_argument("--beir_dataset", default=None)
    p.add_argument("--beir_dataset_dir", default=None)
    p.add_argument("--eval_batch_size", type=int, default=128)
    p.add_argument("--doc_max_length", type=int, default=192)
    p.add_argument("--query_max_length", type=int, default=64)
    p.add_argument("--top_k", type=int, default=1000)
    p.add_argument("--task_name", required=True,
                   choices=["write_doc_embeds", "retrieval",
                            "evaluate_msmarco", "evaluate_beir"])
    p.add_argument("--eval_qrel_path", default="")
    p.add_argument("--eval_run_path", default="")
    p.add_argument("--eval_metric", default="",
                   help="python-list literal, e.g. \"['mrr_10','recall']\"")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="retrieval embedding layout: int8 = per-doc codes "
                        "+ f32 scales (1 B/dim, exact over the codes); the "
                        "disk artifacts stay f32")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--use_mesh", action="store_true",
                   help="doc-shard the embedding matrix over all devices")
    p.add_argument("--device", default="cuda",
                   help="torch device for encoding and retrieval (cuda, "
                        "cuda:N or cpu)")
    return p


def _load_model(args):
    from scaling_retriever_tpu_torch.models.encoder import load_encoder

    return load_encoder(args.model_name_or_path, "dense",
                        args.lora_name_or_path, device=args.device)


def _tokenizer(args):
    from scaling_retriever_tpu_torch.models.encoder import load_tokenizer

    return load_tokenizer(args.model_name_or_path)


def _beir_path(args) -> str:
    path = os.path.join(args.beir_dataset_dir, args.beir_dataset)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"BEIR dataset {args.beir_dataset!r} not found under "
            f"{args.beir_dataset_dir!r}; download it on a connected machine")
    return path


def write_doc_embeds(args, model=None, tokenizer=None) -> None:
    """Encode the corpus (``--corpus_path`` or a BEIR corpus) into
    ``--doc_embed_dir``; ``model`` and ``tokenizer`` default to loading
    ``--model_name_or_path``."""
    tokenizer = tokenizer if tokenizer is not None else _tokenizer(args)
    if args.is_beir and args.beir_dataset:
        corpus, _, _ = load_beir_dataset(_beir_path(args))
        d_collection = BeirDataset(corpus, information_type="document")
    else:
        source = args.data_source or constants.guess_data_source(
            args.corpus_path)
        d_collection = CollectionDataset(args.corpus_path, data_source=source)
    model = model if model is not None else _load_model(args)
    collator = LlamaDenseCollectionCollator(tokenizer, args.doc_max_length)
    loader = DataLoader(d_collection, args.eval_batch_size, collator,
                        rank=args.rank, world_size=args.world_size)
    store_embs(model, PrefetchLoader(loader), local_rank=args.rank,
               out_dir=args.doc_embed_dir, world_size=args.world_size)


class LocalDenseRetriever:
    """Load the npy chunks into the flat index and rank queries."""

    def __init__(self, hidden_dim: int, quantize=None, device="cuda"):
        self.indexer = DenseFlatIndexer(quantize=quantize, device=device)
        self.indexer.init_index(hidden_dim)

    def index_encoded_data(self, doc_embed_dir: str) -> None:
        emb_files, id_files = obtain_doc_vec_dir_files(doc_embed_dir)
        for emb_f, id_f in zip(emb_files, id_files):
            vectors = np.asarray(np.load(emb_f), np.float32)
            ids = np.load(id_f, allow_pickle=True).tolist()
            self.indexer.add_batch(ids, vectors)

    def get_top_docs(self, query_vectors, top_docs: int):
        return self.indexer.search_knn(query_vectors, top_docs)


class MeshDenseRetriever:
    """Doc-sharded dense retrieval over a mesh: the rows split into one
    equal range per mesh entry (padded with zero rows to ``chunk`` times
    the entry count) and searched by ``make_sharded_dense_search``, the
    queries in ``dtype``. The reference concatenates the files into one
    f32 host array (72 GB at MSMARCO size) before placing it; here each
    shard's rows go to its device in ``chunk``-row tensors of ``dtype`` as
    the files are read, at the first search. Same shards, same results."""

    def __init__(self, hidden_dim: int, mesh, chunk: int = 8192,
                 query_tile: int = 256, dtype=torch.bfloat16):
        self.hidden_dim = hidden_dim
        self.mesh = mesh
        self.chunk = chunk
        self.query_tile = query_tile  # bounds the [nq, chunk] score slab
        self.dtype = dtype
        self.ids: list = []
        self._files: list = []
        self._placed = None

    def index_encoded_data(self, doc_embed_dir: str) -> None:
        emb_files, id_files = obtain_doc_vec_dir_files(doc_embed_dir)
        for emb_f, id_f in zip(emb_files, id_files):
            self._files.append(emb_f)
            self.ids.extend(np.load(id_f, allow_pickle=True).tolist())
        self._placed = None

    def _place(self):
        """(per-shard chunk lists, per-shard global row ids, -1 past the
        last row), built from the files once."""
        if self._placed is not None:
            return self._placed
        n, c = len(self.ids), self.chunk
        per = -(-n // (c * self.mesh.size)) * c
        shards = [[torch.zeros((c, self.hidden_dim), dtype=self.dtype,
                               device=d) for _ in range(per // c)]
                  for d in self.mesh.devices]
        row = 0
        for path in self._files:
            vecs = np.load(path, mmap_mode="r")
            a = 0
            while a < vecs.shape[0]:
                shard, within = divmod(row, per)
                ci, off = divmod(within, c)
                b = min(vecs.shape[0], a + c - off)
                shards[shard][ci][off:off + b - a] = torch.from_numpy(
                    np.array(vecs[a:b], np.float32)).to(self.dtype)
                row += b - a
                a = b
        if row != n:
            raise ValueError(f"{row} embedding rows for {n} ids")
        row_ids = []
        for i, d in enumerate(self.mesh.devices):
            ids = torch.arange(i * per, (i + 1) * per, device=d)
            row_ids.append(torch.where(ids < n, ids, -1))
        self._placed = shards, row_ids
        return self._placed

    def get_top_docs(self, query_vectors, top_docs: int):
        docs, row_ids = self._place()
        fn = make_sharded_dense_search(self.mesh, "data",
                                       k=min(top_docs, len(self.ids)),
                                       chunk=self.chunk)
        q = np.asarray(query_vectors, np.float32)
        tiles = []

        # dispatch tile i + 1 before reading tile i; the id mapping runs
        # once after the pipeline
        def _dispatch(start):
            q_tile = q[start:start + self.query_tile]
            n_real = q_tile.shape[0]
            pad = (self.query_tile - n_real
                   if q.shape[0] > self.query_tile else 0)
            if pad:
                q_tile = np.pad(q_tile, ((0, pad), (0, 0)))
            qd = torch.from_numpy(np.ascontiguousarray(q_tile)).to(
                self.mesh.device, self.dtype)
            return fn(docs, row_ids, qd), n_real

        def _drain(payload):
            (scores, rows), n_real = payload
            tiles.append((scores.float().cpu().numpy(), rows.cpu().numpy(),
                          n_real))

        depth2_pipeline(range(0, q.shape[0], self.query_tile), _dispatch,
                        _drain)
        id_map = np.asarray(self.ids, dtype=object)
        out = []
        for scores, rows, n_real in tiles:
            for qi in range(n_real):
                valid = rows[qi] >= 0
                out.append((id_map[rows[qi][valid]].tolist(),
                             scores[qi][valid].tolist()))
        return out


def dense_retrieval(args, model=None, tokenizer=None) -> None:
    """Encode the queries, rank them over ``--doc_embed_dir`` and write
    ``run.json`` to ``--out_dir``."""
    tokenizer = tokenizer if tokenizer is not None else _tokenizer(args)
    if args.is_beir and args.beir_dataset:
        _, queries, _ = load_beir_dataset(_beir_path(args))
        q_collection = BeirDataset(queries, information_type="query")
    else:
        source = args.data_source or constants.guess_data_source(
            args.query_path)
        q_collection = (WikiQueryDataset(args.query_path) if source == "wiki"
                        else MSMARCOQueryDataset(args.query_path))
    model = model if model is not None else _load_model(args)
    collator = LlamaDenseCollectionCollator(tokenizer, args.query_max_length)
    loader = DataLoader(q_collection, args.eval_batch_size, collator)

    devices = (mesh_lib.local_devices(args.device) if args.use_mesh
               else [args.device])
    if len(devices) > 1:
        retriever = MeshDenseRetriever(model.hidden_size,
                                       mesh_lib.make_mesh(devices=devices))
    else:
        retriever = LocalDenseRetriever(model.hidden_size,
                                        quantize=args.quantize or None,
                                        device=args.device)
    retriever.index_encoded_data(args.doc_embed_dir)

    qids, reps = [], []
    for batch in loader:
        reps.append(torch.as_tensor(model.encode(batch["input_ids"],
                                                 batch["attention_mask"]))
                    .float().cpu().numpy())
        qids.extend(batch["ids"])
    q_vecs = (np.concatenate(reps) if reps
              else np.zeros((0, model.hidden_size), np.float32))
    results = retriever.get_top_docs(q_vecs, args.top_k) if qids else []
    run = {str(qid): dict(zip(map(str, db_ids), scores))
           for qid, (db_ids, scores) in zip(qids, results)}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "run.json"), "w") as f:
        json.dump(run, f)


def evaluate_msmarco(args) -> None:
    metrics_list = (ast.literal_eval(args.eval_metric) if args.eval_metric
                    else ["mrr_10"])
    res = {}
    for metric in metrics_list:
        res[metric] = load_and_evaluate(args.eval_qrel_path,
                                        args.eval_run_path, metric)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "perf.json"), "w") as f:
        json.dump(res, f, indent=4)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.task_name == "write_doc_embeds":
        write_doc_embeds(args)
    elif args.task_name == "retrieval":
        dense_retrieval(args)
    elif args.task_name == "evaluate_msmarco":
        evaluate_msmarco(args)
    elif args.task_name == "evaluate_beir":
        _, _, qrels = load_beir_dataset(_beir_path(args))
        evaluate_beir(args.out_dir, qrels)


if __name__ == "__main__":
    main()
