"""Sparse evaluation CLI (port of evaluation/eval_sparse.py):
indexing | encode_queries | retrieval | evaluate_msmarco | evaluate_beir,
with the same flags plus ``--device`` (default "cuda").

    python -m scaling_retriever_tpu_torch.evaluation.eval_sparse \
        --task_name indexing --model_name_or_path CKPT \
        --corpus_path corpus.tsv --index_dir IDX [--device cuda]
    python -m scaling_retriever_tpu_torch.evaluation.eval_sparse \
        --task_name retrieval --index_dir IDX --out_dir OUT \
        (--query_reps_path query_reps.npz | --model_name_or_path CKPT \
         --query_path queries.tsv) [--passes 2] [--device cuda]

``indexing`` encodes the corpus with the checkpoint (plus
``--lora_name_or_path``; a LoRA directory as ``--model_name_or_path``
loads its base model) and writes the index (``_{rank}`` suffixed with
``--world_size`` > 1). ``encode_queries`` writes the query reps to
``--query_reps_path`` (default ``out_dir/query_reps.npz``). ``retrieval``
reads pre-encoded queries from ``--query_reps_path`` (an npz with ``ids``
and either sparse ``q_terms``/``q_vals`` or dense ``reps``) or encodes
query text, and writes ``run.json`` and ``q_stats.json`` (with ``--passes
N`` the stream runs N times in one process, run.json from the last pass
and per-pass stats under "passes"). ``evaluate_msmarco`` writes
``perf.json`` from a run and a qrel; ``evaluate_beir`` from
``out_dir/run.json`` and a local BEIR dataset's qrels. The text tasks need
a tokenizer in the checkpoint directory, which ``transformers`` loads.

``--use_mesh`` shards the index by doc ranges over every device of
``--device``'s type (``parallel.mesh.local_devices``) when there is more
than one; on one device it runs the one-device path, as the reference
does on one chip.
"""

from __future__ import annotations

import argparse
import ast
import json
import os

import numpy as np

from scaling_retriever_tpu_torch import constants
from scaling_retriever_tpu_torch.data.collators import \
    LlamaSparseCollectionCollator
from scaling_retriever_tpu_torch.data.datasets import (
    BeirDataset, CollectionDataset, MSMARCOQueryDataset, WikiQueryDataset,
)
from scaling_retriever_tpu_torch.data.io import load_beir_dataset
from scaling_retriever_tpu_torch.data.loader import DataLoader
from scaling_retriever_tpu_torch.data.prefetch import PrefetchLoader
from scaling_retriever_tpu_torch.evaluation.metrics import (
    evaluate_beir, load_and_evaluate,
)
from scaling_retriever_tpu_torch.index.indexer import SparseIndexer
from scaling_retriever_tpu_torch.index.sparse_retrieval import SparseRetrieval
from scaling_retriever_tpu_torch.parallel import mesh as mesh_lib


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--corpus_path", default="")
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
                   choices=["indexing", "encode_queries", "retrieval",
                            "evaluate_msmarco", "evaluate_beir"])
    p.add_argument("--query_reps_path", default=None,
                   help="npz of pre-encoded query reps (keys: ids + either "
                        "reps [dense] or q_terms/q_vals [sparse]); "
                        "retrieval then needs no encoder")
    p.add_argument("--reps_format", default="sparse",
                   choices=["sparse", "dense"],
                   help="encode_queries output layout")
    p.add_argument("--eval_qrel_path", default="")
    p.add_argument("--eval_run_path", default="")
    p.add_argument("--eval_metric", default="",
                   help="python-list literal, e.g. \"['mrr_10','recall']\"")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "segsort", "maxscore", "cpp"],
                   help="auto = segsort on a CUDA device, the doc-major "
                        "scan (xla) on the CPU")
    p.add_argument("--index_val_dtype", default="f32",
                   choices=["f32", "bf16", "q8"],
                   help="segsort posting layout: f32 (8 B/posting), bf16 "
                        "value pairs (6 B) or q8 (row24|code8) words (4 B)")
    p.add_argument("--query_tile", type=int, default=64,
                   help="max queries per device tile (cost-sized packing "
                        "may narrow tiles of hot queries)")
    p.add_argument("--passes", type=int, default=1,
                   help="retrieval passes over the stream in one process; "
                        "run.json comes from the last, per-pass stats go "
                        "to q_stats.json under \"passes\"")
    p.add_argument("--index_sparsify_t", type=int, default=1024,
                   help="indexing: top-t read of the encoder reps")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--use_mesh", action="store_true",
                   help="shard the index over all local devices")
    p.add_argument("--device", default="cuda",
                   help="torch device of the encoder and retrieval (cuda, "
                        "cuda:N or cpu)")
    return p


def _load_model(args):
    from scaling_retriever_tpu_torch.models.encoder import load_encoder

    return load_encoder(args.model_name_or_path, "sparse",
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


def sparse_index(args, model=None, tokenizer=None) -> dict:
    """Encode the corpus (``--corpus_path`` or a BEIR corpus) into an index
    at ``--index_dir``; ``model`` and ``tokenizer`` default to loading
    ``--model_name_or_path``. Returns ``SparseIndexer.index``'s result
    plus the indexer under "indexer"."""
    tokenizer = tokenizer if tokenizer is not None else _tokenizer(args)
    if args.is_beir and args.beir_dataset:
        corpus, _, _ = load_beir_dataset(_beir_path(args))
        d_collection = BeirDataset(corpus, information_type="document")
    else:
        source = args.data_source or constants.guess_data_source(
            args.corpus_path)
        d_collection = CollectionDataset(args.corpus_path, data_source=source)
    model = model if model is not None else _load_model(args)
    collator = LlamaSparseCollectionCollator(tokenizer, args.doc_max_length)
    index_dir = args.index_dir
    if args.world_size > 1:
        index_dir = index_dir.rstrip("/") + f"_{args.rank}"
    loader = DataLoader(d_collection, args.eval_batch_size, collator,
                        rank=args.rank, world_size=args.world_size)
    indexer = SparseIndexer(model, index_dir, dim_voc=model.vocab_size,
                            rank=args.rank, world_size=args.world_size,
                            device_sparsify_t=args.index_sparsify_t)
    out = indexer.index(PrefetchLoader(loader))
    out["indexer"] = indexer
    return out


def _query_loader(args, use_reps: bool = True, tokenizer=None):
    """Tokenized query batches, or, with ``--query_reps_path``, batches of
    pre-encoded queries: sparse ({"q_terms", "q_vals", "ids"}) or dense
    ({"rep", "ids"})."""
    if use_reps and args.query_reps_path:
        data = np.load(args.query_reps_path, allow_pickle=True)
        ids = data["ids"].tolist()
        bz = args.eval_batch_size
        if "q_terms" in data:
            qt, qv = data["q_terms"], data["q_vals"]
            return [{"q_terms": qt[i:i + bz], "q_vals": qv[i:i + bz],
                     "ids": ids[i:i + bz]} for i in range(0, len(ids), bz)]
        reps = data["reps"]
        return [{"rep": reps[i:i + bz], "ids": ids[i:i + bz]}
                for i in range(0, len(ids), bz)]
    tokenizer = tokenizer if tokenizer is not None else _tokenizer(args)
    if args.is_beir and args.beir_dataset:
        _, queries, _ = load_beir_dataset(_beir_path(args))
        q_collection = BeirDataset(queries, information_type="query")
    else:
        source = args.data_source or constants.guess_data_source(
            args.query_path)
        q_collection = (WikiQueryDataset(args.query_path) if source == "wiki"
                        else MSMARCOQueryDataset(args.query_path))
    collator = LlamaSparseCollectionCollator(tokenizer, args.query_max_length)
    return DataLoader(q_collection, args.eval_batch_size, collator)


def encode_queries(args, model=None, tokenizer=None) -> str:
    """Encode the query stream once and write (ids, reps) to
    ``--query_reps_path`` (default ``out_dir/query_reps.npz``): sparse
    (q_terms, q_vals) at least 64 wide and as wide as the densest row, or
    dense [nq, V] reps (``--reps_format``). Returns the path written."""
    from scaling_retriever_tpu_torch.ops.segsort_scoring import sparsify_reps

    loader = _query_loader(args, use_reps=False, tokenizer=tokenizer)
    model = model if model is not None else _load_model(args)
    qids, reps = [], []
    for batch in loader:
        reps.append(model.encode(batch["input_ids"], batch["attention_mask"])
                    .float().cpu().numpy())
        qids.extend(batch["ids"])
    out = args.query_reps_path or os.path.join(args.out_dir, "query_reps.npz")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    dense = (np.concatenate(reps, 0) if reps
             else np.zeros((0, model.vocab_size), np.float32))
    if args.reps_format == "sparse":
        q_terms, q_vals = sparsify_reps(dense)
        np.savez(out, ids=np.asarray(qids, dtype=object),
                 q_terms=q_terms, q_vals=q_vals)
    else:
        np.savez(out, ids=np.asarray(qids, dtype=object), reps=dense)
    return out


def sparse_retrieval(args, model=None, tokenizer=None) -> None:
    """Rank the queries (pre-encoded, or text through ``model``, which
    defaults to loading ``--model_name_or_path``) over ``--index_dir``
    into ``--out_dir``."""
    loader = _query_loader(args, tokenizer=tokenizer)
    if args.query_reps_path:
        model = None
    elif model is None:
        model = _load_model(args)
    mesh = None
    if args.use_mesh:
        devices = mesh_lib.local_devices(args.device)
        if len(devices) > 1:
            mesh = mesh_lib.make_mesh(devices=devices)
    os.makedirs(args.out_dir, exist_ok=True)
    retriever = SparseRetrieval(model, args.index_dir, out_dir=args.out_dir,
                                topk=args.top_k, engine=args.engine,
                                mesh=mesh, query_tile=args.query_tile,
                                index_val_dtype=args.index_val_dtype,
                                device=args.device)
    if args.passes <= 1:
        retriever.retrieve(loader, topk=args.top_k, threshold=0.0)
        return
    # every pass sees the same batches; span accounting restarts per pass,
    # and run.json is built and written by the last pass only
    from scaling_retriever_tpu_torch.utils.profiling import reset_timings

    batches = list(loader)
    per_pass = []
    for p_i in range(args.passes):
        reset_timings()
        _, stats = retriever.retrieve(batches, topk=args.top_k,
                                      threshold=0.0, return_run=False,
                                      write_run=(p_i == args.passes - 1))
        per_pass.append({"pass": p_i + 1,
                         "retrieval_s": stats["retrieval_s"],
                         "retrieval_qps": stats["retrieval_qps"],
                         "warmup_tiles": stats.get("warmup_tiles"),
                         "steady_qps": stats.get("steady_qps")})
        print(f"pass {p_i + 1}/{args.passes}: "
              f"{stats['retrieval_qps']} QPS all-tile "
              f"({stats['retrieval_s']} s)", flush=True)
    stats["passes"] = per_pass
    with open(os.path.join(args.out_dir, "q_stats.json"), "w") as f:
        json.dump(stats, f)


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
    if args.task_name == "indexing":
        sparse_index(args)
    elif args.task_name == "encode_queries":
        encode_queries(args)
    elif args.task_name == "retrieval":
        sparse_retrieval(args)
    elif args.task_name == "evaluate_msmarco":
        evaluate_msmarco(args)
    elif args.task_name == "evaluate_beir":
        _, _, qrels = load_beir_dataset(_beir_path(args))
        evaluate_beir(args.out_dir, qrels)


if __name__ == "__main__":
    main()
