"""Sparse evaluation CLI (port of evaluation/eval_sparse.py):
retrieval | evaluate_msmarco | evaluate_beir, with the same flags plus
``--device`` (default "cuda").

    python -m scaling_retriever_tpu_torch.evaluation.eval_sparse \\
        --task_name retrieval --index_dir IDX --out_dir OUT \\
        --query_reps_path query_reps.npz [--passes 2] [--device cuda]

``retrieval`` reads pre-encoded queries from ``--query_reps_path`` (an npz
with ``ids`` and either sparse ``q_terms``/``q_vals`` or dense ``reps``)
and writes ``run.json`` and ``q_stats.json`` (with ``--passes N`` the
stream runs N times in one process, run.json from the last pass and
per-pass stats under "passes"). ``evaluate_msmarco`` writes ``perf.json``
from a run and a qrel; ``evaluate_beir`` from ``out_dir/run.json`` and a
local BEIR dataset's qrels.

Not ported yet, and raising ``NotImplementedError``: ``indexing`` (the
indexer, ROADMAP A8), and ``encode_queries`` or ``retrieval`` from query
text (checkpoint and tokenizer loading, A7), ``--use_mesh`` (A10).
"""

from __future__ import annotations

import argparse
import ast
import json
import os

import numpy as np

from scaling_retriever_tpu_torch.data.io import load_beir_dataset
from scaling_retriever_tpu_torch.evaluation.metrics import (
    evaluate_beir, load_and_evaluate,
)
from scaling_retriever_tpu_torch.index.sparse_retrieval import SparseRetrieval


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
                   help="torch device for retrieval (cuda, cuda:N or cpu)")
    return p


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _beir_path(args) -> str:
    path = os.path.join(args.beir_dataset_dir, args.beir_dataset)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"BEIR dataset {args.beir_dataset!r} not found under "
            f"{args.beir_dataset_dir!r}; download it on a connected machine")
    return path


def _query_loader(args) -> list:
    """Batches of pre-encoded queries from ``--query_reps_path``: sparse
    ({"q_terms", "q_vals", "ids"}) or dense ({"rep", "ids"})."""
    if not args.query_reps_path:
        raise _not_ported("retrieval from query text (checkpoint and "
                          "tokenizer loading; pass --query_reps_path)", "A7")
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


def sparse_retrieval(args) -> None:
    if args.use_mesh:
        raise _not_ported("--use_mesh (the sharded engine)", "A10")
    loader = _query_loader(args)
    os.makedirs(args.out_dir, exist_ok=True)
    retriever = SparseRetrieval(None, args.index_dir, out_dir=args.out_dir,
                                topk=args.top_k, engine=args.engine,
                                query_tile=args.query_tile,
                                index_val_dtype=args.index_val_dtype,
                                device=args.device)
    if args.passes <= 1:
        retriever.retrieve(loader, topk=args.top_k, threshold=0.0)
        return
    # every pass sees the same batches; span accounting restarts per pass,
    # and run.json is built and written by the last pass only
    from scaling_retriever_tpu_torch.utils.profiling import reset_timings

    per_pass = []
    for p_i in range(args.passes):
        reset_timings()
        _, stats = retriever.retrieve(loader, topk=args.top_k,
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
        raise _not_ported("task indexing (the indexer)", "A8")
    if args.task_name == "encode_queries":
        raise _not_ported("task encode_queries (checkpoint and tokenizer "
                          "loading)", "A7")
    if args.task_name == "retrieval":
        sparse_retrieval(args)
    elif args.task_name == "evaluate_msmarco":
        evaluate_msmarco(args)
    elif args.task_name == "evaluate_beir":
        _, _, qrels = load_beir_dataset(_beir_path(args))
        evaluate_beir(args.out_dir, qrels)


if __name__ == "__main__":
    main()
