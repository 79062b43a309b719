"""Reranker evaluation CLI (port of evaluation/eval_reranker.py).

Reranks (qid, docid) pairs, from a run.json (``--run_path``) or a JSONL of
``{"qid", "docids"}`` lines (``--jsonl_path``), with:
  * ``splade`` / ``dense_encoder`` / ``hybrid_retriever``: a bi-encoder
    (LlamaBiSparse, LlamaBiDense, LlamaBiHybrid from ``--peft_model_name``)
    scoring each pair by ``rerank_forward``, its texts tokenized with left
    padding (``bi_encoder_rerank``, which also takes the model and the
    tokenizer as arguments);
  * ``cross_encoder``: a Hugging Face sequence-classification model (plus
    an optional peft adapter), loaded by ``transformers`` and ``peft``
    (imported inside ``cross_encoder_rerank`` only).

The flags are the reference's plus ``--device`` (default "cuda"). Pairs
are sharded over ``--world_size`` ranks; the output is ``run.json``, or
``run_{rank}.json`` under sharding.

    python -m scaling_retriever_tpu_torch.evaluation.eval_reranker \\
        --run_path run.json --query_path queries.tsv \\
        --corpus_path corpus.tsv --output_dir OUT --rerank_type splade \\
        --peft_model_name ADAPTER [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from scaling_retriever_tpu_torch import constants
from scaling_retriever_tpu_torch.data.collators import (
    BertRerankerInferenceCollator, HybridRetrieverRerankCollator,
    RerankerInferenceCollator,
)
from scaling_retriever_tpu_torch.data.datasets import (
    BertRerankerInferenceDataset, BeirRerankDataset,
    HybridRetrieverRerankDataset, RerankerInferenceDataset,
)
from scaling_retriever_tpu_torch.data.loader import DataLoader

BI_ENCODERS = ("splade", "dense_encoder", "hybrid_retriever")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run_path", default=None)
    p.add_argument("--jsonl_path", default=None)
    p.add_argument("--query_path", default=None)
    p.add_argument("--corpus_path", default=None)
    p.add_argument("--data_source", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--rerank_type", required=True,
                   choices=[*BI_ENCODERS, "cross_encoder"])
    p.add_argument("--peft_model_name", default=None)
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--query_max_length", type=int, default=64)
    p.add_argument("--doc_max_length", type=int, default=192)
    p.add_argument("--max_length", type=int, default=256)
    p.add_argument("--pad_to_multiple_of", type=int, default=16)
    p.add_argument("--query_prefix", default="query:")
    p.add_argument("--doc_prefix", default="document:")
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--is_beir", action="store_true")
    p.add_argument("--beir_dataset", default=None)
    p.add_argument("--beir_dataset_dir", default=None)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device for the model (cuda, cuda:N or cpu)")
    return p


def load_pairs(args) -> list:
    """(qid, docid) pairs in file order."""
    pairs = []
    if args.jsonl_path:
        with open(args.jsonl_path) as f:
            for line in f:
                ex = json.loads(line)
                pairs.extend((ex["qid"], docid) for docid in ex["docids"])
    else:
        with open(args.run_path) as f:
            run = json.load(f)
        for qid, docs in run.items():
            pairs.extend((qid, docid) for docid in docs)
    return pairs


def _bi_encoder(args):
    from scaling_retriever_tpu_torch.index.hybrid import LlamaBiHybrid
    from scaling_retriever_tpu_torch.models.encoder import (LlamaBiDense,
                                                            LlamaBiSparse)

    cls = {"splade": LlamaBiSparse, "dense_encoder": LlamaBiDense,
           "hybrid_retriever": LlamaBiHybrid}[args.rerank_type]
    return cls.load_from_lora(args.peft_model_name, device=args.device)


def _bi_tokenizer(args, model):
    """The adapter directory's tokenizer, else its base model's."""
    from scaling_retriever_tpu_torch.models.encoder import load_tokenizer

    try:
        return load_tokenizer(args.peft_model_name)
    except (OSError, ValueError):
        return load_tokenizer(model.lora_config.base_model_name_or_path
                              if model.lora_config else args.peft_model_name)


def bi_encoder_rerank(args, pairs, model=None, tokenizer=None) -> dict:
    """{qid: {docid: score}} over this rank's share of ``pairs``, scored
    by the bi-encoder ``--rerank_type`` names (loaded from
    ``--peft_model_name`` onto ``--device`` unless ``model`` is given) with
    ``tokenizer`` (else the adapter's, or its base model's)."""
    if model is None:
        model = _bi_encoder(args)
    if tokenizer is None:
        tokenizer = _bi_tokenizer(args, model)
    tokenizer.padding_side = "left"
    source = args.data_source or constants.guess_data_source(
        args.corpus_path)
    dataset = HybridRetrieverRerankDataset(pairs, args.query_path,
                                           args.corpus_path,
                                           data_source=source)
    collator = HybridRetrieverRerankCollator(
        tokenizer, args.query_max_length, args.doc_max_length)
    loader = DataLoader(dataset, args.eval_batch_size, collator,
                        rank=args.rank, world_size=args.world_size)
    out_run: dict = {}
    for batch in loader:
        scores = model.rerank_forward(batch["tokenized_queries"],
                                      batch["tokenized_docs"])
        for qid, docid, score in zip(batch["qids"], batch["docids"],
                                     scores.float().cpu().tolist()):
            out_run.setdefault(str(qid), {})[str(docid)] = score
    return out_run


def cross_encoder_rerank(args, pairs) -> dict:
    """{qid: {docid: score}} from an HF sequence classifier: with
    ``--peft_model_name`` its adapter merged into the base model it names,
    prefixed texts padded on the right; else ``--model_name_or_path`` on
    (query, doc) pairs, from a BEIR directory with ``--is_beir``."""
    from transformers import (AutoModelForSequenceClassification,
                              AutoTokenizer)

    if args.peft_model_name:
        from peft import PeftModel

        with open(os.path.join(args.peft_model_name,
                               "adapter_config.json")) as f:
            base = json.load(f)["base_model_name_or_path"]
        model = AutoModelForSequenceClassification.from_pretrained(
            base, num_labels=1)
        model = PeftModel.from_pretrained(
            model, args.peft_model_name).merge_and_unload()
        tokenizer = AutoTokenizer.from_pretrained(base)
        dataset = RerankerInferenceDataset(
            pairs, args.query_path, args.corpus_path,
            query_prefix=args.query_prefix, doc_prefix=args.doc_prefix)
        if tokenizer.pad_token_id is None:
            tokenizer.pad_token_id = 0
        tokenizer.padding_side = "right"
        collator = RerankerInferenceCollator(tokenizer, args.max_length,
                                             args.pad_to_multiple_of)
        model.config.pad_token_id = tokenizer.pad_token_id
    else:
        model = AutoModelForSequenceClassification.from_pretrained(
            args.model_name_or_path)
        tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path)
        if args.is_beir and args.beir_dataset:
            dataset = BeirRerankDataset(
                os.path.join(args.beir_dataset_dir, args.beir_dataset),
                qid_docid_pairs=pairs)
        else:
            dataset = BertRerankerInferenceDataset(pairs, args.query_path,
                                                   args.corpus_path)
        collator = BertRerankerInferenceCollator(tokenizer, args.max_length)

    device = torch.device(args.device)
    model = model.to(device).eval()
    loader = DataLoader(dataset, args.eval_batch_size, collator,
                        rank=args.rank, world_size=args.world_size)
    out_run: dict = {}
    with torch.inference_mode():
        for batch in loader:
            toks = {k: torch.as_tensor(v, device=device)
                    for k, v in batch["tokenized_texts"].items()}
            logits = model(**toks, return_dict=True).logits.float().cpu()
            for qid, docid, row in zip(batch["qids"], batch["docids"],
                                       logits.tolist()):
                out_run.setdefault(str(qid), {})[str(docid)] = row[0]
    return out_run


def main(argv=None, model=None, tokenizer=None) -> dict:
    """Rerank and write the run; ``model`` and ``tokenizer`` go to the
    bi-encoder body."""
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    pairs = load_pairs(args)
    if args.rerank_type in BI_ENCODERS:
        out_run = bi_encoder_rerank(args, pairs, model, tokenizer)
    else:
        out_run = cross_encoder_rerank(args, pairs)
    name = "run.json" if args.world_size == 1 else f"run_{args.rank}.json"
    with open(os.path.join(args.output_dir, name), "w") as f:
        json.dump(out_run, f)
    return out_run


if __name__ == "__main__":
    main()
