"""Sparse retriever training (port of training/train_sparse.py): the
dataset, collator and model by (model type, loss type), LoRA by default,
the regularizer ramp over ``max_steps // 3``, train, save the adapter.

    python -m scaling_retriever_tpu_torch.training.train_sparse \\
        --model_name_or_path CKPT --corpus_path corpus.tsv \\
        --train_path train.jsonl --output_dir OUT --loss_type nce \\
        --task_names rank query_reg doc_reg \\
        --task_weights 1.0 0.01 0.008 --max_steps 1050 [--device cuda]

The flags are the reference's, plus ``--device`` (default "cuda"). On one
card ``--fsdp`` trains replicated, as the reference does on a data axis of
one. ``--model_type t5`` trains T5Sparse (nce or margin_mse only, no
``--remat``, as in the reference) and saves a peft T5 adapter.

Over several cards, launch one process per card (the reference's launcher)::

    torchrun --nproc_per_node 8 -m \
        scaling_retriever_tpu_torch.training.train_sparse ... [--fsdp]

Each rank trains on ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``:
gloo on the CPU); the global batch is ``per_device_train_batch_size``
times the ranks, as the reference's over its devices, and rank 0 writes
the adapter.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from scaling_retriever_tpu_torch import constants
from scaling_retriever_tpu_torch.data import collators as C
from scaling_retriever_tpu_torch.data import datasets as D
from scaling_retriever_tpu_torch.data.loader import DataLoader
from scaling_retriever_tpu_torch.models.encoder import (MODEL_REGISTRY,
                                                        load_tokenizer)
from scaling_retriever_tpu_torch.parallel.mesh import (init_distributed,
                                                       make_mesh)
from scaling_retriever_tpu_torch.training.trainer import (
    REMAT, LLM2RetrieverTrainingArgs, Trainer)

DATASET_BY_LOSS = {
    "nce": D.DualEncoderDatasetForNCE,
    "margin_mse": D.DualEncoderDatasetForMarginMSE,
    "kldiv": D.DualEncoderDatasetForKLDiv,
    "nce_kldiv": D.DualEncoderDatasetForKLDiv,
}
COLLATOR_BY_LOSS = {
    "nce": C.LlamaSparseCollatorForNCE,
    "margin_mse": C.LlamaSparseCollatorForMarginMSE,
    "kldiv": C.LlamaSparseCollatorForKLDiv,
    "nce_kldiv": C.LlamaSparseCollatorForNCE_KLDiv,
}


def add_args(p: argparse.ArgumentParser, pooling: str) -> None:
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--model_type", default="llama",
                   choices=["llama", "qwen2", "mistral", "t5"])
    p.add_argument("--loss_type", default="nce",
                   choices=["nce", "margin_mse", "kldiv", "nce_kldiv"])
    p.add_argument("--corpus_path", required=True)
    p.add_argument("--train_path", required=True)
    p.add_argument("--data_source", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--task_names", nargs="*",
                   default=["rank", "query_reg", "doc_reg"]
                   if pooling == "sparse" else ["rank"])
    p.add_argument("--task_weights", nargs="*", type=float,
                   default=[1.0, 0.01, 0.008] if pooling == "sparse"
                   else [1.0])
    p.add_argument("--lora", action="store_true", default=True)
    p.add_argument("--no_lora", dest="lora", action="store_false")
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=int, default=32)
    p.add_argument("--lora_dropout", type=float, default=0.1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_ratio", type=float, default=0.04)
    p.add_argument("--max_steps", type=int, default=1000,
                   help="optimizer steps (HF semantics); <=0 uses epochs")
    p.add_argument("--num_train_epochs", type=float, default=3.0)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--n_negs", type=int, default=1)
    p.add_argument("--query_max_length", type=int, default=64)
    p.add_argument("--doc_max_length", type=int, default=128)
    p.add_argument("--T", type=float, default=0.01)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--loss_scale", type=float, default=1.0)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--fixed_length", action="store_true",
                   help="pad to max length (one tensor shape per length)")
    p.add_argument("--remat", default="none", choices=list(REMAT),
                   help="layer activation rematerialization: none, full "
                        "(each layer recomputed in the backward), dots / "
                        "dots_nb (matmul outputs saved, with or without the "
                        "attention products), attn / attn_mlp (the named "
                        "attention tensors, and the SwiGLU mid, saved)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")


def build_training(argv, pooling: str, tokenizer=None):
    """(Trainer, parsed args) from the CLI's flags. ``tokenizer`` replaces
    the checkpoint's own (loaded by ``transformers``) when given."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_args(parser, pooling)
    ns = parser.parse_args(argv)
    if ns.model_type == "t5" and ns.loss_type not in ("nce", "margin_mse"):
        parser.error("t5 supports loss_type nce|margin_mse only")
    if ns.model_type == "t5" and REMAT[ns.remat]:
        parser.error("--remat applies to the decoder-only stacks; the T5 "
                     "checkpoints trained here fit without it")

    fields = {f.name for f in dataclasses.fields(LLM2RetrieverTrainingArgs)}
    args = LLM2RetrieverTrainingArgs(
        **{k: v for k, v in vars(ns).items() if k in fields})
    if tokenizer is None:
        tokenizer = load_tokenizer(ns.model_name_or_path)
    source = ns.data_source or constants.guess_data_source(ns.corpus_path)
    ds_cls = DATASET_BY_LOSS[ns.loss_type]
    if ns.loss_type == "margin_mse":
        dataset = ds_cls(ns.corpus_path, ns.train_path, source, seed=ns.seed)
    else:
        dataset = ds_cls(ns.corpus_path, ns.train_path, source,
                         n_negs=ns.n_negs, seed=ns.seed)
    collator = COLLATOR_BY_LOSS[ns.loss_type](
        tokenizer, ns.query_max_length, ns.doc_max_length,
        fixed_length=ns.fixed_length)

    # under torchrun: this rank's card (or the CPU), the mesh over ranks
    mesh = make_mesh(device=init_distributed(ns.device))
    global_bs = ns.per_device_train_batch_size * mesh.shape["data"]
    loader = DataLoader(dataset, global_bs, collator, shuffle=True,
                        seed=ns.seed, drop_last=True)
    dt = torch.bfloat16 if ns.bf16 else torch.float32
    model_cls = MODEL_REGISTRY[(ns.model_type, pooling, ns.loss_type)]
    remat = {} if ns.model_type == "t5" else {"remat": REMAT[ns.remat]}
    encoder = model_cls.build(ns.model_name_or_path, args, device=mesh.device,
                              param_dtype=dt, dtype=dt, **remat)
    return Trainer(encoder, args, loader, mesh=mesh), ns


def main(argv=None, pooling: str = "sparse", tokenizer=None):
    joined = torch.distributed.is_initialized()
    trainer, ns = build_training(argv, pooling, tokenizer)
    trainer.train()
    trainer.save_model(ns.output_dir)
    if not joined and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
