"""Tiny configurations and mixes for driving the harness on the CPU."""

from __future__ import annotations

import copy

import torch

from retrieval_bench import run

SEED = 2 ** 31 + 12345

TINY_MODEL = {"model_type": "qwen2", "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "rms_norm_eps": 1e-6, "rope_theta": 1e6,
              "tie_word_embeddings": True, "vocab_size": 512,
              "max_position_embeddings": 4096}
TINY_INDEX = {"n_docs": 5000, "postings_per_doc": 16}


def tiny_conf(cell: str) -> dict:
    model = dict(TINY_MODEL)
    if cell.startswith("mistral"):
        model.update(model_type="mistral", tie_word_embeddings=False,
                     rms_norm_eps=1e-5, rope_theta=1e4)
        enc = "MistralBiSparse"
    else:
        enc = "Qwen2BiSparse"
    return {"model": model, "arch": "bidir_decoder", "encoder": enc,
            "index": dict(TINY_INDEX)}


def tiny_traffic(bench: dict, cell: str) -> dict:
    _, _, tr = run.cell_spec(bench, cell)
    tr = copy.deepcopy(tr)
    if tr["kind"] == "text_serving":
        tr.update(rate_qps=400, t_sparse=16, sample=8, word_bank=256)
    elif tr["kind"] == "train":
        tr.update(bz=2, n_negs=3, q_len=8, d_len=16)
    elif tr["kind"] == "stream":
        tr.update(pool=200, terms=12, t_budget=16, tile=16, topk=50,
                  sample=8)
    return tr


def run_tiny(cell: str, seconds: float = 0.5, trace: bool = False,
             control: bool = False, limits=None, root: str = run.ROOT,
             bench=None, seed: int = SEED) -> dict:
    bench = bench or run.load_json(root, "BENCHMARK.json")
    return run.run_cell(bench, cell, seed, seconds, trace,
                        torch.device("cpu"), root=root, control=control,
                        conf=tiny_conf(cell),
                        traffic=tiny_traffic(bench, cell),
                        limits=limits)
