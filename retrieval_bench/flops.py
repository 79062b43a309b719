"""The yardstick's arithmetic: the card's peaks, the model FLOPs of an
encode and of a training micro step, and the bytes a retrieval needs.

Peaks are NVIDIA's H100 SXM data sheet's (dense, without sparsity):
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from retrieval_bench import gen

BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
POSTING_BYTES = 8          # f32 layout: int32 row + f32 value
RESULT_BYTES = 8           # a top-k entry: f32 score + int32 row


def _layer_mats(m: dict) -> int:
    """Multiply-adds of one layer's projections per token."""
    h, i = m["hidden_size"], m["intermediate_size"]
    q = m["num_attention_heads"] * gen.head_dim(m)
    kv = m["num_key_value_heads"] * gen.head_dim(m)
    return 2 * h * q + 2 * h * kv + 3 * h * i


def encode_flops(m: dict, n_tokens: int) -> float:
    """Forward FLOPs of encoding one text of ``n_tokens`` (no padding):
    the layers' projections, the attention products (QK^T and PV over the
    text's own tokens) and the vocabulary head."""
    q = m["num_attention_heads"] * gen.head_dim(m)
    layers = m["num_hidden_layers"] * (
        2 * n_tokens * _layer_mats(m) + 4 * n_tokens * n_tokens * q)
    head = 2 * n_tokens * m["hidden_size"] * m["vocab_size"]
    return float(layers + head)


def train_flops(m: dict, groups, remat: bool) -> float:
    """Model FLOPs of one micro step over ``groups`` of (rows, tokens) (a
    frozen copy of the port's ``benches/common.py`` ``model_flops``): the
    layers' projections and attention products and the LM head, each
    forward and backward to the activations (the base is frozen; the LoRA
    factors' own products, under 1%, are left out); full remat runs the
    layers' forward once more."""
    q = m["num_attention_heads"] * gen.head_dim(m)
    layers = head = 0
    for rows, seq in groups:
        layers += 2 * rows * seq * m["num_hidden_layers"] * (
            _layer_mats(m) + 2 * seq * q)
        head += 2 * rows * seq * m["vocab_size"] * m["hidden_size"]
    return float(layers * (3 if remat else 2) + head * 2)


def retrieval_bytes(postings: int, queries: int, k: int) -> int:
    """The least bytes a retrieval moves: each posting of each query's
    terms read once, each query's top-k written once."""
    return postings * POSTING_BYTES + queries * k * RESULT_BYTES
