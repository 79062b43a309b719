"""Bidirectional Qwen2 (port of models/qwen2.py).

Qwen2 is the Llama family with bias on the q/k/v projections, so the
port's Llama module covers it: a Qwen2 checkpoint loads with
``attention_qkv_bias=True``, which ``ModelConfig.from_hf_config`` infers
from ``model_type == "qwen2"``.
"""

from __future__ import annotations

from scaling_retriever_tpu_torch.models.config import ModelConfig


def qwen2_config(hf_cfg: dict, **overrides) -> ModelConfig:
    overrides.setdefault("attention_qkv_bias", True)
    return ModelConfig.from_hf_config(hf_cfg, **overrides)
