"""Bidirectional Mistral (port of models/mistral.py).

Mistral is the Llama family (GQA, RMSNorm, SwiGLU, RoPE, no attention
bias); its sliding window (4096) exceeds every retrieval sequence length,
and a bidirectional encoder has no causal window to slide, so the port's
Llama module covers it.
"""

from __future__ import annotations

from scaling_retriever_tpu_torch.models.config import ModelConfig


def mistral_config(hf_cfg: dict, **overrides) -> ModelConfig:
    return ModelConfig.from_hf_config(hf_cfg, **overrides)
