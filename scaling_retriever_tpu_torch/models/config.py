"""Typed model configuration (port of models/config.py, torch dtypes).

Field names follow the HF ``config.json`` vocabulary. The defaults are the
Llama-3.2-1B widths, but ``rope_scaling`` defaults to None; the published
checkpoint uses llama3 scaling, which ``LLAMA_3_2_1B`` carries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# meta-llama/Llama-3.2-1B config.json, the fields this package reads
LLAMA_3_2_1B = {
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 2048,
    "intermediate_size": 8192,
    "num_hidden_layers": 16,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 64,
    "rms_norm_eps": 1e-05,
    "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "max_position_embeddings": 131072,
    "tie_word_embeddings": True,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a Llama-style transformer."""

    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True
    attention_qkv_bias: bool = False
    model_type: str = "llama"
    dtype: torch.dtype = torch.float32        # activation dtype
    param_dtype: torch.dtype = torch.float32  # parameter storage dtype

    @property
    def head_dim_(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.hidden_size // self.num_attention_heads)

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim_

    @classmethod
    def from_hf_config(cls, cfg: dict, **overrides) -> "ModelConfig":
        """Build from a parsed HF ``config.json`` dict."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        kwargs.update(overrides)
        return cls(**kwargs)
