"""Typed model configuration (port of models/config.py, torch dtypes).

Field names follow the HF ``config.json`` vocabulary. The defaults are the
Llama-3.2-1B widths, but ``rope_scaling`` defaults to None; the published
checkpoint uses llama3 scaling, which ``LLAMA_3_2_1B`` carries. The
DeepSeek-V2 fields (latent attention and the mixture of experts,
``models/deepseek_v2.py``) default to values that change nothing for the
Llama family; a DeepSeek-V2 setting the port does not implement raises,
naming its key.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

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
    # per-layer rematerialization under autograd, in the reference's
    # values: False (none), True (full: nothing saved inside a layer),
    # "dots_saveable" / "dots_with_no_batch_dims_saveable" (matmul outputs
    # saved; the latter not the attention products), or "names:..." over
    # the layer's named tensors (models/llama.py REMAT_NAMES)
    remat: Any = False
    # DeepSeek-V2: latent attention (MLA) ...
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    qk_rope_head_dim: Optional[int] = None
    v_head_dim: Optional[int] = None
    # ... and the mixture of experts
    n_routed_experts: Optional[int] = None
    n_shared_experts: Optional[int] = None
    num_experts_per_tok: Optional[int] = None
    moe_intermediate_size: Optional[int] = None
    first_k_dense_replace: int = 0
    moe_layer_freq: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    topk_method: str = "greedy"

    def __post_init__(self):
        if self.model_type != "deepseek_v2":
            return
        unsupported = {
            "q_lora_rank": (self.q_lora_rank is not None,
                            "query compression"),
            "scoring_func": (self.scoring_func != "softmax",
                             "router scores other than softmax"),
            "topk_method": (self.topk_method != "greedy",
                            "expert choice other than greedy top-k "
                            "(group-limited, noaux_tc)"),
        }
        for key, (bad, what) in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"DeepSeek-V2 {key}={getattr(self, key)!r}: the port "
                    f"implements no {what}")

    @property
    def head_dim_(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.hidden_size // self.num_attention_heads)

    @property
    def rope_dim(self) -> int:
        """The width rope rotates: DeepSeek-V2's rope part of a head, else
        the whole head."""
        return self.qk_rope_head_dim or self.head_dim_

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i`` runs the mixture of experts (HF
        DeepSeek-V2's rule)."""
        return (bool(self.n_routed_experts) and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)

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
        # newer config.json files name their storage dtype ("dtype":
        # "bfloat16"); the compute dtypes stay the caller's (the reference
        # takes the string as its activation dtype)
        for k in ("dtype", "param_dtype"):
            if isinstance(kwargs.get(k), str):
                del kwargs[k]
        # Qwen2 has bias on the q/k/v projections (HF hardwires it in
        # Qwen2Attention; the config carries no flag)
        if cfg.get("model_type") == "qwen2":
            kwargs.setdefault("attention_qkv_bias", True)
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_pretrained(cls, model_dir: str, **overrides) -> "ModelConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = json.load(f)
        return cls.from_hf_config(cfg, **overrides)

    def to_hf_config(self) -> dict:
        """The architecture fields as an HF-style ``config.json`` dict, the
        reference's field for field (any model type other than llama is
        labelled ``Qwen2ForCausalLM``, as the reference labels it)."""
        return {
            "architectures": ["LlamaForCausalLM" if self.model_type == "llama"
                              else "Qwen2ForCausalLM"],
            "model_type": self.model_type,
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "num_key_value_heads": self.num_key_value_heads,
            "head_dim": self.head_dim_,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_theta": self.rope_theta,
            "rope_scaling": self.rope_scaling,
            "max_position_embeddings": self.max_position_embeddings,
            "tie_word_embeddings": self.tie_word_embeddings,
        }
