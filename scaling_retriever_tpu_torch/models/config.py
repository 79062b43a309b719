"""Typed model configuration (port of models/config.py, torch dtypes).

Field names follow the HF ``config.json`` vocabulary. The defaults are the
Llama-3.2-1B widths, but ``rope_scaling`` defaults to None; the published
checkpoint uses llama3 scaling, which ``LLAMA_3_2_1B`` carries. The
DeepSeek-V2 fields (latent attention and the mixture of experts,
``models/deepseek_v2.py``) and the Kimi-Linear ones (its delta-rule
layers, NoPE latent attention and sigmoid router, ``models/kimi_linear.py``)
default to values that change nothing for the Llama family; a setting of
either the port does not implement raises, naming its key.

Kimi-Linear's ``config.json`` names its experts in its own words
(``num_experts``, ``num_experts_per_token``, ...); ``from_hf_config`` reads
them into the DeepSeek-V2 fields. A config that holds a share of each
expert layer's experts (one card of several that split the layer) says so
under ``expert_share``: ``{"router_experts": <the published count>,
"first_held": <the first expert held here>}``, its ``num_experts`` the
count held.
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


# Kimi-Linear's ``linear_attn_config`` keys the port implements
KIMI_LINEAR_ATTN_KEYS = {"full_attn_layers", "kda_layers", "head_dim",
                         "num_heads", "short_conv_kernel_size"}
# Kimi-Linear keys of settings the port does not implement (later Kimi
# models set them): raised on where set
KIMI_UNSUPPORTED = ("mla_use_output_gate", "attn_res_block_size",
                    "latent_moe_use_norm", "routed_expert_hidden_size",
                    "activation_situ_beta", "activation_situ_linear_beta")
# Kimi-Linear's names of the mixture-of-experts settings -> the fields
_KIMI_NAMES = {"num_experts": "n_routed_experts",
               "num_experts_per_token": "num_experts_per_tok",
               "num_shared_experts": "n_shared_experts",
               "moe_renormalize": "norm_topk_prob",
               "moe_router_activation_func": "scoring_func",
               "num_expert_group": "n_group"}


def _kimi_fields(cfg: dict) -> dict:
    """The fields a Kimi-Linear ``config.json`` sets under its own names:
    its router always picks by score plus a correction bias (DeepSeek-V3's
    ``noaux_tc``); ``expert_share`` (module docstring) gives the held
    range."""
    for key in KIMI_UNSUPPORTED:
        if cfg.get(key):
            raise NotImplementedError(f"Kimi-Linear {key}={cfg[key]!r}: the "
                                      f"port implements no such setting")
    if cfg.get("hidden_act", "silu") != "silu":
        raise NotImplementedError(f"Kimi-Linear hidden_act="
                                  f"{cfg['hidden_act']!r}: the port "
                                  f"implements silu only")
    out = {field: cfg[key] for key, field in _KIMI_NAMES.items()
           if key in cfg}
    out["topk_method"] = "noaux_tc"
    share = cfg.get("expert_share")
    if share:
        out["experts_held"] = (int(share["first_held"]),
                               int(cfg["num_experts"]))
        out["n_routed_experts"] = int(share["router_experts"])
    return out


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
    n_group: int = 1
    topk_group: int = 1
    # the experts this card holds, (first, count), of the router's
    # ``n_routed_experts``; None: all of them
    experts_held: Optional[tuple] = None
    # Kimi-Linear: the delta-rule layers and latent attention without rope
    linear_attn_config: Optional[dict] = None
    mla_use_nope: bool = False

    def __post_init__(self):
        if self.model_type == "kimi_linear":
            self._check_kimi()
            return
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

    def _check_kimi(self) -> None:
        la = self.linear_attn_config or {}
        layers = set(la.get("kda_layers", ())) | set(
            la.get("full_attn_layers", ()))
        unsupported = {
            "q_lora_rank": (self.q_lora_rank is not None,
                            "query compression"),
            "mla_use_nope": (not self.mla_use_nope,
                             "latent attention with rope"),
            "moe_router_activation_func": (self.scoring_func != "sigmoid",
                                           "router scores other than "
                                           "sigmoid"),
            "num_expert_group": (self.n_group != 1 or self.topk_group != 1,
                                 "top-k over several expert groups"),
            "linear_attn_config": (layers != set(range(
                1, self.num_hidden_layers + 1)), "a layer that is neither "
                "a delta-rule nor a full-attention layer"),
        }
        for key in sorted(set(la) - KIMI_LINEAR_ATTN_KEYS):
            unsupported[f"linear_attn_config.{key}"] = (True, "such setting")
        for key, (bad, what) in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"Kimi-Linear {key}: the port implements no {what}")

    def is_kda_layer(self, i: int) -> bool:
        """Whether layer ``i`` (0-based) is a Kimi Delta Attention layer
        (``linear_attn_config["kda_layers"]`` counts from 1)."""
        return (self.linear_attn_config is not None
                and i + 1 in self.linear_attn_config["kda_layers"])

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
        if cfg.get("model_type") == "kimi_linear":
            kwargs.update(_kimi_fields(cfg))
        kwargs.update(overrides)
        return cls(**kwargs)

    @property
    def experts_here(self) -> int:
        """The routed experts this card holds."""
        return (self.experts_held[1] if self.experts_held
                else self.n_routed_experts or 0)

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
