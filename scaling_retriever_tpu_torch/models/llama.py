"""Bidirectional Llama-3 transformer (port of models/llama.py) as an
``nn.Module``.

Non-causality is the absence of a causal term in the additive attention
bias: the only mask is the key-padding mask from ``attention_mask``. The
bias is finite (``MASK_VALUE``) and softmax runs in float32, so a fully
masked row (an all-pad query) gets a uniform softmax rather than NaN, as in
the reference. RMSNorm statistics and rope also run in float32. Position
ids are ``arange(seq_len)`` including pad positions.

Projections are ``nn.Linear`` modules (weight [out, in]); the JAX package
stores [in, out] and ``models/weights.py`` transposes on the way in. LoRA
factors (the reference's stacked ``{"a": [L, in, r], "b": [L, r, out]}``
layout) ride as an optional additive branch for inference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scaling_retriever_tpu_torch.models.config import ModelConfig

MASK_VALUE = -1e9


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with float32 statistics (HF LlamaRMSNorm numerics)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def rope_inv_freq(config: ModelConfig) -> torch.Tensor:
    """Inverse frequencies (float32, CPU), with HF-compatible llama3 and
    linear rope scaling."""
    hd = config.head_dim_
    inv_freq = 1.0 / (config.rope_theta
                      ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    rs = config.rope_scaling
    if rs is None:
        return inv_freq
    rope_type = rs.get("rope_type", rs.get("type", "default"))
    if rope_type in ("default", None):
        return inv_freq
    if rope_type == "linear":
        return inv_freq / rs["factor"]
    if rope_type == "llama3":
        factor = rs["factor"]
        low = rs["low_freq_factor"]
        high = rs["high_freq_factor"]
        old_len = rs["original_max_position_embeddings"]
        low_wavelen = old_len / low
        high_wavelen = old_len / high
        wavelen = 2 * math.pi / inv_freq
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low) / (high - low)
        smoothed = (1 - smooth) * scaled / factor + smooth * scaled
        is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        return torch.where(is_medium, smoothed, scaled)
    raise NotImplementedError(f"rope_scaling type {rope_type!r}")


def rope_cos_sin(config: ModelConfig, seq_len: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """[seq_len, head_dim] float32 cos/sin tables (HF layout: freqs
    doubled)."""
    inv_freq = rope_inv_freq(config).to(device)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = pos[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, N, hd]; cos/sin [S, hd]. Computed in float32, cast back."""
    xf = x.float()
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def dense(x: torch.Tensor, linear: nn.Linear, lora: Optional[dict] = None,
          lora_scale: float = 0.0) -> torch.Tensor:
    """``linear(x)`` plus an optional LoRA branch ``(x @ A) @ B * s``."""
    y = linear(x)
    if lora is not None:
        y = y + (x @ lora["a"].to(x.dtype)) @ lora["b"].to(x.dtype) * lora_scale
    return y


def padding_bias(attention_mask: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """[B, S] {0,1} key-padding mask → additive bias [B, 1, 1, S]."""
    keep = attention_mask[:, None, None, :].bool()
    return torch.where(keep, 0.0, MASK_VALUE).to(dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """GQA attention, logits and softmax in float32. q [B, S, Nq, hd], k/v
    [B, S, Nkv, hd] → [B, S, Nq * hd]."""
    b_, s, nq, hd = q.shape
    rep = nq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd)) + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v)
    return out.reshape(b_, s, nq * hd)


class LlamaLayer(nn.Module):
    """Pre-norm attention + SwiGLU MLP, bidirectional."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        h, q, kv, i = (config.hidden_size, config.q_dim, config.kv_dim,
                       config.intermediate_size)
        dt = config.param_dtype
        bias = config.attention_qkv_bias
        self.wq = nn.Linear(h, q, bias=bias, dtype=dt)
        self.wk = nn.Linear(h, kv, bias=bias, dtype=dt)
        self.wv = nn.Linear(h, kv, bias=bias, dtype=dt)
        self.wo = nn.Linear(q, h, bias=False, dtype=dt)
        self.wg = nn.Linear(h, i, bias=False, dtype=dt)
        self.wu = nn.Linear(h, i, bias=False, dtype=dt)
        self.wd = nn.Linear(i, h, bias=False, dtype=dt)
        self.input_norm = nn.Parameter(torch.ones(h, dtype=dt))
        self.post_attn_norm = nn.Parameter(torch.ones(h, dtype=dt))

    def forward(self, h, bias, cos, sin, config: ModelConfig,
                lora: Optional[dict] = None, lora_scale: float = 0.0):
        b_, s, _ = h.shape
        nq, nkv, hd = (config.num_attention_heads,
                       config.num_key_value_heads, config.head_dim_)

        def dn(x, name, group):
            fac = None if lora is None else lora.get(group, {}).get(name)
            return dense(x, getattr(self, name), fac, lora_scale)

        x = rms_norm(h, self.input_norm, config.rms_norm_eps)
        q = dn(x, "wq", "attn").reshape(b_, s, nq, hd)
        k = dn(x, "wk", "attn").reshape(b_, s, nkv, hd)
        v = dn(x, "wv", "attn").reshape(b_, s, nkv, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        h = h + dn(attention(q, k, v, bias, config), "wo", "attn")
        x = rms_norm(h, self.post_attn_norm, config.rms_norm_eps)
        mid = F.silu(dn(x, "wg", "mlp")) * dn(x, "wu", "mlp")
        return h + dn(mid, "wd", "mlp")


def _layer_lora(lora: Optional[dict], i: int) -> Optional[dict]:
    """Layer i's factors from the stacked layout."""
    if lora is None or "layers" not in lora:
        return None
    return {g: {n: {"a": f["a"][i], "b": f["b"][i]} for n, f in mods.items()}
            for g, mods in lora["layers"].items()}


class LlamaBiForMNTP(nn.Module):
    """Embeddings → bidirectional layers → final norm → LM head (tied to
    the embeddings when ``tie_word_embeddings``)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        dt = config.param_dtype
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, dtype=dt)
        self.layers = nn.ModuleList(LlamaLayer(config)
                                    for _ in range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(config.hidden_size, dtype=dt))
        self.lm_head = (None if config.tie_word_embeddings
                        else nn.Linear(config.hidden_size, config.vocab_size,
                                       bias=False, dtype=dt))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward_hidden(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       lora: Optional[dict] = None,
                       lora_scale: float = 0.0) -> torch.Tensor:
        """[B, S] ids and mask → final-norm hidden states [B, S, H]."""
        cfg = self.config
        h = self.embed_tokens(input_ids.long()).to(cfg.dtype)
        bias = padding_bias(attention_mask)
        cos, sin = rope_cos_sin(cfg, input_ids.shape[1], h.device)
        for i, layer in enumerate(self.layers):
            h = layer(h, bias, cos, sin, cfg, _layer_lora(lora, i), lora_scale)
        return rms_norm(h, self.final_norm, cfg.rms_norm_eps)

    def forward_logits(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       lora: Optional[dict] = None,
                       lora_scale: float = 0.0) -> torch.Tensor:
        """LM-head logits [B, S, V]."""
        h = self.forward_hidden(input_ids, attention_mask, lora, lora_scale)
        if self.lm_head is None:
            return F.linear(h, self.embed_tokens.weight.to(h.dtype))
        head_lora = None if lora is None else lora.get("lm_head")
        return dense(h, self.lm_head, head_lora, lora_scale)
