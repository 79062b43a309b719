"""Bidirectional DeepSeek-V2 (no counterpart in the JAX package): latent
attention (MLA) and a mixture of routed and shared experts, with the same
surface as ``LlamaBiForMNTP`` (``device``, ``forward_hidden``,
``forward_logits``, the spans ``encoder.layers`` and ``encoder.head``), so
the retriever classes, the pooling heads and the text frontend's tile
graphs take it as they are. Inference only: a LoRA, a ``part`` of a
step over several ranks or tensor parallelism raises.

The equations are HF's ``modeling_deepseek.py`` for DeepSeek-V2, without
the causal mask (the only mask is the key padding bias,
``llama.padding_bias``). A layer is ``h += Attn(RMSNorm(h))`` then
``h += FFN(RMSNorm(h))``; after the last, a final RMSNorm and the LM head.

* MLA, with no query compression: ``q = x W_q^T`` [S, n, dn + dr] split
  into q_nope and q_pe; ``x W_kva^T`` [S, r + dr] split into the latent c
  and one rope key k_pe that all heads share; ``RMSNorm(c) W_kvb^T`` [S,
  n, dn + dv] split into k_nope and v. Rope goes on q_pe and k_pe in
  DeepSeek-V2's layout: the last dimension de-interleaved (even entries,
  then odd), then rotate-half. Scores ``q_nope . k_nope + q_pe . k_pe``
  times ``(dn + dr)**-0.5 * mscale**2`` (yarn's ``mscale_all_dim``), a
  float32 softmax over the keys, ``P v`` through ``W_o``.
* The FFN: a dense SwiGLU in the first ``first_k_dense_replace`` layers;
  in the others a router (float32 logits ``x W_r^T`` over the E experts,
  softmax, greedy top-k, no renormalisation unless ``norm_topk_prob``,
  times ``routed_scaling_factor``), ``sum_j w_j E_{e_j}(x)`` over the
  routed experts (``ops/moe.py``: device-side routing and grouped
  products, one captured graph for every routing) plus the shared experts,
  one SwiGLU of width ``n_shared_experts * moe_intermediate_size``.

Statistics and the softmaxes run in float32, rope too, as ``llama.py``
does. The rope tables come from ``llama.rope_cos_sin`` through the
module's attribute, which ``models/tile_graphs.py`` replaces while it
captures. Each MoE layer adds its experts' slot counts to the model's
``expert_load_counts`` [MoE layers, E] on the device (``expert_load()``
reads it, ``reset_expert_load()`` zeroes it; neither is on the serving
path). In eager passes each layer opens the spans ``encoder.mla`` and
``encoder.moe`` (attrs ``layer``, ``tokens``: the positions of the pass,
pads included); a graph's replay runs no host code.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scaling_retriever_tpu_torch.models import llama
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.ops import moe
from scaling_retriever_tpu_torch.utils.profiling import profile_span

KV_NORM_EPS = 1e-6     # HF's DeepseekV2RMSNorm default, on the latent


def softmax_scale(config: ModelConfig) -> float:
    """``(dn + dr)**-0.5``, times yarn's ``mscale(factor, mscale_all_dim)``
    squared where the config sets it."""
    scale = (config.qk_nope_head_dim + config.qk_rope_head_dim) ** -0.5
    rs = config.rope_scaling or {}
    if rs.get("mscale_all_dim"):
        m = llama.yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def apply_rope_deinterleaved(x: torch.Tensor, cos: torch.Tensor,
                             sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V2's rope: x [B, S, N, d] with its last dimension read as
    d/2 (even, odd) pairs, de-interleaved to (evens, odds), then
    rotate-half (``llama.apply_rope``)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    return llama.apply_rope(x, cos, sin)


class SwiGLU(nn.Module):
    """``W_d (silu(W_g x) * W_u x)``: the dense layers' FFN and the shared
    experts."""

    def __init__(self, h: int, i: int, dtype):
        super().__init__()
        self.wg = nn.Linear(h, i, bias=False, dtype=dtype)
        self.wu = nn.Linear(h, i, bias=False, dtype=dtype)
        self.wd = nn.Linear(i, h, bias=False, dtype=dtype)

    def forward(self, x):
        return self.wd(F.silu(self.wg(x)) * self.wu(x))


class LatentAttention(nn.Module):
    """MLA without query compression (see the module's docstring)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        c, dt = config, config.param_dtype
        n = c.num_attention_heads
        self.wq = nn.Linear(c.hidden_size,
                            n * (c.qk_nope_head_dim + c.qk_rope_head_dim),
                            bias=False, dtype=dt)
        self.wkv_a = nn.Linear(c.hidden_size,
                               c.kv_lora_rank + c.qk_rope_head_dim,
                               bias=False, dtype=dt)
        self.kv_norm = nn.Parameter(torch.ones(c.kv_lora_rank, dtype=dt))
        self.wkv_b = nn.Linear(c.kv_lora_rank,
                               n * (c.qk_nope_head_dim + c.v_head_dim),
                               bias=False, dtype=dt)
        self.wo = nn.Linear(n * c.v_head_dim, c.hidden_size, bias=False,
                            dtype=dt)

    def forward(self, x, bias, cos, sin, config: ModelConfig):
        b, s, _ = x.shape
        n, dn = config.num_attention_heads, config.qk_nope_head_dim
        dr, dv = config.qk_rope_head_dim, config.v_head_dim
        q_nope, q_pe = self.wq(x).view(b, s, n, dn + dr).split([dn, dr], -1)
        c, k_pe = self.wkv_a(x).split([config.kv_lora_rank, dr], -1)
        kv = self.wkv_b(llama.rms_norm(c, self.kv_norm, KV_NORM_EPS))
        k_nope, v = kv.view(b, s, n, dn + dv).split([dn, dv], -1)
        q_pe = apply_rope_deinterleaved(q_pe, cos, sin)
        k_pe = apply_rope_deinterleaved(k_pe.view(b, s, 1, dr), cos, sin)
        logits = (torch.einsum("bqnd,bknd->bnqk", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqnd,bkd->bnqk", q_pe.float(),
                                 k_pe[:, :, 0].float()))
        logits = logits * softmax_scale(config) + bias.float()
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", probs, v)
        return self.wo(out.reshape(b, s, n * dv))


class Router(nn.Module):
    """HF DeepSeek-V2's ``MoEGate`` (softmax scores, greedy top-k):
    x [N, H] → (weights f32 [N, k], expert ids int64 [N, k])."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.weight = nn.Parameter(torch.empty(
            config.n_routed_experts, config.hidden_size,
            dtype=config.param_dtype))

    def forward(self, x):
        c = self.config
        scores = F.linear(x.float(), self.weight.float()).softmax(dim=-1)
        w, ids = torch.topk(scores, c.num_experts_per_tok, dim=-1)
        if c.num_experts_per_tok > 1 and c.norm_topk_prob:
            return w / (w.sum(dim=-1, keepdim=True) + 1e-20), ids
        return w * c.routed_scaling_factor, ids


class MoE(nn.Module):
    """Routed experts (stacked: ``w_gu`` [E, 2I, H], each expert's gate
    rows then its up rows; ``w_d`` [E, H, I]) plus the shared experts."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        c, dt = config, config.param_dtype
        e, h, i = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.gate = Router(config)
        self.w_gu = nn.Parameter(torch.empty(e, 2 * i, h, dtype=dt))
        self.w_d = nn.Parameter(torch.empty(e, h, i, dtype=dt))
        self.shared = SwiGLU(h, i * c.n_shared_experts, dt)

    def forward(self, x, load: Optional[torch.Tensor] = None):
        xt = x.reshape(-1, x.shape[-1])
        w, ids = self.gate(xt)
        out = moe.routed_experts(xt, ids, w, self.w_gu, self.w_d,
                                 self.shared(xt), load)
        return out.view(x.shape)


class DeepseekV2Layer(nn.Module):
    def __init__(self, config: ModelConfig, index: int):
        super().__init__()
        h, dt = config.hidden_size, config.param_dtype
        self.index = index
        self.attn = LatentAttention(config)
        self.is_moe = config.is_moe_layer(index)
        self.mlp = (MoE(config) if self.is_moe
                    else SwiGLU(h, config.intermediate_size, dt))
        self.input_norm = nn.Parameter(torch.ones(h, dtype=dt))
        self.post_attn_norm = nn.Parameter(torch.ones(h, dtype=dt))

    def forward(self, h, bias, cos, sin, config: ModelConfig,
                load: Optional[torch.Tensor]):
        eps = config.rms_norm_eps
        tokens = h.shape[0] * h.shape[1]
        with profile_span("encoder.mla", layer=self.index, tokens=tokens):
            h = h + self.attn(llama.rms_norm(h, self.input_norm, eps), bias,
                              cos, sin, config)
        x = llama.rms_norm(h, self.post_attn_norm, eps)
        if not self.is_moe:
            return h + self.mlp(x)
        with profile_span("encoder.moe", layer=self.index, tokens=tokens):
            return h + self.mlp(x, load)


def _inference_only(lora, part) -> None:
    if lora is not None:
        raise NotImplementedError("DeepSeek-V2 runs inference only in the "
                                  "port: it takes no LoRA")
    if part is not None:
        raise NotImplementedError("DeepSeek-V2 runs inference only in the "
                                  "port: it takes no part of a step over "
                                  "several ranks")


class DeepseekV2BiForMNTP(nn.Module):
    """Embeddings → bidirectional DeepSeek-V2 layers → final norm → LM head
    (tied to the embeddings when ``tie_word_embeddings``)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        dt = config.param_dtype
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, dtype=dt)
        self.layers = nn.ModuleList(DeepseekV2Layer(config, i) for i in
                                    range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(config.hidden_size,
                                                  dtype=dt))
        self.lm_head = (None if config.tie_word_embeddings
                        else nn.Linear(config.hidden_size, config.vocab_size,
                                       bias=False, dtype=dt))
        n_moe = sum(layer.is_moe for layer in self.layers)
        self.register_buffer("expert_load_counts", torch.zeros(
            n_moe, config.n_routed_experts or 0, dtype=torch.int64),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def expert_load(self) -> torch.Tensor:
        """[MoE layers, E] slots routed to each expert since the last
        reset, read to the host (a device sync)."""
        return self.expert_load_counts.cpu()

    def reset_expert_load(self) -> None:
        self.expert_load_counts.zero_()

    def forward_hidden(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, lora=None,
                       lora_scale: float = 0.0, lora_dropout: float = 0.0,
                       dropout_seed: Optional[int] = None,
                       part=None) -> torch.Tensor:
        """[B, S] ids and mask → final-norm hidden states [B, S, H]; the
        span ``encoder.layers`` covers the embedding, the layers and the
        final norm."""
        _inference_only(lora, part)
        cfg = self.config
        with profile_span("encoder.layers"):
            h = self.embed_tokens(input_ids.long()).to(cfg.dtype)
            bias = llama.padding_bias(attention_mask)
            cos, sin = llama.rope_cos_sin(cfg, input_ids.shape[1], h.device)
            at = 0
            for layer in self.layers:
                load = None
                if layer.is_moe:
                    load = self.expert_load_counts[at]
                    at += 1
                h = layer(h, bias, cos, sin, cfg, load)
            return llama.rms_norm(h, self.final_norm, cfg.rms_norm_eps)

    def forward_logits(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, lora=None,
                       lora_scale: float = 0.0, lora_dropout: float = 0.0,
                       dropout_seed: Optional[int] = None,
                       part=None) -> torch.Tensor:
        """LM-head logits [B, S, V]."""
        h = self.forward_hidden(input_ids, attention_mask, lora, lora_scale,
                                lora_dropout, dropout_seed, part)
        with profile_span("encoder.head"):
            if self.lm_head is None:
                return F.linear(h, self.embed_tokens.weight.to(h.dtype))
            return self.lm_head(h)


def empty_model(config: ModelConfig, device) -> DeepseekV2BiForMNTP:
    """The module with uninitialized weights on ``device`` (no init pass
    over weights that are overwritten anyway), its load counter zeroed."""
    with torch.device("meta"):
        model = DeepseekV2BiForMNTP(config)
    model = model.to_empty(device=device)
    model.requires_grad_(False)
    model.reset_expert_load()
    return model
