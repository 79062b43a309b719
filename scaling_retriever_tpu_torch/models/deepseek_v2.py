"""Bidirectional DeepSeek-V2 (no counterpart in the JAX package): latent
attention (MLA) and a mixture of routed and shared experts, with the same
surface as ``LlamaBiForMNTP`` (``device``, ``forward_hidden``,
``forward_logits``, the spans ``encoder.layers`` and ``encoder.head``), so
the retriever classes, the pooling heads and the text frontend's tile
graphs take it as they are. Inference only (``InferenceOnly``, which
``models/kimi_linear.py`` shares): a LoRA, an adapter, a checkpoint to
write, a ``part`` of a step over several ranks or a sharding raises, and
the encoder classes and the partitioner ask the model rather than know
its type.

The equations are HF's ``modeling_deepseek.py`` for DeepSeek-V2, without
the causal mask (the only mask is the key padding bias,
``llama.padding_bias``). A layer is ``h += Attn(RMSNorm(h))`` then
``h += FFN(RMSNorm(h))``; after the last, a final RMSNorm and the LM head.

* MLA, with no query compression: ``q = x W_q^T`` [S, n, dn + dr] split
  into q_nope and q_pe; ``x W_kva^T`` [S, r + dr] split into the latent c
  and one rope key k_pe that all heads share; ``RMSNorm(c) W_kvb^T`` [S,
  n, dn + dv] split into k_nope and v. Rope goes on q_pe and k_pe in
  DeepSeek-V2's layout: the last dimension de-interleaved (even entries,
  then odd), then rotate-half; with ``mla_use_nope`` (Kimi-Linear) q_pe
  and k_pe keep their widths and are not rotated. Scores ``q_nope .
  k_nope + q_pe . k_pe`` times ``(dn + dr)**-0.5 * mscale**2`` (yarn's
  ``mscale_all_dim``), a float32 softmax over the keys, ``P v`` through
  ``W_o``.
* The FFN: a dense SwiGLU in the first ``first_k_dense_replace`` layers;
  in the others a router (float32 logits ``x W_r^T`` over the E experts,
  softmax, greedy top-k, no renormalisation unless ``norm_topk_prob``,
  times ``routed_scaling_factor``; or, with ``scoring_func`` "sigmoid"
  and ``topk_method`` "noaux_tc", DeepSeek-V3's gate: sigmoid scores, the
  top-k by score plus the per-expert ``e_score_correction_bias``, the
  chosen raw scores renormalised where ``norm_topk_prob`` and times
  ``routed_scaling_factor``), ``sum_j w_j E_{e_j}(x)`` over the routed
  experts this card holds (``experts_held``; slots routed elsewhere add
  nothing) (``ops/moe.py``: device-side routing and grouped
  products, one captured graph for every routing) plus the shared experts,
  one SwiGLU of width ``n_shared_experts * moe_intermediate_size``.

Statistics and the softmaxes run in float32, rope too, as ``llama.py``
does, from the model's ``llama.RopeTables`` (none under ``mla_use_nope``).
Each MoE layer adds its held experts' slot counts to the model's
``expert_load_counts`` [MoE layers, held] and its slots routed to experts
held elsewhere to ``expert_absent_counts`` [MoE layers], on the device
(``expert_load()`` and ``expert_absent()`` read them,
``reset_expert_load()`` zeroes both; none is on the serving path).

``hf_target`` maps HF's tensor names to the module's parameters, which
``hf_loader`` asks of the model module. In eager passes each layer
opens the spans ``encoder.mla`` and ``encoder.moe`` (attrs ``layer``,
``tokens``: the positions of the pass, pads included); a graph's replay
runs no host code.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scaling_retriever_tpu_torch.models import llama
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.ops import moe
from scaling_retriever_tpu_torch.utils.profiling import profile_span

KV_NORM_EPS = 1e-6     # HF's DeepseekV2RMSNorm default, on the latent


class InferenceOnly:
    """A model the port runs for inference only, named ``ARCH`` in what it
    raises. ``refuse(what)`` is the one rule: the model's forward, the
    encoder classes (a LoRA, an adapter, a checkpoint to write) and the
    partitioner (a sharding) call it."""

    ARCH = ""

    @classmethod
    def refuse(cls, what: str):
        raise NotImplementedError(f"{cls.ARCH} runs inference only in the "
                                  f"port: it takes no {what}")

    def check_inference(self, lora, part) -> None:
        if lora is not None:
            self.refuse("LoRA")
        if part is not None:
            self.refuse("part of a step over several ranks")


class LayerInputs(NamedTuple):
    """What every layer of a pass reads beside the hidden states."""

    bias: torch.Tensor          # [B, 1, 1, S] key padding bias
    keep: torch.Tensor          # [B, S] the real positions
    cos: Optional[torch.Tensor]
    sin: Optional[torch.Tensor]


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

    def forward(self, x, inputs: LayerInputs, config: ModelConfig):
        b, s, _ = x.shape
        n, dn = config.num_attention_heads, config.qk_nope_head_dim
        dr, dv = config.qk_rope_head_dim, config.v_head_dim
        q_nope, q_pe = self.wq(x).view(b, s, n, dn + dr).split([dn, dr], -1)
        c, k_pe = self.wkv_a(x).split([config.kv_lora_rank, dr], -1)
        kv = self.wkv_b(llama.rms_norm(c, self.kv_norm, KV_NORM_EPS))
        k_nope, v = kv.view(b, s, n, dn + dv).split([dn, dv], -1)
        k_pe = k_pe.view(b, s, 1, dr)
        if not config.mla_use_nope:
            q_pe = apply_rope_deinterleaved(q_pe, inputs.cos, inputs.sin)
            k_pe = apply_rope_deinterleaved(k_pe, inputs.cos, inputs.sin)
        logits = (torch.einsum("bqnd,bknd->bnqk", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqnd,bkd->bnqk", q_pe.float(),
                                 k_pe[:, :, 0].float()))
        logits = logits * softmax_scale(config) + inputs.bias.float()
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", probs, v)
        return self.wo(out.reshape(b, s, n * dv))


class Router(nn.Module):
    """HF DeepSeek-V2's ``MoEGate`` (softmax scores, greedy top-k), or
    with sigmoid scores DeepSeek-V3's ``noaux_tc`` gate (Kimi-Linear's):
    x [N, H] → (weights f32 [N, k], expert ids int64 [N, k]) over all the
    router's experts."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        e = config.n_routed_experts
        self.weight = nn.Parameter(torch.empty(
            e, config.hidden_size, dtype=config.param_dtype))
        if config.topk_method == "noaux_tc":
            self.e_score_correction_bias = nn.Parameter(
                torch.empty(e, dtype=torch.float32))

    def forward(self, x):
        c = self.config
        logits = F.linear(x.float(), self.weight.float())
        if c.scoring_func == "sigmoid":
            scores = logits.sigmoid()
            ids = torch.topk(scores + self.e_score_correction_bias,
                             c.num_experts_per_tok, dim=-1).indices
            w = scores.gather(-1, ids)
            if c.num_experts_per_tok > 1 and c.norm_topk_prob:
                w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
            return w * c.routed_scaling_factor, ids
        scores = logits.softmax(dim=-1)
        w, ids = torch.topk(scores, c.num_experts_per_tok, dim=-1)
        if c.num_experts_per_tok > 1 and c.norm_topk_prob:
            return w / (w.sum(dim=-1, keepdim=True) + 1e-20), ids
        return w * c.routed_scaling_factor, ids


class MoE(nn.Module):
    """Routed experts (stacked: ``w_gu`` [E, 2I, H], each expert's gate
    rows then its up rows; ``w_d`` [E, H, I]; E the experts this card
    holds) plus the shared experts."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        c, dt = config, config.param_dtype
        e, h, i = c.experts_here, c.hidden_size, c.moe_intermediate_size
        self.first = c.experts_held[0] if c.experts_held else 0
        self.gate = Router(config)
        self.w_gu = nn.Parameter(torch.empty(e, 2 * i, h, dtype=dt))
        self.w_d = nn.Parameter(torch.empty(e, h, i, dtype=dt))
        self.shared = SwiGLU(h, i * c.n_shared_experts, dt)

    def forward(self, x, load: Optional[torch.Tensor] = None,
                absent: Optional[torch.Tensor] = None):
        xt = x.reshape(-1, x.shape[-1])
        w, ids = self.gate(xt)
        out = moe.routed_experts(xt, ids, w, self.w_gu, self.w_d,
                                 self.shared(xt), load, self.first, absent)
        return out.view(x.shape)


class DeepseekV2Layer(nn.Module):
    def __init__(self, config: ModelConfig, index: int):
        super().__init__()
        h, dt = config.hidden_size, config.param_dtype
        self.index = index
        self.attn = self.attention(config, index)
        self.is_moe = config.is_moe_layer(index)
        self.mlp = (MoE(config) if self.is_moe
                    else SwiGLU(h, config.intermediate_size, dt))
        self.input_norm = nn.Parameter(torch.ones(h, dtype=dt))
        self.post_attn_norm = nn.Parameter(torch.ones(h, dtype=dt))

    def attention(self, config: ModelConfig, index: int) -> nn.Module:
        """Layer ``index``'s token mixing module."""
        return LatentAttention(config)

    def mix(self, x, inputs: LayerInputs, config: ModelConfig):
        """The layer's token mixing (its attention) of the normed x."""
        with profile_span("encoder.mla", layer=self.index,
                          tokens=x.shape[0] * x.shape[1]):
            return self.attn(x, inputs, config)

    def forward(self, h, inputs: LayerInputs, config: ModelConfig,
                load: Optional[torch.Tensor],
                absent: Optional[torch.Tensor] = None):
        eps = config.rms_norm_eps
        h = h + self.mix(llama.rms_norm(h, self.input_norm, eps), inputs,
                         config)
        x = llama.rms_norm(h, self.post_attn_norm, eps)
        if not self.is_moe:
            return h + self.mlp(x)
        with profile_span("encoder.moe", layer=self.index,
                          tokens=h.shape[0] * h.shape[1]):
            return h + self.mlp(x, load, absent)


class DeepseekV2BiForMNTP(InferenceOnly, nn.Module):
    """Embeddings → bidirectional DeepSeek-V2 layers → final norm → LM head
    (tied to the embeddings when ``tie_word_embeddings``)."""

    ARCH = "DeepSeek-V2"
    LAYER = DeepseekV2Layer

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        dt = config.param_dtype
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, dtype=dt)
        self.layers = nn.ModuleList(self.LAYER(config, i) for i in
                                    range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(config.hidden_size,
                                                  dtype=dt))
        self.lm_head = (None if config.tie_word_embeddings
                        else nn.Linear(config.hidden_size, config.vocab_size,
                                       bias=False, dtype=dt))
        n_moe = sum(layer.is_moe for layer in self.layers)
        self.register_buffer("expert_load_counts", torch.zeros(
            n_moe, config.experts_here, dtype=torch.int64), persistent=False)
        self.register_buffer("expert_absent_counts", torch.zeros(
            n_moe, dtype=torch.int64), persistent=False)
        self.rope = (None if config.mla_use_nope
                     else llama.RopeTables(config))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def expert_load(self) -> torch.Tensor:
        """[MoE layers, held] slots routed to each held expert since the
        last reset, read to the host (a device sync)."""
        return self.expert_load_counts.cpu()

    def expert_absent(self) -> torch.Tensor:
        """[MoE layers] slots routed to experts held elsewhere since the
        last reset, read to the host."""
        return self.expert_absent_counts.cpu()

    def reset_expert_load(self) -> None:
        self.expert_load_counts.zero_()
        self.expert_absent_counts.zero_()

    def forward_hidden(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, lora=None,
                       lora_scale: float = 0.0, lora_dropout: float = 0.0,
                       dropout_seed: Optional[int] = None,
                       part=None) -> torch.Tensor:
        """[B, S] ids and mask → final-norm hidden states [B, S, H]; the
        span ``encoder.layers`` covers the embedding, the layers and the
        final norm."""
        self.check_inference(lora, part)
        cfg = self.config
        with profile_span("encoder.layers"):
            h = self.embed_tokens(input_ids.long()).to(cfg.dtype)
            cos = sin = None
            if self.rope is not None:
                cos, sin = self.rope(input_ids.shape[1], h.device)
            inputs = LayerInputs(llama.padding_bias(attention_mask),
                                 attention_mask, cos, sin)
            at = 0
            for layer in self.layers:
                load = absent = None
                if layer.is_moe:
                    load = self.expert_load_counts[at]
                    absent = self.expert_absent_counts[at:at + 1]
                    at += 1
                h = layer(h, inputs, cfg, load, absent)
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


def empty_model(config: ModelConfig, device,
                cls=DeepseekV2BiForMNTP) -> DeepseekV2BiForMNTP:
    """The module (``cls``) with uninitialized weights on ``device`` (no
    init pass over weights that are overwritten anyway), its load counters
    zeroed."""
    with torch.device("meta"):
        model = cls(config)
    model = model.to_empty(device=device)
    model.requires_grad_(False)
    model.reset_expert_load()
    return model


# HF DeepSeek-V2's tensor names (``modeling_deepseek.py``): fragment of a
# layer -> the port's parameter there
HF_LAYER_NAMES = {
    "self_attn.q_proj.weight": "attn.wq.weight",
    "self_attn.kv_a_proj_with_mqa.weight": "attn.wkv_a.weight",
    "self_attn.kv_a_layernorm.weight": "attn.kv_norm",
    "self_attn.kv_b_proj.weight": "attn.wkv_b.weight",
    "self_attn.o_proj.weight": "attn.wo.weight",
    "mlp.gate_proj.weight": "mlp.wg.weight",
    "mlp.up_proj.weight": "mlp.wu.weight",
    "mlp.down_proj.weight": "mlp.wd.weight",
    "mlp.gate.weight": "mlp.gate.weight",
    "mlp.shared_experts.gate_proj.weight": "mlp.shared.wg.weight",
    "mlp.shared_experts.up_proj.weight": "mlp.shared.wu.weight",
    "mlp.shared_experts.down_proj.weight": "mlp.shared.wd.weight",
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_attn_norm",
}
HF_TOP_NAMES = {"embed_tokens.weight": "embed_tokens.weight",
                "norm.weight": "final_norm",
                "lm_head.weight": "lm_head.weight"}
# an expert's projection: (its index, "gate" | "up" | "down")
HF_EXPERT = re.compile(r"mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight")
LAYER_RE = re.compile(r"layers\.(\d+)\.")


def hf_target(key: str, config: ModelConfig, layer_names=HF_LAYER_NAMES,
              expert=HF_EXPERT, kinds=None) -> Optional[tuple]:
    """(parameter name, part) of the HF tensor ``key`` (its prefix such
    as ``model.`` stripped), or None where the module has no place for it:
    part None is the whole parameter, ("gate" | "up" | "down", e) held
    expert e's slice of the stacked ``w_gu`` [E, 2I, H] or ``w_d`` [E, H,
    I]. An expert held elsewhere has no place here. ``kinds`` maps the
    expert pattern's projection names to gate, up and down."""
    if key in HF_TOP_NAMES:
        return HF_TOP_NAMES[key], None
    m = LAYER_RE.search(key)
    if m is None:
        return None
    frag, layer = key[m.end():], f"layers.{m.group(1)}."
    if frag in layer_names:
        return layer + layer_names[frag], None
    ex = expert.fullmatch(frag)
    if ex is None:
        return None
    e = int(ex.group(1))
    if config.experts_held:
        first, held = config.experts_held
        if not first <= e < first + held:
            return None
        e -= first
    kind = (kinds or {}).get(ex.group(2), ex.group(2))
    return layer + ("mlp.w_d" if kind == "down" else "mlp.w_gu"), (kind, e)
