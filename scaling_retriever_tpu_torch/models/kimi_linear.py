"""Bidirectional Kimi-Linear (no counterpart in the JAX package): Kimi
Delta Attention (KDA) layers beside latent attention without position
encoding, a dense first layer, then routed (sigmoid, ``noaux_tc``) and
shared experts, with ``DeepseekV2BiForMNTP``'s surface (it is one, with
other layers): ``device``, ``forward_hidden``, ``forward_logits``, the
spans ``encoder.layers`` and ``encoder.head``, ``expert_load()``. So the
retriever classes, the pooling heads and the text frontend's tile graphs
take it as they are. Inference only (``deepseek_v2.InferenceOnly``).

The equations are HF's ``modeling_kimi.py`` for Kimi-Linear (Moonshot AI's
Kimi Linear report, arXiv:2510.26692). A layer is ``h += Mix(RMSNorm(h))``
then ``h += FFN(RMSNorm(h))``; after the last, a final RMSNorm and the
untied LM head. Mix is the layer's kind (``linear_attn_config``, 1-based
``kda_layers`` and ``full_attn_layers``):

* KDA, x the normed input, n heads of d (128): ``q, k, v = x W_q^T, x
  W_k^T, x W_v^T`` [S, n d], each through its own depthwise causal conv1d
  of width 4 (no bias) and SiLU; the per-channel log decay ``g =
  -exp(A_log[h]) softplus(x W_fa^T W_fb^T + dt_bias)`` and ``beta =
  sigmoid(x W_b^T)`` [S, n]; the gated delta rule (``ops/kda.py``: q and
  k L2-normalised, q times d**-0.5, a float32 state [d, d] a head, zero at
  the first position) gives o; then the gated norm ``RMSNorm_d(o) w_o *
  sigmoid(x W_ga^T W_gb^T + b_gb)`` (eps ``rms_norm_eps``) and ``W_o``.
  The recurrence runs causally, as published: the repository's encoders
  are bidirectional because the conversion removes attention masks, and a
  recurrence has no mask to remove, so only the latent-attention layers
  see the whole text.
* MLA: ``deepseek_v2.LatentAttention`` with ``mla_use_nope``: q_pe and
  k_pe keep their widths and are not rotated, scores times
  ``(dn + dr)**-0.5``, no causal mask, only ``llama.padding_bias``. The
  model holds no rope tables.
* FFN: a dense SwiGLU in the first ``first_k_dense_replace`` layers, then
  ``deepseek_v2.MoE`` under the sigmoid router with its correction bias,
  over the experts this card holds (``experts_held``).

Pads: a pad position's projections are zeroed before the convolutions
and its beta is 0, so, whichever side the tile pads on, no pad enters a
real position's convolution window or state: a text's reps are the same
alone as in any tile.

Chosen where the config and the report leave it open (the benchmark's
configuration lists them under ``assumed``): HF's tensor names and shapes
below (``A_log`` [1, 1, n, 1], each conv weight [n d, 1, 4]), a bias on
``W_gb`` and none on the other projections, the latent's RMSNorm eps 1e-6.

Statistics, softmaxes, gates and the recurrence's state run in float32.
Eager passes open ``encoder.kda`` over a KDA layer's mixing, and
``encoder.mla`` and ``encoder.moe`` as DeepSeek-V2's do (attrs ``layer``,
``tokens``).
"""

from __future__ import annotations

import re

import torch
from torch import nn

from scaling_retriever_tpu_torch.models import deepseek_v2
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.ops import kda
from scaling_retriever_tpu_torch.utils.profiling import profile_span


class DeltaAttention(nn.Module):
    """The KDA layer's mixing (see the module's docstring)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        la, h, dt = (config.linear_attn_config, config.hidden_size,
                     config.param_dtype)
        n, d, k = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
        w = n * d
        self.wq = nn.Linear(h, w, bias=False, dtype=dt)
        self.wk = nn.Linear(h, w, bias=False, dtype=dt)
        self.wv = nn.Linear(h, w, bias=False, dtype=dt)
        self.q_conv = nn.Parameter(torch.empty(w, 1, k, dtype=dt))
        self.k_conv = nn.Parameter(torch.empty(w, 1, k, dtype=dt))
        self.v_conv = nn.Parameter(torch.empty(w, 1, k, dtype=dt))
        self.A_log = nn.Parameter(torch.empty(1, 1, n, 1,
                                              dtype=torch.float32))
        self.wfa = nn.Linear(h, d, bias=False, dtype=dt)
        self.wfb = nn.Linear(d, w, bias=False, dtype=dt)
        self.dt_bias = nn.Parameter(torch.empty(w, dtype=torch.float32))
        self.wb = nn.Linear(h, n, bias=False, dtype=dt)
        self.wga = nn.Linear(h, d, bias=False, dtype=dt)
        self.wgb = nn.Linear(d, w, bias=True, dtype=dt)
        self.o_norm = nn.Parameter(torch.ones(d, dtype=dt))
        self.wo = nn.Linear(w, h, bias=False, dtype=dt)

    def forward(self, x, mask: torch.Tensor, config: ModelConfig):
        beta = torch.sigmoid(self.wb(x).float()) * mask[:, :, None]
        return self.wo(kda.delta_attention(
            self.wq(x), self.wk(x), self.wv(x), self.wfb(self.wfa(x)), beta,
            self.wgb(self.wga(x)), mask, self.q_conv, self.k_conv,
            self.v_conv, self.A_log, self.dt_bias, self.o_norm,
            config.rms_norm_eps))


class KimiLinearLayer(deepseek_v2.DeepseekV2Layer):
    """A KDA or an MLA layer, then a dense or an MoE FFN."""

    def attention(self, config: ModelConfig, index: int) -> nn.Module:
        if config.is_kda_layer(index):
            return DeltaAttention(config)
        return super().attention(config, index)

    @property
    def is_kda(self) -> bool:
        return isinstance(self.attn, DeltaAttention)

    def mix(self, x, inputs: deepseek_v2.LayerInputs, config: ModelConfig):
        if not self.is_kda:
            return super().mix(x, inputs, config)
        with profile_span("encoder.kda", layer=self.index,
                          tokens=x.shape[0] * x.shape[1]):
            return self.attn(x, inputs.keep, config)


class KimiLinearBiForMNTP(deepseek_v2.DeepseekV2BiForMNTP):
    """Embeddings → Kimi-Linear layers (bidirectional latent attention,
    causal KDA) → final norm → untied LM head."""

    ARCH = "Kimi-Linear"
    LAYER = KimiLinearLayer


def empty_model(config: ModelConfig, device) -> KimiLinearBiForMNTP:
    """The module with uninitialized weights on ``device``, its load
    counters zeroed."""
    return deepseek_v2.empty_model(config, device, KimiLinearBiForMNTP)


# HF Kimi-Linear's tensor names (``modeling_kimi.py``): fragment of a layer
# -> the port's parameter there; an MLA layer's ``self_attn`` names are
# DeepSeek-V2's
HF_LAYER_NAMES = {
    **{k: v for k, v in deepseek_v2.HF_LAYER_NAMES.items()
       if not k.startswith("mlp.gate.") and ".shared_experts." not in k},
    "self_attn.k_proj.weight": "attn.wk.weight",
    "self_attn.v_proj.weight": "attn.wv.weight",
    "self_attn.q_conv1d.weight": "attn.q_conv",
    "self_attn.k_conv1d.weight": "attn.k_conv",
    "self_attn.v_conv1d.weight": "attn.v_conv",
    "self_attn.A_log": "attn.A_log",
    "self_attn.f_a_proj.weight": "attn.wfa.weight",
    "self_attn.f_b_proj.weight": "attn.wfb.weight",
    "self_attn.dt_bias": "attn.dt_bias",
    "self_attn.b_proj.weight": "attn.wb.weight",
    "self_attn.g_a_proj.weight": "attn.wga.weight",
    "self_attn.g_b_proj.weight": "attn.wgb.weight",
    "self_attn.g_b_proj.bias": "attn.wgb.bias",
    "self_attn.o_norm.weight": "attn.o_norm",
    "block_sparse_moe.gate.weight": "mlp.gate.weight",
    "block_sparse_moe.gate.e_score_correction_bias":
        "mlp.gate.e_score_correction_bias",
    "block_sparse_moe.shared_experts.gate_proj.weight":
        "mlp.shared.wg.weight",
    "block_sparse_moe.shared_experts.up_proj.weight": "mlp.shared.wu.weight",
    "block_sparse_moe.shared_experts.down_proj.weight":
        "mlp.shared.wd.weight",
}
# an expert's projections, Mixtral's names: w1 gate, w3 up, w2 down
HF_EXPERT = re.compile(r"block_sparse_moe\.experts\.(\d+)\.(w1|w2|w3)\.weight")
HF_EXPERT_KINDS = {"w1": "gate", "w3": "up", "w2": "down"}


def hf_target(key: str, config: ModelConfig):
    """``deepseek_v2.hf_target`` under Kimi-Linear's names."""
    return deepseek_v2.hf_target(key, config, HF_LAYER_NAMES, HF_EXPERT,
                                 HF_EXPERT_KINDS)
