"""Kimi-Linear (Kimi Delta Attention layers beside latent attention
without rope, a dense first layer, then sigmoid-routed and shared
experts) as a sparse encoder: the port's ``KimiLinearBiForMNTP`` under the
configuration's encoder class, holding this card's share of each expert
layer's experts, its plain reference in ``reference/kimi_linear.py`` and
its FLOP count. The interface is ``bidir_decoder.py``'s docstring; there
are no training functions, so a training cell of this architecture ends
at ``run.load_arch``. A port without the architecture
(``models/kimi_linear.py``) ends the run as this module loads.

Weights come from ``gen.draw``: layer i from stream i in the order
``reference.kimi_linear.layer_shapes`` lists, with its draws
(``reference.kimi_linear.layer_weights``), the embeddings and final norm
from ``gen.EMBED_STREAM`` and the untied head from ``gen.HEAD_STREAM``.

``kda_ops`` and ``kda_bytes`` are one KDA layer's least work for
``tokens`` real tokens, which ``metrics/encoder.kda_roofline.text.py``
holds against the device time of the kernels named ``kda_``;
``moe_layers``, ``expert_ops`` and ``expert_bytes`` are the held share's
(``archs/deepseek_v2.py``'s functions of the same names, over the slots
routed to this card's experts), for a reader of the routed experts'
roofline that asks the cell's architecture.
"""

from __future__ import annotations

import os

import torch

from retrieval_bench import gen, program
from retrieval_bench.reference import kimi_linear as reference

_PORT_MODULE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scaling_retriever_tpu_torch", "models",
    "kimi_linear.py")
if not os.path.isfile(_PORT_MODULE):
    raise SystemExit("the port in this checkout has no Kimi-Linear model "
                     "(scaling_retriever_tpu_torch/models/kimi_linear.py)")

sparse_reps = reference.sparse_reps

_KDA = {"wq": "attn.wq.weight", "wk": "attn.wk.weight",
        "wv": "attn.wv.weight", "q_conv": "attn.q_conv",
        "k_conv": "attn.k_conv", "v_conv": "attn.v_conv",
        "A_log": "attn.A_log", "wfa": "attn.wfa.weight",
        "wfb": "attn.wfb.weight", "dt_bias": "attn.dt_bias",
        "wb": "attn.wb.weight", "wga": "attn.wga.weight",
        "wgb": "attn.wgb.weight", "bgb": "attn.wgb.bias",
        "o_norm": "attn.o_norm", "wo": "attn.wo.weight"}
_MLA = {"wq": "attn.wq.weight", "wkv_a": "attn.wkv_a.weight",
        "kv_norm": "attn.kv_norm", "wkv_b": "attn.wkv_b.weight",
        "wo": "attn.wo.weight"}
_NORMS = {"input_norm": "input_norm", "post_attn_norm": "post_attn_norm"}
_DENSE = {"wg": "mlp.wg.weight", "wu": "mlp.wu.weight",
          "wd": "mlp.wd.weight"}
_MOE = {"router": "mlp.gate.weight",
        "bias": "mlp.gate.e_score_correction_bias", "w_gu": "mlp.w_gu",
        "w_d": "mlp.w_d", "sg": "mlp.shared.wg.weight",
        "su": "mlp.shared.wu.weight", "sd": "mlp.shared.wd.weight"}


@torch.no_grad()
def build_encoder(conf: dict, seed: int, device, **overrides):
    """The configuration's encoder class (``conf["encoder"]``, a class of
    the port's ``models.encoder``) over a ``KimiLinearBiForMNTP`` holding
    the benchmark's weights for ``seed``."""
    from scaling_retriever_tpu_torch.models import encoder, kimi_linear

    m = conf["model"]
    cfg = program.model_config(m, **overrides)
    mod = kimi_linear.empty_model(cfg, device)
    emb = gen.embed_weights(m, seed, device)
    mod.embed_tokens.weight.copy_(emb["embed"])
    mod.final_norm.copy_(emb["final_norm"])
    del emb
    mod.lm_head.weight.copy_(gen.head_weight(m, seed, device))
    params = dict(mod.named_parameters())
    for i in range(m["num_hidden_layers"]):
        w = reference.layer_weights(m, seed, i, device)
        names = {**(_KDA if reference.is_kda_layer(m, i) else _MLA),
                 **_NORMS,
                 **(_MOE if reference.is_moe_layer(m, i) else _DENSE)}
        for key, t in w.items():
            params[f"layers.{i}.{names[key]}"].copy_(t)
        del w
    return getattr(encoder, conf["encoder"])(mod, cfg)


def kda_layers(m: dict) -> int:
    return len(m["linear_attn_config"]["kda_layers"])


def kda_ops(m: dict, tokens: int) -> float:
    """One KDA layer's recurrence FLOPs for ``tokens`` tokens: a head's
    state of d x d entries takes 3 multiply-adds a position (decay and
    read k, the rank-1 write, read q)."""
    la = m["linear_attn_config"]
    return float(2 * 3 * la["head_dim"] ** 2 * la["num_heads"] * tokens)


def kda_bytes(m: dict, tokens: int) -> float:
    """One KDA layer's least bytes for ``tokens`` tokens, as the kernel
    takes its inputs: the raw projections q, k and v, the decay's input
    f, the output gate's input and the output, each bf16 [n d] a token,
    and beta, float32 [n] a token, read or written once."""
    la = m["linear_attn_config"]
    w = la["num_heads"] * la["head_dim"]
    q_k_v, f, gate, out = 3 * w * 2, w * 2, w * 2, w * 2
    beta = la["num_heads"] * 4
    return float(tokens * (q_k_v + f + gate + out + beta))


def moe_layers(m: dict) -> int:
    return sum(reference.is_moe_layer(m, i)
               for i in range(m["num_hidden_layers"]))


def expert_ops(m: dict, tokens: int) -> float:
    """One MoE layer's routed-expert FLOPs on this card for ``tokens``
    tokens: three products of H x I a slot, over the slots routed to the
    held experts, k * held / router experts a token on average."""
    slots = m["num_experts_per_token"] * m["num_experts"] / \
        reference.router_experts(m)
    return float(2 * 3 * m["hidden_size"] * m["moe_intermediate_size"]
                 * slots * tokens)


def expert_bytes(m: dict, tokens: int) -> float:
    """One MoE layer's least bytes on this card for ``tokens`` tokens: the
    held experts' three bf16 matrices read once, and each held slot's bf16
    row of x read and its output row written."""
    h, e = m["hidden_size"], m["num_experts"]
    slots = m["num_experts_per_token"] * e / reference.router_experts(m)
    weights = e * 3 * h * m["moe_intermediate_size"] * 2
    return float(weights + tokens * slots * 2 * h * 2)


def encode_flops(m: dict, n_tokens: int) -> float:
    """Forward FLOPs of encoding one text of ``n_tokens`` (no padding),
    this card's share: KDA's projections and its recurrence (``kda_ops``),
    MLA's five projections, QK^T at dn + dr and PV at dv over the text's
    own tokens, the dense layer's SwiGLU, each MoE layer's router over all
    its experts, the held share of the k routed experts (k * held /
    router experts a token) and the shared expert, and the vocabulary
    head. The convolutions and gates' elementwise work is left out."""
    h, n = m["hidden_size"], m["num_attention_heads"]
    la = m["linear_attn_config"]
    w, d = la["num_heads"] * la["head_dim"], la["head_dim"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    r, f = m["kv_lora_rank"], m["moe_intermediate_size"]
    kda_mats = 3 * h * w + h * d + d * w + h * la["num_heads"] + h * d \
        + d * w + w * h
    mla = h * n * (dn + dr) + h * (r + dr) + r * n * (dn + dv) + n * dv * h
    e = reference.router_experts(m)
    share = m["num_experts_per_token"] * m["num_experts"] / e
    total = 0.0
    for i in range(m["num_hidden_layers"]):
        if reference.is_kda_layer(m, i):
            mix = 2 * n_tokens * kda_mats + kda_ops(m, n_tokens)
        else:
            mix = 2 * n_tokens * (mla + n_tokens * n * (dn + dr + dv))
        ffn = (h * e + 3 * h * f * (share + m["num_shared_experts"])
               if reference.is_moe_layer(m, i)
               else 3 * h * m["intermediate_size"])
        total += mix + 2 * n_tokens * ffn
    return float(total + 2 * n_tokens * h * m["vocab_size"])
