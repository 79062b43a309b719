"""DeepSeek-V2 (latent attention, a dense first layer, then routed and
shared experts) as a sparse encoder: the port's ``DeepseekV2BiForMNTP``
under the configuration's encoder class, its plain reference in
``reference/deepseek_v2.py`` and its FLOP count. The interface is
``bidir_decoder.py``'s docstring; there are no training functions, so a
training cell of this architecture ends at ``run.load_arch``.

Weights come from ``gen.draw``: layer i from stream i in the order
``reference.deepseek_v2.layer_shapes`` lists (attention: wq, wkv_a,
kv_norm, wkv_b, wo; the two layer norms; then the dense wg, wu, wd, or the
router, the stacked experts w_gu [E, 2I, H] and w_d [E, H, I] and the
shared experts' sg, su, sd) given the reference's routing draw
(``reference.deepseek_v2.layer_weights``: the router reads only residual
dims that no layer writes), the embeddings and final norm from
``gen.EMBED_STREAM`` and the untied head from ``gen.HEAD_STREAM``.

``expert_ops`` and ``expert_bytes`` are one MoE layer's least work for
``tokens`` tokens, which ``metrics/encoder.moe_roofline.text.py`` holds
against the device time of the kernels named ``moe_expert``.
"""

from __future__ import annotations

import torch

from retrieval_bench import gen, program
from retrieval_bench.reference import deepseek_v2 as reference

sparse_reps = reference.sparse_reps

_ATTN = {"wq": "attn.wq.weight", "wkv_a": "attn.wkv_a.weight",
         "kv_norm": "attn.kv_norm", "wkv_b": "attn.wkv_b.weight",
         "wo": "attn.wo.weight", "input_norm": "input_norm",
         "post_attn_norm": "post_attn_norm"}
_DENSE = {"wg": "mlp.wg.weight", "wu": "mlp.wu.weight",
          "wd": "mlp.wd.weight"}
_MOE = {"router": "mlp.gate.weight", "w_gu": "mlp.w_gu", "w_d": "mlp.w_d",
        "sg": "mlp.shared.wg.weight", "su": "mlp.shared.wu.weight",
        "sd": "mlp.shared.wd.weight"}


@torch.no_grad()
def build_encoder(conf: dict, seed: int, device, **overrides):
    """The configuration's encoder class (``conf["encoder"]``, a class of
    the port's ``models.encoder``) over a ``DeepseekV2BiForMNTP`` holding
    the benchmark's bf16 weights for ``seed``."""
    from scaling_retriever_tpu_torch.models import deepseek_v2, encoder

    m = conf["model"]
    cfg = program.model_config(m, **overrides)
    mod = deepseek_v2.empty_model(cfg, device)
    emb = gen.embed_weights(m, seed, device)
    mod.embed_tokens.weight.copy_(emb["embed"])
    mod.final_norm.copy_(emb["final_norm"])
    del emb
    if mod.lm_head is not None:
        mod.lm_head.weight.copy_(gen.head_weight(m, seed, device))
    params = dict(mod.named_parameters())
    for i in range(m["num_hidden_layers"]):
        w = reference.layer_weights(m, seed, i, device)
        names = {**_ATTN, **(_MOE if reference.is_moe_layer(m, i)
                             else _DENSE)}
        for key, t in w.items():
            params[f"layers.{i}.{names[key]}"].copy_(t)
        del w
    return getattr(encoder, conf["encoder"])(mod, cfg)


def moe_layers(m: dict) -> int:
    return sum(reference.is_moe_layer(m, i)
               for i in range(m["num_hidden_layers"]))


def expert_ops(m: dict, tokens: int) -> float:
    """One MoE layer's routed-expert FLOPs for ``tokens`` tokens: three
    products of H x I a slot, k slots a token."""
    return float(2 * 3 * m["hidden_size"] * m["moe_intermediate_size"]
                 * m["num_experts_per_tok"] * tokens)


def expert_bytes(m: dict, tokens: int) -> float:
    """One MoE layer's least bytes for ``tokens`` tokens: every routed
    expert's three bf16 matrices read once, and each slot's bf16 row of x
    read and its output row written."""
    h, e = m["hidden_size"], m["n_routed_experts"]
    weights = e * 3 * h * m["moe_intermediate_size"] * 2
    return float(weights + tokens * m["num_experts_per_tok"] * 2 * h * 2)


def encode_flops(m: dict, n_tokens: int) -> float:
    """Forward FLOPs of encoding one text of ``n_tokens`` (no padding),
    the active parameters only: MLA's five projections, QK^T at
    dn + dr and PV at dv over the text's own tokens, the dense layers'
    SwiGLU, each MoE layer's router, k routed experts and shared experts,
    and the vocabulary head."""
    h, n = m["hidden_size"], m["num_attention_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    r, f = m["kv_lora_rank"], m["moe_intermediate_size"]
    mla = h * n * (dn + dr) + h * (r + dr) + r * n * (dn + dv) + n * dv * h
    att = n_tokens * n * (dn + dr + dv)
    total = 0
    for i in range(m["num_hidden_layers"]):
        ffn = (h * m["n_routed_experts"]
               + 3 * h * f * (m["num_experts_per_tok"]
                              + m["n_shared_experts"])
               if reference.is_moe_layer(m, i)
               else 3 * h * m["intermediate_size"])
        total += 2 * n_tokens * (mla + att + ffn)
    return float(total + 2 * n_tokens * h * m["vocab_size"])
