"""How the benchmark hands its inputs to the system under test, the port
``scaling_retriever_tpu_torch``: the encoder built from the benchmark's
weights through the port's model classes, and the engine over the
benchmark's index arrays. The port is imported here and in the kinds,
never at the top of a module the reference or the tests' import walk
reads first.
"""

from __future__ import annotations

import torch

from retrieval_bench import gen

_MATS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def model_config(m: dict, **overrides):
    from scaling_retriever_tpu_torch.models.config import ModelConfig

    kw = {"dtype": torch.bfloat16, "param_dtype": torch.bfloat16,
          **overrides}
    return ModelConfig.from_hf_config(m, **kw)


@torch.no_grad()
def build_encoder(conf: dict, seed: int, device, **overrides):
    """The configuration's encoder class (``conf["encoder"]``, a class of
    the port's ``models.encoder``) over an ``LlamaBiForMNTP`` holding the
    benchmark's bf16 weights for ``seed``."""
    from scaling_retriever_tpu_torch.models import encoder
    from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP

    m = conf["model"]
    cfg = model_config(m, **overrides)
    with torch.device("meta"):
        mod = LlamaBiForMNTP(cfg)
    mod = mod.to_empty(device=device)
    mod.requires_grad_(False)
    emb = gen.embed_weights(m, seed, device)
    mod.embed_tokens.weight.copy_(emb["embed"])
    mod.final_norm.copy_(emb["final_norm"])
    del emb
    if mod.lm_head is not None:
        mod.lm_head.weight.copy_(gen.head_weight(m, seed, device))
    for i, layer in enumerate(mod.layers):
        w = gen.layer_weights(m, seed, i, device)
        for name in _MATS:
            getattr(layer, name).weight.copy_(w[name])
        layer.input_norm.copy_(w["input_norm"])
        layer.post_attn_norm.copy_(w["post_attn_norm"])
        if gen.qkv_bias(m):
            for b, name in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
                getattr(layer, name).bias.copy_(w[b])
    return getattr(encoder, conf["encoder"])(mod, cfg)


def build_engine(conf: dict, topk: int, t_budget: int, device):
    """A ``SegsortEngine`` over the configuration's uniform index in the
    f32 layout, made on the device."""
    from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine

    ix = conf["index"]
    rows, bits, offsets, _ = gen.index_rows(ix, conf["model"]["vocab_size"],
                                           device)
    return SegsortEngine(topk=topk, query_terms_budget=t_budget,
                         device_csr=(rows, bits, offsets, ix["n_docs"]))
