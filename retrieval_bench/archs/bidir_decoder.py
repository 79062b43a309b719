"""The bidirectional decoder family (Llama, Qwen2, Mistral): RMSNorm,
RoPE, non-causal grouped-query attention, SwiGLU, Qwen2's q/k/v bias, and
the SPLADE head over the vocabulary.

An architecture module is what a configuration names under ``"arch"``:
``retrieval_bench/archs/<arch>.py``, loaded by ``run.load_arch`` and
handed to the kinds as ``ctx.arch``. The kinds reach the model, its
weights, its plain reference and its FLOP count only through it, so a
new architecture's cell is new files: this module's counterpart, a plain
reference in ``reference/<arch>.py`` (plain PyTorch in float32 with TF32
off, importing nothing of the port), the configuration, its limits and
its readers. Each kind lists the functions it calls in its ``ARCH``, and
``run.load_arch`` ends a run whose module lacks one. The functions:

* ``build_encoder(conf, seed, device, **overrides)``: the port's encoder
  (an object with ``encode(ids, mask) -> [w, vocab] f32``, ``device`` and
  the port's ``tile_graphs``) over the benchmark's weights for ``seed``,
  in the served dtype; ``overrides`` go to the port's model config (the
  train kind passes ``remat=True``, tests a float32 dtype).
* ``sparse_reps(m, seed, token_lists, device, precision="f32")``: the
  plain reference's [n, vocab] float32 reps of the texts' token lists,
  from ``m`` (the configuration's ``model``) and the same weights drawn
  again; ``precision="fp8"`` is the control, the reference one precision
  down.
* ``encode_flops(m, n_tokens)``: the model FLOPs of encoding one text of
  ``n_tokens``, which ``mfu.text`` divides.

and, for a training cell only (the train kind's):

* ``train_flops(m, groups, remat)``: the model FLOPs of one micro step
  over ``groups`` of (rows, tokens), which ``mfu.train`` divides.
* ``lora_factors(m, r, seed, device)``: the initial LoRA factors the
  program and the reference start from.
* ``train_steps(m, seed, lora, batches, hp, device, precision="f32",
  half=False)``: the reference's steps from ``lora`` (losses, gradient
  norms by leaf, the change by leaf); ``precision="fp8"`` the control,
  ``half=True`` the half-batch fault.

Weights come from ``gen.draw``, the benchmark's generator. Here the
functions are bound where they already lie: the reference in
``reference/decoder.py`` and ``reference/training.py``, the FLOPs in
``flops.py``, the factors and weights in ``gen.py``.
"""

from __future__ import annotations

import torch

from retrieval_bench import flops, gen, program
from retrieval_bench.reference import decoder, training

_MATS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

sparse_reps = decoder.sparse_reps
encode_flops = flops.encode_flops
train_flops = flops.train_flops
lora_factors = gen.lora_factors
train_steps = training.train_steps


@torch.no_grad()
def build_encoder(conf: dict, seed: int, device, **overrides):
    """The configuration's encoder class (``conf["encoder"]``, a class of
    the port's ``models.encoder``) over an ``LlamaBiForMNTP`` holding the
    benchmark's bf16 weights for ``seed``."""
    from scaling_retriever_tpu_torch.models import encoder
    from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP

    m = conf["model"]
    cfg = program.model_config(m, **overrides)
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
