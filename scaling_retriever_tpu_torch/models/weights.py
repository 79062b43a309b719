"""Weights for ``LlamaBiForMNTP``: carried across from the JAX package's
parameter layout, or drawn at random from a seed.

The JAX layout (``llama.init_params`` there) stacks each layer weight along
a leading ``num_layers`` axis and stores matrices [in, out] for ``x @ w``;
``nn.Linear`` keeps [out, in], so matrices are transposed on the way in.
"""

from __future__ import annotations

import numpy as np
import torch

from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP

_MATS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
         ("mlp", "wg"), ("mlp", "wu"), ("mlp", "wd"))
_BIASES = (("bq", "wq"), ("bk", "wk"), ("bv", "wv"))


def _empty_model(config: ModelConfig, device) -> LlamaBiForMNTP:
    """The module with uninitialized storage on ``device`` (no init pass
    over 1B parameters that would be overwritten anyway)."""
    with torch.device("meta"):
        model = LlamaBiForMNTP(config)
    model = model.to_empty(device=device)
    model.requires_grad_(False)
    return model


@torch.no_grad()
def params_from_jax(tree: dict, config: ModelConfig,
                    device="cuda") -> LlamaBiForMNTP:
    """``tree``: nested dict of numpy arrays in the JAX ``init_params``
    layout → the port's module on ``device``. Tied embeddings follow
    ``config.tie_word_embeddings`` (an ``lm_head`` in the tree is then
    unused, as in the reference's ``forward_logits``)."""
    model = _empty_model(config, device)

    def put(dst: torch.Tensor, src) -> None:
        dst.copy_(torch.from_numpy(np.array(src, copy=True)))

    put(model.embed_tokens.weight, tree["embed_tokens"])
    put(model.final_norm, tree["final_norm"])
    layers = tree["layers"]
    for i, layer in enumerate(model.layers):
        for group, name in _MATS:
            put(getattr(layer, name).weight, np.asarray(layers[group][name][i]).T)
        for bname, name in _BIASES:
            if getattr(layer, name).bias is not None:
                put(getattr(layer, name).bias, layers["attn"][bname][i])
        put(layer.input_norm, layers["input_norm"][i])
        put(layer.post_attn_norm, layers["post_attn_norm"][i])
    if model.lm_head is not None:
        put(model.lm_head.weight, np.asarray(tree["lm_head"]).T)
    return model


def lora_from_jax(tree: dict, device="cuda") -> dict:
    """A JAX LoRA factor tree (numpy leaves) → the same nesting of torch
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: lora_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


@torch.no_grad()
def random_params(config: ModelConfig, seed: int,
                  device="cuda") -> LlamaBiForMNTP:
    """Random weights as the JAX ``init_params`` draws them (normal, std
    0.02, norms at one, biases at zero), from a ``torch.Generator`` seeded
    with ``seed``. The numbers differ from JAX's for the same seed."""
    model = _empty_model(config, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("norm"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=device,
                                dtype=torch.float32).mul_(0.02))
    return model
