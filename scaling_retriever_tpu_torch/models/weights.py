"""Weights for ``LlamaBiForMNTP`` and ``T5ForConditionalGeneration``:
carried across from the JAX package's parameter layout, or drawn at random
from a seed. (The hybrid models run on ``LlamaBiForMNTP``: the Llama
conversion serves them.)

The JAX layout (``llama.init_params`` and ``t5.params_from_hf_tensors``
there) stacks each layer weight along a leading ``num_layers`` axis and
stores matrices [in, out] for ``x @ w``; ``nn.Linear`` keeps [out, in], so
matrices are transposed on the way in. LoRA trees keep the JAX nesting for
both families (``lora_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models import t5
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


def _put(dst: torch.Tensor, src) -> None:
    dst.copy_(torch.from_numpy(np.array(src, copy=True)))


@torch.no_grad()
def _t5_from_jax(tree: dict, config: t5.T5Config,
                 device) -> t5.T5ForConditionalGeneration:
    model = t5._empty_model(config, device)
    _put(model.shared.weight, tree["shared"])
    if model.lm_head is not None:
        _put(model.lm_head.weight, np.asarray(tree["lm_head"]).T)
    for side in ("encoder", "decoder"):
        stack, sub = getattr(model, side), tree[side]
        _put(stack.rel_bias, sub["rel_bias"])
        _put(stack.final_ln, sub["final_ln"])
        for name, arr in sub["layers"].items():
            for i, layer in enumerate(stack.layers):
                if name.endswith("_ln"):
                    _put(getattr(layer, name), arr[i])
                else:
                    _put(getattr(layer, name).weight, np.asarray(arr[i]).T)
    return model


@torch.no_grad()
def params_from_jax(tree: dict, config, device="cuda"):
    """``tree``: nested dict of numpy arrays in the JAX layout → the
    port's module on ``device``: a ``T5ForConditionalGeneration`` for a
    ``t5.T5Config`` (the tree of the JAX ``t5.params_from_hf_tensors``),
    else an ``LlamaBiForMNTP`` (the JAX ``init_params`` layout). Llama's
    tied embeddings follow ``config.tie_word_embeddings`` (an ``lm_head``
    in the tree is then unused, as in the reference's ``forward_logits``).
    A tree without an ``lm_head`` under untied embeddings (a dense
    encoder's weights) gives a module without one: ``forward_hidden``
    runs, ``forward_logits`` raises."""
    if isinstance(config, t5.T5Config):
        return _t5_from_jax(tree, config, device)
    model = _empty_model(config, device)
    _put(model.embed_tokens.weight, tree["embed_tokens"])
    _put(model.final_norm, tree["final_norm"])
    layers = tree["layers"]
    for i, layer in enumerate(model.layers):
        for group, name in _MATS:
            _put(getattr(layer, name).weight,
                 np.asarray(layers[group][name][i]).T)
        for bname, name in _BIASES:
            if getattr(layer, name).bias is not None:
                _put(getattr(layer, name).bias, layers["attn"][bname][i])
        _put(layer.input_norm, layers["input_norm"][i])
        _put(layer.post_attn_norm, layers["post_attn_norm"][i])
    if model.lm_head is not None:
        if "lm_head" in tree:
            _put(model.lm_head.weight, np.asarray(tree["lm_head"]).T)
        else:
            model.lm_head = None
    return model


def lora_from_jax(tree: dict, device="cuda", trainable: bool = False) -> dict:
    """A JAX LoRA factor tree (numpy leaves; the Llama or the T5 layout) →
    the same nesting of torch tensors on ``device``; ``trainable`` leaves
    require grad, so that a trainer starts from the same factors as the JAX
    package's."""
    if isinstance(tree, dict):
        return {k: lora_from_jax(v, device, trainable)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(
        device).requires_grad_(trainable)


@torch.no_grad()
def random_params(config, seed: int, device="cuda"):
    """Random weights as the JAX ``init_params`` draws them (normal, std
    0.02, norms at one, linear biases at zero), from a ``torch.Generator``
    seeded with ``seed``, for an ``LlamaBiForMNTP`` or, given a
    ``t5.T5Config``, a ``T5ForConditionalGeneration`` (its relative
    position biases drawn too). The numbers differ from JAX's for the same
    seed."""
    model = (t5._empty_model(config, device)
             if isinstance(config, t5.T5Config)
             else _empty_model(config, device))
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(("norm", "_ln")):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=device,
                                dtype=torch.float32).mul_(0.02))
    return model
