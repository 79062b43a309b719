"""Load and save Hugging Face Llama/Qwen2/Mistral checkpoints (port of
models/hf_loader.py), and load the checkpoints of the model modules that
map HF's tensor names themselves (``OWN_NAMES``: DeepSeek-V2, Kimi-Linear;
each module's ``empty_model`` and ``hf_target``), whose routed experts'
tensors are stacked into the port's [E, ...] layout.

Reads ``config.json`` and ``*.safetensors`` (one file, or shards listed in
``model.safetensors.index.json``) from a local directory with the port's
own reader (``models/safetensors_io.py``): no ``safetensors`` or
``transformers`` package, no network. HF stores each projection as
``[out, in]``, which is ``nn.Linear``'s layout, so tensors are copied
into the module as they are, with no transpose (the JAX package
transposes into ``x @ w``). Each tensor goes straight into the module's
storage on the target device, in ``param_dtype``, one tensor at a time:
the host holds one tensor, never a whole shard.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Optional, Tuple

import torch

from scaling_retriever_tpu_torch.models import (deepseek_v2, kimi_linear,
                                                safetensors_io)
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP
from scaling_retriever_tpu_torch.models.weights import _empty_model

_LAYER_RE = re.compile(r"layers\.(\d+)\.")

# HF module path fragment -> the port's LlamaLayer attribute path
_LAYER_KEY_MAP = {
    "self_attn.q_proj.weight": "wq.weight",
    "self_attn.k_proj.weight": "wk.weight",
    "self_attn.v_proj.weight": "wv.weight",
    "self_attn.o_proj.weight": "wo.weight",
    "self_attn.q_proj.bias": "wq.bias",
    "self_attn.k_proj.bias": "wk.bias",
    "self_attn.v_proj.bias": "wv.bias",
    "mlp.gate_proj.weight": "wg.weight",
    "mlp.up_proj.weight": "wu.weight",
    "mlp.down_proj.weight": "wd.weight",
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_attn_norm",
}


# model types whose module maps HF's names to its parameters
OWN_NAMES = {"deepseek_v2": deepseek_v2, "kimi_linear": kimi_linear}


def _strip_prefix(key: str) -> str:
    """'model.layers.0...' / 'model.model.layers.0...' → 'layers.0...'."""
    for prefix in ("model.", "base_model.model.", "transformer."):
        while key.startswith(prefix):
            key = key[len(prefix):]
    return key


def _shard_files(model_dir: str) -> list[str]:
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        files = sorted(set(index["weight_map"].values()))
        return [os.path.join(model_dir, f) for f in files]
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return [single]
    cands = sorted(os.path.join(model_dir, f) for f in os.listdir(model_dir)
                   if f.endswith(".safetensors"))
    if not cands:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    return cands


def _iter_hf_tensors(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    for path in _shard_files(model_dir):
        yield from safetensors_io.iter_tensors(path)


def load_hf_tensors(model_dir: str) -> Dict[str, torch.Tensor]:
    """All tensors of the checkpoint (CPU), keyed by their HF names."""
    return dict(_iter_hf_tensors(model_dir))


def _target(model: LlamaBiForMNTP, raw_key: str) -> Optional[str]:
    """The module's parameter name for an HF tensor name, or None for
    tensors the model has no place for (rotary buffers, a tied head)."""
    key = _strip_prefix(raw_key)
    if key == "embed_tokens.weight":
        return "embed_tokens.weight"
    if key == "norm.weight":
        return "final_norm"
    if key == "lm_head.weight":
        return "lm_head.weight" if model.lm_head is not None else None
    m = _LAYER_RE.search(key)
    if m is None or key[m.end():] not in _LAYER_KEY_MAP:
        return None
    return f"layers.{m.group(1)}.{_LAYER_KEY_MAP[key[m.end():]]}"


@torch.no_grad()
def params_from_hf_tensors(tensors, config: ModelConfig,
                           device="cuda") -> LlamaBiForMNTP:
    """HF-named (name, tensor) pairs (a dict or an iterator) → the port's
    module on ``device``, each tensor cast to ``param_dtype`` as it is
    copied in. An untied config whose checkpoint has no ``lm_head`` falls
    back to the embedding matrix, as the reference does; a model type of
    ``OWN_NAMES`` loads through its module's names."""
    own = OWN_NAMES.get(config.model_type)
    if own is not None:
        return _own_params(own, tensors, config, device)
    model = _empty_model(config, device)
    params = dict(model.named_parameters())
    filled = set()
    items = tensors.items() if isinstance(tensors, dict) else tensors
    for raw_key, value in items:
        name = _target(model, raw_key)
        if name is None or name not in params:
            continue
        dst = params[name]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{raw_key}: shape {tuple(value.shape)}, the "
                             f"model expects {tuple(dst.shape)}")
        dst.copy_(value)
        filled.add(name)
    if model.lm_head is not None and "lm_head.weight" not in filled:
        # some checkpoints omit lm_head and rely on tying even when the
        # config says otherwise
        model.lm_head.weight.copy_(model.embed_tokens.weight)
        filled.add("lm_head.weight")
    missing = sorted(set(params) - filled)
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} tensors: "
                         f"{missing[:6]}")
    return model


def _expert_slice(dst: torch.Tensor, part: Optional[tuple]) -> torch.Tensor:
    """A stacked parameter's slice for ``part`` (``deepseek_v2.hf_target``)."""
    if part is None:
        return dst
    kind, e = part
    if kind == "down":
        return dst[e]
    i = dst.shape[1] // 2
    return dst[e, :i] if kind == "gate" else dst[e, i:]


def _own_params(module, tensors, config: ModelConfig, device):
    """HF-named (name, tensor) pairs → ``module``'s model on ``device``,
    each held expert's tensors copied into its slice of the stacked
    projections; tensors of experts held elsewhere are passed over."""
    model = module.empty_model(config, device)
    params = dict(model.named_parameters())
    want = set()
    for name, p in params.items():
        if name.endswith("mlp.w_gu"):
            want |= {(name, (kind, e)) for e in range(p.shape[0])
                     for kind in ("gate", "up")}
        elif name.endswith("mlp.w_d"):
            want |= {(name, ("down", e)) for e in range(p.shape[0])}
        else:
            want.add((name, None))
    filled = set()
    items = tensors.items() if isinstance(tensors, dict) else tensors
    for raw_key, value in items:
        target = module.hf_target(_strip_prefix(raw_key), config)
        if target is None or target[0] not in params:
            continue
        dst = _expert_slice(params[target[0]], target[1])
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{raw_key}: shape {tuple(value.shape)}, the "
                             f"model expects {tuple(dst.shape)}")
        dst.copy_(value)
        filled.add(target)
    missing = sorted(map(str, want - filled))
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} tensors: "
                         f"{missing[:6]}")
    return model


def load_pretrained(model_dir: str, config: Optional[ModelConfig] = None,
                    device="cuda", **config_overrides
                    ) -> tuple[LlamaBiForMNTP, ModelConfig]:
    """(module, config) from a local HF checkpoint directory, the module's
    weights on ``device``: ``LlamaBiForMNTP`` for the Llama family, the
    model module's own for a type of ``OWN_NAMES``."""
    if config is None:
        config = ModelConfig.from_pretrained(model_dir, **config_overrides)
    return (params_from_hf_tensors(_iter_hf_tensors(model_dir), config,
                                   device), config)


def _hf_items(model: LlamaBiForMNTP, config: ModelConfig):
    yield "model.embed_tokens.weight", model.embed_tokens.weight
    yield "model.norm.weight", model.final_norm
    if model.lm_head is not None and not config.tie_word_embeddings:
        yield "lm_head.weight", model.lm_head.weight
    for i, layer in enumerate(model.layers):
        for frag, attr in _LAYER_KEY_MAP.items():
            obj = layer
            for part in attr.split("."):
                obj = getattr(obj, part)
            if obj is not None:
                yield f"model.layers.{i}.{frag}", obj


def save_pretrained(model: LlamaBiForMNTP, config: ModelConfig,
                    save_dir: str) -> None:
    """Write the module as an HF-compatible checkpoint (one shard, tensors
    in ``param_dtype``) and its ``config.json``."""
    os.makedirs(save_dir, exist_ok=True)
    safetensors_io.save_file(_hf_items(model, config),
                             os.path.join(save_dir, "model.safetensors"))
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(config.to_hf_config(), f, indent=2)
