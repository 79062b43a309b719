"""T5 encoder-decoder (port of models/t5.py) as an ``nn.Module`` stack, for
the T5Sparse retriever family.

The numerics are the reference's (HF ``T5ForConditionalGeneration``):
  * attention logits are NOT scaled by 1/sqrt(d_kv); logits and softmax in
    float32;
  * a learned relative-position bias (bucketed: bidirectional for the
    encoder, causal for the decoder's self-attention) comes from each
    stack's one ``rel_bias`` embedding (HF's block 0) and is shared by all
    of its layers; the buckets are computed on the host in float32, in the
    reference's order, so every device gets the same table;
  * the layer norm is RMS only (no mean, no bias), float32 statistics, eps
    1e-6;
  * the additive mask is ``MASK_VALUE`` (-1e9), not -inf, so a fully masked
    row is uniform rather than NaN;
  * when embeddings are tied, the decoder output is rescaled by
    ``d_model**-0.5`` before the (shared) LM head;
  * the FFN is relu ``wi`` (v1.0) or gated tanh-GELU ``wi_0`` x ``wi_1``
    (v1.1, ``feed_forward_proj="gated-gelu"``).

Layer weights carry the reference's names (``self_q`` ... ``cross_o``,
``wi``/``wi_0``/``wi_1``/``wo``, ``self_ln``/``cross_ln``/``ffn_ln``) as
``nn.Linear`` modules (HF's [out, in] layout, so an HF checkpoint copies
in without a transpose). LoRA factors keep the reference's stacked layout
``{"encoder"|"decoder": {"layers": {name: {"a": [L, in, r], "b": [L, r,
out]}}}}`` and cover both stacks, cross-attention included; peft adapter
files use the key layout
``base_model.model.{encoder|decoder}.block.N.layer.M.{SelfAttention|
EncDecAttention|DenseReluDense}.<mod>.lora_{A|B}.weight``. The reference's
T5 forward takes no LoRA dropout, and neither does this one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scaling_retriever_tpu_torch.models import safetensors_io
from scaling_retriever_tpu_torch.models.llama import dense

MASK_VALUE = -1e9


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTS = {"relu": F.relu, "gelu": _gelu_tanh, "gelu_new": _gelu_tanh,
         "silu": F.silu}


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.float32        # activation dtype
    param_dtype: torch.dtype = torch.float32  # parameter storage dtype

    @property
    def is_gated(self) -> bool:
        return "gated" in self.feed_forward_proj

    @property
    def act(self):
        return _ACTS[self.feed_forward_proj.replace("gated-", "")]

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @classmethod
    def from_hf_config(cls, cfg: dict, **overrides) -> "T5Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known
                  and k not in ("dtype", "param_dtype")}
        if cfg.get("num_decoder_layers") is None:
            kwargs["num_decoder_layers"] = kwargs.get("num_layers", 6)
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_pretrained(cls, model_dir: str, **overrides) -> "T5Config":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_hf_config(json.load(f), **overrides)

    def to_hf_config(self) -> dict:
        """The fields as an HF ``config.json`` that ``transformers`` and the
        JAX package both read."""
        return {
            "architectures": ["T5ForConditionalGeneration"],
            "model_type": "t5",
            "vocab_size": self.vocab_size,
            "d_model": self.d_model,
            "d_kv": self.d_kv,
            "d_ff": self.d_ff,
            "num_layers": self.num_layers,
            "num_decoder_layers": self.num_decoder_layers,
            "num_heads": self.num_heads,
            "relative_attention_num_buckets":
                self.relative_attention_num_buckets,
            "relative_attention_max_distance":
                self.relative_attention_max_distance,
            "layer_norm_epsilon": self.layer_norm_epsilon,
            "feed_forward_proj": self.feed_forward_proj,
            "tie_word_embeddings": self.tie_word_embeddings,
            "is_encoder_decoder": True,
            "decoder_start_token_id": 0,
            "pad_token_id": 0,
            "eos_token_id": 1,
            "dropout_rate": 0.0,
        }


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """RMS-only layer norm, float32 statistics (HF T5LayerNorm)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return weight * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF ``T5Attention._relative_position_bucket``, in the reference's
    float32 order (the log of the distance, an edge case at each bucket
    border)."""
    rp = relative_position
    ret = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rp > 0).to(rp.dtype) * num_buckets
        rp = rp.abs()
    else:
        rp = -torch.clamp(rp, max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    large = max_exact + (
        torch.log(rp.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(rp.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(is_small, rp, large)


def position_bias(rel_embedding: torch.Tensor, q_len: int, k_len: int,
                  bidirectional: bool, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """[1, H, q_len, k_len] f32 bias from the [num_buckets, H] embedding.
    The buckets are computed on the host (int32), whatever the device."""
    ctx = torch.arange(q_len, dtype=torch.int32)[:, None]
    mem = torch.arange(k_len, dtype=torch.int32)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional, num_buckets,
                                       max_distance)
    bias = rel_embedding[buckets.to(rel_embedding.device).long()]
    return bias.permute(2, 0, 1)[None].float()


def _mask_bias(keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, 0.0, MASK_VALUE)


def _attn(q, k, v, bias):
    """Unscaled logits plus the additive bias, softmax in f32; q/k/v
    [B, S, H, dk] → [B, S, H * dk]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    b_, s, h, d = out.shape
    return out.reshape(b_, s, h * d)


_ATTN = ("q", "k", "v", "o")


class T5Block(nn.Module):
    """Self-attention, cross-attention (decoder only) and the FFN, each
    pre-norm with a residual."""

    def __init__(self, config: T5Config, is_decoder: bool):
        super().__init__()
        dm, inner, dff = config.d_model, config.inner_dim, config.d_ff
        dt = config.param_dtype
        scopes = ("self", "cross") if is_decoder else ("self",)
        for scope in scopes:
            for m in _ATTN:
                fan_in, fan_out = (inner, dm) if m == "o" else (dm, inner)
                setattr(self, f"{scope}_{m}",
                        nn.Linear(fan_in, fan_out, bias=False, dtype=dt))
            setattr(self, f"{scope}_ln",
                    nn.Parameter(torch.ones(dm, dtype=dt)))
        for name in (("wi_0", "wi_1") if config.is_gated else ("wi",)):
            setattr(self, name, nn.Linear(dm, dff, bias=False, dtype=dt))
        self.wo = nn.Linear(dff, dm, bias=False, dtype=dt)
        self.ffn_ln = nn.Parameter(torch.ones(dm, dtype=dt))
        self.is_decoder = is_decoder

    def forward(self, h, config: T5Config, self_bias, cross=None,
                cross_bias=None, lora: Optional[dict] = None,
                lora_scale: float = 0.0):
        nh, dk, eps = config.num_heads, config.d_kv, config.layer_norm_epsilon

        def p(name, x):
            fac = None if lora is None else lora.get(name)
            return dense(x, getattr(self, name), fac, lora_scale)

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], nh, dk)

        x = t5_layer_norm(h, self.self_ln, eps)
        att = _attn(split(p("self_q", x)), split(p("self_k", x)),
                    split(p("self_v", x)), self_bias)
        h = h + p("self_o", att)
        if cross is not None:
            x = t5_layer_norm(h, self.cross_ln, eps)
            att = _attn(split(p("cross_q", x)), split(p("cross_k", cross)),
                        split(p("cross_v", cross)), cross_bias)
            h = h + p("cross_o", att)
        x = t5_layer_norm(h, self.ffn_ln, eps)
        if config.is_gated:
            mid = config.act(p("wi_0", x)) * p("wi_1", x)
        else:
            mid = config.act(p("wi", x))
        return h + p("wo", mid)


class T5Stack(nn.Module):
    def __init__(self, config: T5Config, n_layers: int, is_decoder: bool):
        super().__init__()
        dt = config.param_dtype
        self.rel_bias = nn.Parameter(torch.zeros(
            config.relative_attention_num_buckets, config.num_heads,
            dtype=dt))
        self.layers = nn.ModuleList(T5Block(config, is_decoder)
                                    for _ in range(n_layers))
        self.final_ln = nn.Parameter(torch.ones(config.d_model, dtype=dt))

    def run(self, h, config: T5Config, self_bias, cross=None,
            cross_bias=None, lora: Optional[dict] = None,
            lora_scale: float = 0.0):
        layers = None if lora is None else lora.get("layers")
        for i, layer in enumerate(self.layers):
            li = (None if layers is None else
                  {n: {"a": f["a"][i], "b": f["b"][i]}
                   for n, f in layers.items()})
            h = layer(h, config, self_bias, cross, cross_bias, li,
                      lora_scale)
        return t5_layer_norm(h, self.final_ln, config.layer_norm_epsilon)


class T5ForConditionalGeneration(nn.Module):
    """Shared embedding → encoder; decoder (causal self-attention,
    cross-attention) → LM head (the shared embedding when tied)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        dt = config.param_dtype
        self.shared = nn.Embedding(config.vocab_size, config.d_model,
                                   dtype=dt)
        self.encoder = T5Stack(config, config.num_layers, False)
        self.decoder = T5Stack(config, config.num_decoder_layers, True)
        self.lm_head = (None if config.tie_word_embeddings
                        else nn.Linear(config.d_model, config.vocab_size,
                                       bias=False, dtype=dt))

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def _bias(self, stack: T5Stack, q_len: int, k_len: int,
              bidirectional: bool) -> torch.Tensor:
        cfg = self.config
        return position_bias(stack.rel_bias, q_len, k_len, bidirectional,
                             cfg.relative_attention_num_buckets,
                             cfg.relative_attention_max_distance)

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               lora: Optional[dict] = None,
               lora_scale: float = 0.0) -> torch.Tensor:
        """The encoder stack → [B, S, d_model]."""
        cfg = self.config
        h = self.shared(input_ids.long()).to(cfg.dtype)
        s = input_ids.shape[1]
        bias = (self._bias(self.encoder, s, s, True)
                + _mask_bias(attention_mask[:, None, None, :].bool()))
        return self.encoder.run(h, cfg, bias,
                                lora=None if lora is None
                                else lora.get("encoder"),
                                lora_scale=lora_scale)

    def forward_logits(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       decoder_input_ids: torch.Tensor,
                       decoder_attention_mask: Optional[torch.Tensor] = None,
                       lora: Optional[dict] = None,
                       lora_scale: float = 0.0) -> torch.Tensor:
        """The whole encoder-decoder → decoder LM logits [B, S_dec, V]."""
        cfg = self.config
        enc = self.encode(input_ids, attention_mask, lora, lora_scale)
        s_dec, s_enc = decoder_input_ids.shape[1], input_ids.shape[1]
        if decoder_attention_mask is None:
            decoder_attention_mask = torch.ones_like(decoder_input_ids)
        h = self.shared(decoder_input_ids.long()).to(cfg.dtype)
        causal = torch.ones(s_dec, s_dec, dtype=torch.bool,
                            device=h.device).tril()
        keep = (decoder_attention_mask[:, None, None, :].bool()
                & causal[None, None])
        self_bias = self._bias(self.decoder, s_dec, s_dec, False) + \
            _mask_bias(keep)
        cross_bias = _mask_bias(
            attention_mask[:, None, None, :].bool()).expand(
                -1, 1, s_dec, s_enc)
        h = self.decoder.run(h, cfg, self_bias, cross=enc,
                             cross_bias=cross_bias,
                             lora=None if lora is None
                             else lora.get("decoder"),
                             lora_scale=lora_scale)
        if self.lm_head is None:
            h = h * (cfg.d_model ** -0.5)
            return F.linear(h, self.shared.weight.to(h.dtype))
        return F.linear(h, self.lm_head.weight.to(h.dtype))


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

_BLOCK_RE = re.compile(r"(encoder|decoder)\.block\.(\d+)\.layer\.(\d+)\.(.+)$")
_SELF_MAP = {"SelfAttention.q.weight": "self_q",
             "SelfAttention.k.weight": "self_k",
             "SelfAttention.v.weight": "self_v",
             "SelfAttention.o.weight": "self_o",
             "layer_norm.weight": "self_ln"}
_CROSS_MAP = {"EncDecAttention.q.weight": "cross_q",
              "EncDecAttention.k.weight": "cross_k",
              "EncDecAttention.v.weight": "cross_v",
              "EncDecAttention.o.weight": "cross_o",
              "layer_norm.weight": "cross_ln"}
_FFN_MAP = {"DenseReluDense.wi.weight": "wi",
            "DenseReluDense.wi_0.weight": "wi_0",
            "DenseReluDense.wi_1.weight": "wi_1",
            "DenseReluDense.wo.weight": "wo",
            "layer_norm.weight": "ffn_ln"}


def _layer_maps(is_decoder: bool) -> list:
    """HF's sub-layer index → its fragment map, per stack."""
    return ([_SELF_MAP, _CROSS_MAP, _FFN_MAP] if is_decoder
            else [_SELF_MAP, _FFN_MAP])


def _param_name(name: str) -> str:
    return name if name.endswith("_ln") else f"{name}.weight"


def _target(raw_key: str) -> Optional[str]:
    """The module's parameter name for an HF tensor name, or None (the
    stacks' tied ``embed_tokens`` copies, anything unknown)."""
    if raw_key in ("shared.weight", "lm_head.weight"):
        return raw_key
    for side in ("encoder", "decoder"):
        if raw_key == f"{side}.final_layer_norm.weight":
            return f"{side}.final_ln"
        if (raw_key.startswith(side + ".")
                and raw_key.endswith("relative_attention_bias.weight")):
            return f"{side}.rel_bias"
    m = _BLOCK_RE.match(raw_key)
    if m is None:
        return None
    side, block, sub, frag = (m.group(1), int(m.group(2)), int(m.group(3)),
                              m.group(4))
    maps = _layer_maps(side == "decoder")
    if sub >= len(maps) or frag not in maps[sub]:
        return None
    return f"{side}.layers.{block}.{_param_name(maps[sub][frag])}"


def _empty_model(config: T5Config, device) -> T5ForConditionalGeneration:
    with torch.device("meta"):
        model = T5ForConditionalGeneration(config)
    model = model.to_empty(device=device)
    model.requires_grad_(False)
    return model


@torch.no_grad()
def params_from_hf_tensors(tensors, config: T5Config,
                           device="cuda") -> T5ForConditionalGeneration:
    """HF-named (name, tensor) pairs (a dict or an iterator) → the module on
    ``device``, each tensor cast to ``param_dtype`` as it is copied in;
    raises if the checkpoint lacks a tensor the module needs."""
    model = _empty_model(config, device)
    params = dict(model.named_parameters())
    filled = set()
    items = tensors.items() if isinstance(tensors, dict) else tensors
    for raw_key, value in items:
        name = _target(raw_key)
        if name is None or name not in params:
            continue
        dst = params[name]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{raw_key}: shape {tuple(value.shape)}, the "
                             f"model expects {tuple(dst.shape)}")
        dst.copy_(value)
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} tensors: "
                         f"{missing[:6]}")
    return model


def load_pretrained(model_dir: str, device="cuda", **overrides
                    ) -> tuple[T5ForConditionalGeneration, T5Config]:
    """(module, config) from a local HF T5 checkpoint directory."""
    from scaling_retriever_tpu_torch.models.hf_loader import _iter_hf_tensors

    config = T5Config.from_pretrained(model_dir, **overrides)
    return (params_from_hf_tensors(_iter_hf_tensors(model_dir), config,
                                   device), config)


def _hf_items(model: T5ForConditionalGeneration):
    yield "shared.weight", model.shared.weight
    if model.lm_head is not None:
        yield "lm_head.weight", model.lm_head.weight
    for side in ("encoder", "decoder"):
        stack = getattr(model, side)
        yield (f"{side}.block.0.layer.0.SelfAttention."
               f"relative_attention_bias.weight"), stack.rel_bias
        yield f"{side}.final_layer_norm.weight", stack.final_ln
        for i, layer in enumerate(stack.layers):
            for sub, frags in enumerate(_layer_maps(side == "decoder")):
                for frag, name in frags.items():
                    obj = getattr(layer, name, None)
                    if obj is not None:
                        yield (f"{side}.block.{i}.layer.{sub}.{frag}",
                               obj if name.endswith("_ln") else obj.weight)


def save_pretrained(model: T5ForConditionalGeneration, config: T5Config,
                    save_dir: str) -> None:
    """Write the module as an HF T5 checkpoint (one shard, tensors in
    ``param_dtype``) and its ``config.json``."""
    os.makedirs(save_dir, exist_ok=True)
    safetensors_io.save_file(_hf_items(model),
                             os.path.join(save_dir, "model.safetensors"))
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(config.to_hf_config(), f, indent=2)


# ---------------------------------------------------------------------------
# LoRA (the reference's targets q/v/o/k/wi_0/wi_1/wo)
# ---------------------------------------------------------------------------

T5_TARGET_MODULES = ("q", "v", "o", "k", "wi_0", "wi_1", "wo")

# peft module name -> the layer weights it applies to
_T5_TARGET_MAP = {
    "q": ("self_q", "cross_q"), "k": ("self_k", "cross_k"),
    "v": ("self_v", "cross_v"), "o": ("self_o", "cross_o"),
    "wi": ("wi",), "wi_0": ("wi_0",), "wi_1": ("wi_1",), "wo": ("wo",),
}


def _lora_targets(config: T5Config, target_modules):
    """(side, layer weight name, n layers) for every LoRA target, in the
    reference's order: ``wi`` exists only ungated, ``wi_0``/``wi_1`` only
    gated, cross-attention only in the decoder."""
    for mod in target_modules:
        for name in _T5_TARGET_MAP[mod]:
            if name.startswith("wi") and ((name == "wi") == config.is_gated):
                continue
            for side, nl in (("encoder", config.num_layers),
                             ("decoder", config.num_decoder_layers)):
                if side == "encoder" and name.startswith("cross"):
                    continue
                yield side, name, nl


def _fan_in_out(config: T5Config, name: str) -> tuple[int, int]:
    dm, inner, dff = config.d_model, config.inner_dim, config.d_ff
    if name.endswith("_o"):
        return inner, dm
    if name == "wo":
        return dff, dm
    if name.startswith("wi"):
        return dm, dff
    return dm, inner


def init_lora_params(config: T5Config, r: int, generator: torch.Generator,
                     target_modules=T5_TARGET_MODULES, dtype=torch.float32,
                     device="cuda") -> dict:
    """peft's init (A ~ U(+-1/sqrt(fan_in)), B = 0) for every target in
    both stacks; ``generator`` lives on ``device``. The draws differ from
    the JAX package's for any seed."""
    out: dict = {"encoder": {"layers": {}}, "decoder": {"layers": {}}}
    for side, name, nl in _lora_targets(config, target_modules):
        fan_in, fan_out = _fan_in_out(config, name)
        bound = 1.0 / math.sqrt(fan_in)
        a = torch.rand((nl, fan_in, r), generator=generator, device=device,
                       dtype=torch.float32) * (2 * bound) - bound
        out[side]["layers"][name] = {
            "a": a.to(dtype),
            "b": torch.zeros((nl, r, fan_out), dtype=dtype, device=device),
        }
    return out


_T5_ADAPTER_RE = re.compile(
    r"(encoder|decoder)\.block\.(\d+)\.layer\.(\d+)\."
    r"(SelfAttention|EncDecAttention|DenseReluDense)\.(\w+)\.lora_(A|B)"
    r"\.weight$")
_SCOPE_PREFIX = {"SelfAttention": "self_", "EncDecAttention": "cross_",
                 "DenseReluDense": ""}


def load_adapter(adapter_dir: str, config: T5Config, dtype=torch.float32,
                 device="cuda"):
    """A peft T5 LoRA adapter directory → (stacked factors on ``device``,
    LoraConfig)."""
    from scaling_retriever_tpu_torch.models.lora import (LoraConfig,
                                                        read_adapter_tensors)

    lora_config = LoraConfig.from_adapter_dir(adapter_dir)
    per: dict = {}
    for raw_key, val in read_adapter_tensors(adapter_dir).items():
        m = _T5_ADAPTER_RE.search(raw_key)
        if m is None:
            continue
        side, block, scope, mod, ab = (m.group(1), int(m.group(2)),
                                       m.group(4), m.group(5), m.group(6))
        slot = per.setdefault((side, _SCOPE_PREFIX[scope] + mod),
                              {"a": {}, "b": {}})
        # peft A [r, in], B [out, r] → a [in, r], b [r, out]
        slot["a" if ab == "A" else "b"][block] = val.T
    out: dict = {"encoder": {"layers": {}}, "decoder": {"layers": {}}}
    for (side, name), slot in per.items():
        nl = (config.num_layers if side == "encoder"
              else config.num_decoder_layers)
        if len(slot["a"]) != nl or len(slot["b"]) != nl:
            raise ValueError(f"adapter {adapter_dir}: {side} {name} has "
                             f"{len(slot['a'])}/{len(slot['b'])} A/B layers, "
                             f"the model {nl}")
        out[side]["layers"][name] = {
            ab: torch.stack([slot[ab][i] for i in range(nl)]).to(
                device=device, dtype=dtype)
            for ab in ("a", "b")}
    return out, lora_config


def save_adapter(lora: dict, lora_config, save_dir: str) -> None:
    """Write a peft-compatible T5 adapter: f32 ``adapter_model.safetensors``
    and ``adapter_config.json``."""
    from scaling_retriever_tpu_torch.models.lora import (ADAPTER_CONFIG,
                                                        ADAPTER_FILE)

    os.makedirs(save_dir, exist_ok=True)
    tensors = {}
    for side in ("encoder", "decoder"):
        maps = _layer_maps(side == "decoder")
        for name, fac in lora.get(side, {}).get("layers", {}).items():
            if name.startswith(("self_", "cross_")):
                scope, mod = name.split("_", 1)
                scope = {"self": "SelfAttention",
                         "cross": "EncDecAttention"}[scope]
                sub = 0 if scope == "SelfAttention" else 1
            else:
                scope, mod, sub = "DenseReluDense", name, len(maps) - 1
            a, b = fac["a"].detach().float(), fac["b"].detach().float()
            for i in range(a.shape[0]):
                key = (f"base_model.model.{side}.block.{i}.layer.{sub}."
                       f"{scope}.{mod}")
                tensors[f"{key}.lora_A.weight"] = a[i].T.contiguous()
                tensors[f"{key}.lora_B.weight"] = b[i].T.contiguous()
    safetensors_io.save_file(tensors, os.path.join(save_dir, ADAPTER_FILE))
    with open(os.path.join(save_dir, ADAPTER_CONFIG), "w") as f:
        json.dump(lora_config.to_adapter_config(), f, indent=2)


@torch.no_grad()
def merge_lora(model: T5ForConditionalGeneration, lora: dict,
               scaling: float) -> T5ForConditionalGeneration:
    """Fold the factors into ``model``'s weights IN PLACE (the delta formed
    in float32, as in the reference) and return it."""
    for side in ("encoder", "decoder"):
        stack = getattr(model, side)
        for name, fac in lora.get(side, {}).get("layers", {}).items():
            for i, layer in enumerate(stack.layers):
                w = getattr(layer, name).weight              # [out, in]
                delta = (fac["a"][i].float() @ fac["b"][i].float()) * scaling
                w.copy_((w.float() + delta.T.to(w.device)).to(w.dtype))
    return model
