"""Bidirectional Llama-3 transformer (port of models/llama.py) as an
``nn.Module``.

Non-causality is the absence of a causal term in the additive attention
bias: the only mask is the key-padding mask from ``attention_mask``. The
bias is finite (``MASK_VALUE``) and softmax runs in float32, so a fully
masked row (an all-pad query) gets a uniform softmax rather than NaN, as in
the reference. RMSNorm statistics and rope also run in float32. Position
ids are ``arange(seq_len)`` including pad positions. Rope and attention are
``ops/attention.py``'s; a forward no gradient flows through runs the two as
one kernel launch on the card.

Projections are ``nn.Linear`` modules (weight [out, in]); the JAX package
stores [in, out] and ``models/weights.py`` transposes on the way in. LoRA
factors (the reference's stacked ``{"a": [L, in, r], "b": [L, r, out]}``
layout) ride as an optional additive branch.

Training runs the same forward under autograd. LoRA dropout (inverted, on
the branch's input only) is on only when a ``dropout_seed`` is passed;
each mask is drawn from a generator seeded by (seed, layer, slot) through
``fold_in``, so a layer that ``config.remat`` recomputes in the backward
draws the same masks again. Over several ranks (a ``Part``, see
``parallel/collectives.py``) a rank draws the global batch's mask and keeps
its rows (and, for a row-parallel projection, its features), so the masks
are those of one process over the global batch. Under tensor parallelism
(``parallel/partitioning.py`` leaves each rank its shard of the q/k/v/
gate/up output rows and of the o/down input columns) the projections run
column- and row-parallel, and attention runs this rank's heads.

``remat`` takes the reference's values: full remat checkpoints each
layer; the dots policies save the matmul outputs (torch's selective
activation checkpointing); the named policies save the layer's named
tensors (``REMAT_NAMES``) by checkpointing the stages between them.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.ops.attention import (apply_rope, attention,
                                                      rope_attention)
from scaling_retriever_tpu_torch.parallel.collectives import (Part,
                                                             from_model,
                                                             to_model)
from scaling_retriever_tpu_torch.utils.profiling import profile_span

MASK_VALUE = -1e9
_M64 = (1 << 64) - 1

# the tensors a "names:..." remat policy may save, in layer order, and the
# two sets the reference's CLIs name ("attn", "attn_mlp")
REMAT_NAMES = ("attn_q", "attn_k", "attn_v", "attn_out", "mlp_mid")
_NAMED_SETS = {REMAT_NAMES[:4]: False, REMAT_NAMES: True}
# the matmul ops of a layer under autograd: projections reach mm/addmm, the
# attention einsums bmm (the reference's dots with batch dimensions)
_DOTS = {"dots_saveable": (torch.ops.aten.mm.default,
                           torch.ops.aten.addmm.default,
                           torch.ops.aten.bmm.default),
         "dots_with_no_batch_dims_saveable": (torch.ops.aten.mm.default,
                                              torch.ops.aten.addmm.default)}


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed from (seed, data) by splitmix64: the port's
    counterpart of ``jax.random.fold_in`` (other bits, the same role)."""
    z = (seed ^ ((data + 1) * 0x9E3779B97F4A7C15)) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with float32 statistics (HF LlamaRMSNorm numerics)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention-temperature factor (HF DeepSeek-V2's
    ``yarn_get_mscale``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _yarn_inv_freq(inv_freq: torch.Tensor, rs: dict, dim: int,
                   base: float) -> torch.Tensor:
    """HF DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` frequencies:
    interpolated (divided by the factor) below the correction range,
    extrapolated (as they are) above it, a linear ramp between."""
    old_len = rs["original_max_position_embeddings"]

    def corr_dim(rotations: float) -> float:
        return (dim * math.log(old_len / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr_dim(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(corr_dim(rs.get("beta_slow", 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    return inv_freq / rs["factor"] * ramp + inv_freq * (1 - ramp)


def rope_inv_freq(config: ModelConfig) -> torch.Tensor:
    """Inverse frequencies (float32, CPU) over ``config.rope_dim``, with
    HF-compatible llama3, linear and yarn rope scaling."""
    hd = config.rope_dim
    inv_freq = 1.0 / (config.rope_theta
                      ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    rs = config.rope_scaling
    if rs is None:
        return inv_freq
    rope_type = rs.get("rope_type", rs.get("type", "default"))
    if rope_type in ("default", None):
        return inv_freq
    if rope_type == "linear":
        return inv_freq / rs["factor"]
    if rope_type == "llama3":
        factor = rs["factor"]
        low = rs["low_freq_factor"]
        high = rs["high_freq_factor"]
        old_len = rs["original_max_position_embeddings"]
        low_wavelen = old_len / low
        high_wavelen = old_len / high
        wavelen = 2 * math.pi / inv_freq
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low) / (high - low)
        smoothed = (1 - smooth) * scaled / factor + smooth * scaled
        is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        return torch.where(is_medium, smoothed, scaled)
    if rope_type == "yarn":
        return _yarn_inv_freq(inv_freq, rs, hd, config.rope_theta)
    raise NotImplementedError(f"rope_scaling type {rope_type!r}")


def _rope_mscale(config: ModelConfig) -> float:
    """The factor on yarn's cos and sin tables: mscale(factor, mscale) /
    mscale(factor, mscale_all_dim) (1 for every other rope type)."""
    rs = config.rope_scaling or {}
    if rs.get("rope_type", rs.get("type")) != "yarn":
        return 1.0
    return (yarn_mscale(rs["factor"], rs.get("mscale", 1))
            / yarn_mscale(rs["factor"], rs.get("mscale_all_dim", 0)))


def rope_cos_sin(config: ModelConfig, seq_len: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """[seq_len, rope_dim] float32 cos/sin tables (HF layout: freqs
    doubled)."""
    inv_freq = rope_inv_freq(config).to(device)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = pos[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _rope_mscale(config)
    if m == 1.0:
        return emb.cos(), emb.sin()
    return emb.cos() * m, emb.sin() * m


class RopeTables:
    """A model's rope tables: ``rope_cos_sin`` for each (seq_len, device)
    it has run at, built at the first forward of that length and kept in
    ``built``. Building copies the frequencies from the host and waits for
    the copy, which a CUDA graph capture refuses, so a capture only reads
    a table its eager pass built; the graph reads it on every replay, so
    nothing is evicted. A table is built outside inference mode, so one
    built by ``encode()`` serves a later training forward too."""

    def __init__(self, config: ModelConfig):
        self.config = config
        self.built: dict = {}

    def __call__(self, seq_len: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        key = (seq_len, torch.device(device))
        tables = self.built.get(key)
        if tables is None:
            with torch.inference_mode(False):
                tables = rope_cos_sin(self.config, seq_len, device)
            # the first table stored wins if two threads built one
            tables = self.built.setdefault(key, tables)
        return tables


def _tp(weight) -> Optional[tuple]:
    """(kind, rank, size, group) of a projection whose weight is this
    rank's tensor-parallel shard (a DTensor split over a ``model`` mesh
    axis): "col" for output rows ([out, in] dim 0), "row" for input
    columns; None for a whole weight."""
    if not isinstance(weight, DTensor) or \
            "model" not in weight.device_mesh.mesh_dim_names:
        return None
    mesh = weight.device_mesh
    at = mesh.mesh_dim_names.index("model")
    kind = {0: "col", 1: "row"}[weight.placements[at].dim]
    return (kind, mesh.get_local_rank("model"), mesh.size(at),
            mesh.get_group("model"))


def _uniform(shape, g: torch.Generator, device, part: Optional[Part],
             tp: Optional[tuple]) -> torch.Tensor:
    """U[0, 1) of ``shape``; with a ``part``, this rank's slice of the
    draw over the global batch (and over every rank's features of a
    row-parallel input), so its bits are one process's."""
    if part is None and tp is None:
        return torch.rand(shape, generator=g, device=device)
    rows, row0 = (shape[0], 0) if part is None else (part.rows, part.row0)
    row = tp is not None and tp[0] == "row"
    feats = shape[-1] * (tp[2] if row else 1)
    u = torch.rand((rows, *shape[1:-1], feats), generator=g,
                   device=device)[row0:row0 + shape[0]]
    if row:
        u = u[..., tp[1] * shape[-1]:(tp[1] + 1) * shape[-1]]
    return u


def dense(x: torch.Tensor, linear: nn.Linear, lora: Optional[dict] = None,
          lora_scale: float = 0.0, lora_dropout: float = 0.0,
          dropout_seed: Optional[int] = None,
          part: Optional[Part] = None) -> torch.Tensor:
    """``linear(x)`` plus an optional LoRA branch ``(x @ A) @ B * s``, with
    inverted dropout on the branch's input when ``dropout_seed`` is given
    (the mask drawn from a generator seeded with it). A ``linear`` whose
    weight is a tensor-parallel shard (``_tp``) runs column- or
    row-parallel over the model group: the branch takes the matching
    columns of B or rows of A, and a row-parallel output is summed over
    the group."""
    tp = _tp(linear.weight)
    if tp is None:
        y = linear(x)
    else:
        if tp[0] == "col":
            x = to_model(x, tp[3])
        bias = None if linear.bias is None else linear.bias.to_local()
        y = F.linear(x, linear.weight.to_local(), bias)
    if lora is not None:
        a, b = lora["a"], lora["b"]
        if tp is not None and tp[0] == "col":
            n = b.shape[-1] // tp[2]
            b = b[:, tp[1] * n:(tp[1] + 1) * n]
        elif tp is not None:
            n = a.shape[0] // tp[2]
            a = a[tp[1] * n:(tp[1] + 1) * n]
        xl = x
        if lora_dropout > 0.0 and dropout_seed is not None:
            keep = 1.0 - lora_dropout
            g = torch.Generator(device=x.device).manual_seed(dropout_seed)
            mask = _uniform(x.shape, g, x.device, part, tp) < keep
            xl = torch.where(mask, x / keep, 0.0).to(x.dtype)
        y = y + (xl @ a.to(x.dtype)) @ b.to(x.dtype) * lora_scale
    if tp is not None and tp[0] == "row":
        y = from_model(y, tp[3])
    return y


def padding_bias(attention_mask: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """[B, S] {0,1} key-padding mask → additive bias [B, 1, 1, S]."""
    keep = attention_mask[:, None, None, :].bool()
    return torch.where(keep, 0.0, MASK_VALUE).to(dtype)


class LlamaLayer(nn.Module):
    """Pre-norm attention + SwiGLU MLP, bidirectional. The forward runs as
    four stages (q/k/v, attention output, MLP mid, MLP output) so that a
    named remat policy can checkpoint the stages between the tensors it
    saves."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        h, q, kv, i = (config.hidden_size, config.q_dim, config.kv_dim,
                       config.intermediate_size)
        dt = config.param_dtype
        bias = config.attention_qkv_bias
        self.wq = nn.Linear(h, q, bias=bias, dtype=dt)
        self.wk = nn.Linear(h, kv, bias=bias, dtype=dt)
        self.wv = nn.Linear(h, kv, bias=bias, dtype=dt)
        self.wo = nn.Linear(q, h, bias=False, dtype=dt)
        self.wg = nn.Linear(h, i, bias=False, dtype=dt)
        self.wu = nn.Linear(h, i, bias=False, dtype=dt)
        self.wd = nn.Linear(i, h, bias=False, dtype=dt)
        self.input_norm = nn.Parameter(torch.ones(h, dtype=dt))
        self.post_attn_norm = nn.Parameter(torch.ones(h, dtype=dt))

    def _dn(self, x, name, group, slot, c):
        fac = None if c["lora"] is None else c["lora"].get(group, {}).get(name)
        seed = (None if c["seed"] is None else fold_in(c["seed"], slot))
        return dense(x, getattr(self, name), fac, c["scale"], c["dropout"],
                     seed, c["part"])

    def _proj(self, h, c):
        cfg = c["config"]
        b_, s, _ = h.shape
        hd = cfg.head_dim_
        x = rms_norm(h, self.input_norm, cfg.rms_norm_eps)
        # this rank's heads under tensor parallelism, else all of them
        q = self._dn(x, "wq", "attn", 0, c).reshape(b_, s, -1, hd)
        k = self._dn(x, "wk", "attn", 1, c).reshape(b_, s, -1, hd)
        v = self._dn(x, "wv", "attn", 2, c).reshape(b_, s, -1, hd)
        return q, k, v

    def _qkv(self, h, c):
        q, k, v = self._proj(h, c)
        return (apply_rope(q, c["cos"], c["sin"]),
                apply_rope(k, c["cos"], c["sin"]), v)

    def _attn_out(self, q, k, v, c):
        return self._dn(attention(q, k, v, c["bias"], c["config"]), "wo",
                        "attn", 3, c)

    def _attn(self, h, c):
        """The attention block. Where no gradient will flow through the
        bf16 projections, rope and attention run as ``rope_attention``
        (one kernel launch on the card); a forward autograd records runs
        them as ``apply_rope`` and ``attention``."""
        q, k, v = self._proj(h, c)
        if q.dtype == torch.bfloat16 and not (
                q.requires_grad or k.requires_grad or v.requires_grad):
            return self._dn(rope_attention(q, k, v, c["cos"], c["sin"],
                                           c["bias"]), "wo", "attn", 3, c)
        return self._attn_out(apply_rope(q, c["cos"], c["sin"]),
                              apply_rope(k, c["cos"], c["sin"]), v, c)

    def _mlp_mid(self, h, c):
        x = rms_norm(h, self.post_attn_norm, c["config"].rms_norm_eps)
        return F.silu(self._dn(x, "wg", "mlp", 4, c)) * self._dn(
            x, "wu", "mlp", 5, c)

    def _mlp_out(self, mid, c):
        return self._dn(mid, "wd", "mlp", 6, c)

    def _mlp(self, h, c):
        return self._mlp_out(self._mlp_mid(h, c), c)

    def forward(self, h, bias, cos, sin, config: ModelConfig,
                lora: Optional[dict] = None, lora_scale: float = 0.0,
                lora_dropout: float = 0.0, dropout_seed: Optional[int] = None,
                part: Optional[Part] = None, save_mid: Optional[bool] = None):
        """One layer. ``save_mid`` None runs it plainly; False or True
        checkpoints the stages between q/k/v and the attention output (and,
        when True, the MLP mid), which are then saved for the backward."""
        c = {"bias": bias, "cos": cos, "sin": sin, "config": config,
             "lora": lora, "scale": lora_scale, "dropout": lora_dropout,
             "seed": dropout_seed, "part": part}
        if save_mid is None:
            h = h + self._attn(h, c)
            return h + self._mlp(h, c)
        ck = partial(checkpoint, use_reentrant=False)
        q, k, v = ck(self._qkv, h, c)
        h = h + ck(self._attn_out, q, k, v, c)
        if save_mid:
            return h + ck(self._mlp_out, ck(self._mlp_mid, h, c), c)
        return h + ck(self._mlp, h, c)


def _dots_policy(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_layer(layer: LlamaLayer, remat, *args):
    """One layer under the config's remat value (see ModelConfig.remat)."""
    if remat is False:
        return layer(*args)
    if remat is True:
        return checkpoint(layer, *args, use_reentrant=False)
    if remat in _DOTS:
        ctx = partial(create_selective_checkpoint_contexts,
                      partial(_dots_policy, _DOTS[remat]))
        return checkpoint(layer, *args, use_reentrant=False, context_fn=ctx)
    if isinstance(remat, str) and remat.startswith("names:"):
        asked = set(remat[len("names:"):].split(","))
        key = tuple(n for n in REMAT_NAMES if n in asked)
        if set(key) == asked and key in _NAMED_SETS:
            return layer(*args, save_mid=_NAMED_SETS[key])
    raise NotImplementedError(
        f"remat {remat!r}: the port takes False, True, {sorted(_DOTS)} "
        f"and 'names:' over {REMAT_NAMES[:4]} with or without mlp_mid")


def _layer_lora(lora: Optional[dict], i: int) -> Optional[dict]:
    """Layer i's factors from the stacked layout."""
    if lora is None or "layers" not in lora:
        return None
    return {g: {n: {"a": f["a"][i], "b": f["b"][i]} for n, f in mods.items()}
            for g, mods in lora["layers"].items()}


class LlamaBiForMNTP(nn.Module):
    """Embeddings → bidirectional layers → final norm → LM head (tied to
    the embeddings when ``tie_word_embeddings``)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        dt = config.param_dtype
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, dtype=dt)
        self.layers = nn.ModuleList(LlamaLayer(config)
                                    for _ in range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(config.hidden_size, dtype=dt))
        self.lm_head = (None if config.tie_word_embeddings
                        else nn.Linear(config.hidden_size, config.vocab_size,
                                       bias=False, dtype=dt))
        self.rope = RopeTables(config)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward_hidden(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       lora: Optional[dict] = None,
                       lora_scale: float = 0.0, lora_dropout: float = 0.0,
                       dropout_seed: Optional[int] = None,
                       part: Optional[Part] = None) -> torch.Tensor:
        """[B, S] ids and mask → final-norm hidden states [B, S, H]. Layers
        are rematerialized per ``config.remat`` only while autograd
        records. ``part``: this rank's place in a training step over
        several ranks. The span ``encoder.layers`` covers the embedding,
        the layers and the final norm."""
        cfg = self.config
        use_dropout = (lora is not None and lora_dropout > 0.0
                       and dropout_seed is not None)
        remat = cfg.remat if torch.is_grad_enabled() else False
        with profile_span("encoder.layers"):
            h = self.embed_tokens(input_ids.long()).to(cfg.dtype)
            bias = padding_bias(attention_mask)
            cos, sin = self.rope(input_ids.shape[1], h.device)
            for i, layer in enumerate(self.layers):
                h = _run_layer(layer, remat, h, bias, cos, sin, cfg,
                               _layer_lora(lora, i), lora_scale,
                               lora_dropout if use_dropout else 0.0,
                               fold_in(dropout_seed, i) if use_dropout
                               else None, part)
            return rms_norm(h, self.final_norm, cfg.rms_norm_eps)

    def forward_logits(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       lora: Optional[dict] = None,
                       lora_scale: float = 0.0, lora_dropout: float = 0.0,
                       dropout_seed: Optional[int] = None,
                       part: Optional[Part] = None) -> torch.Tensor:
        """LM-head logits [B, S, V] (no dropout on the head's LoRA, as in
        the reference)."""
        if self.lm_head is None and not self.config.tie_word_embeddings:
            raise ValueError("this model carries no LM head (untied "
                             "embeddings, weights without an lm_head)")
        h = self.forward_hidden(input_ids, attention_mask, lora, lora_scale,
                                lora_dropout, dropout_seed, part)
        with profile_span("encoder.head"):
            if self.lm_head is None:
                return F.linear(h, self.embed_tokens.weight.to(h.dtype))
            head_lora = None if lora is None else lora.get("lm_head")
            return dense(h, self.lm_head, head_lora, lora_scale)
