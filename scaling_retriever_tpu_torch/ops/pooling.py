"""Pooling heads (port of ops/pooling.py). The op order is the reference's:

  * sparse: logits scaled by ``hidden_size**-0.25``, then
    ``log(relu(max_seq(x + (1-mask) * -1e6)) + 1)``: max BEFORE relu/log;
  * sparse per token (the T5 head): ``max_s(log1p(relu(x)) * mask)``:
    log per token, THEN the max, with the ``d_model**-0.25`` scale only
    when the caller asks (the reference scales only at d_model >= 2048);
  * dense: per-token L2 normalize BEFORE the masked mean.

The sparse head's masked max runs over vocabulary chunks and keeps the
logits in their own dtype for the backward, never a float32 copy of the
whole [B, S, V] slab (8.9 GB for 136 contexts of 128 tokens at Llama-3's
vocabulary). Its values and gradients are those of the plain expression:
the backward splits a maximum's gradient evenly among tied positions, as
``amax``'s does.
"""

from __future__ import annotations

import torch

_NEG = -1e6
_NORM_EPS = 1e-12
_V_CHUNK = 8192


class _MaskedMax(torch.autograd.Function):
    """``(logits.float() * scale + penalty).amax(dim=1)``, over chunks of
    the last dimension."""

    @staticmethod
    def forward(ctx, logits, penalty, scale: float):
        b_, _, v = logits.shape
        out = torch.empty(b_, v, dtype=torch.float32, device=logits.device)
        for v0 in range(0, v, _V_CHUNK):
            x = logits[:, :, v0:v0 + _V_CHUNK].float() * scale + penalty
            out[:, v0:v0 + _V_CHUNK] = x.amax(dim=1)
        ctx.save_for_backward(logits, penalty, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        logits, penalty, out = ctx.saved_tensors
        scale = ctx.scale
        grad = torch.empty_like(logits)
        for v0 in range(0, logits.shape[2], _V_CHUNK):
            sl = slice(v0, v0 + _V_CHUNK)
            x = logits[:, :, sl].float() * scale + penalty
            at_max = x == out[:, None, sl]
            g = grad_out[:, None, sl] / at_max.sum(dim=1, keepdim=True)
            grad[:, :, sl] = (g * at_max * scale).to(logits.dtype)
        return grad, None, None


def sparse_pool(seq_logits: torch.Tensor, attention_mask: torch.Tensor,
                hidden_size: int) -> torch.Tensor:
    """[B, S, V] LM-head logits → [B, V] SPLADE-style sparse reps (f32)."""
    penalty = (1.0 - attention_mask.float())[:, :, None] * _NEG
    pooled = _MaskedMax.apply(seq_logits, penalty,
                              float(hidden_size) ** -0.25)
    return torch.log(torch.relu(pooled) + 1.0)


def sparse_pool_per_token(seq_logits: torch.Tensor,
                          attention_mask: torch.Tensor, d_model: int,
                          scale: bool) -> torch.Tensor:
    """[B, S, V] decoder logits → [B, V] f32 reps, T5-style:
    ``max_s(log1p(relu(x)) * mask)``, x scaled by ``d_model**-0.25`` when
    ``scale``. Plain autograd (each f32 copy it keeps is 2.2 GB at the T5
    recipe's 136 x 128 x 32,128)."""
    x = seq_logits.float()
    if scale:
        x = x * (float(d_model) ** -0.25)
    per_tok = torch.log1p(torch.relu(x)) * attention_mask.float()[:, :, None]
    return per_tok.amax(dim=1)


def dense_pool(hidden: torch.Tensor, attention_mask: torch.Tensor
               ) -> torch.Tensor:
    """[B, S, H] hidden states → [B, H]: L2-normalize per token, masked
    mean."""
    h = hidden.float()
    h = h / h.norm(dim=-1, keepdim=True).clamp_min(_NORM_EPS)
    m = attention_mask.float()[:, :, None]
    return (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
