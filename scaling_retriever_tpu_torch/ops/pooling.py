"""Pooling heads (port of ops/pooling.py). The op order is the reference's:

  * sparse: logits scaled by ``hidden_size**-0.25``, then
    ``log(relu(max_seq(x + (1-mask) * -1e6)) + 1)``: max BEFORE relu/log;
  * dense: per-token L2 normalize BEFORE the masked mean.
"""

from __future__ import annotations

import torch

_NEG = -1e6
_NORM_EPS = 1e-12


def sparse_pool(seq_logits: torch.Tensor, attention_mask: torch.Tensor,
                hidden_size: int) -> torch.Tensor:
    """[B, S, V] LM-head logits → [B, V] SPLADE-style sparse reps (f32)."""
    x = seq_logits.float() * (float(hidden_size) ** -0.25)
    penalty = (1.0 - attention_mask.float())[:, :, None] * _NEG
    pooled = (x + penalty).amax(dim=1)
    return torch.log(torch.relu(pooled) + 1.0)


def dense_pool(hidden: torch.Tensor, attention_mask: torch.Tensor
               ) -> torch.Tensor:
    """[B, S, H] hidden states → [B, H]: L2-normalize per token, masked
    mean."""
    h = hidden.float()
    h = h / h.norm(dim=-1, keepdim=True).clamp_min(_NORM_EPS)
    m = attention_mask.float()[:, :, None]
    return (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
