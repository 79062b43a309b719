"""The Llama-family attention block: rope on q and k, then GQA attention
(port of the JAX package's ``models/llama.py`` ``apply_rope`` and
``attention``), and the two as one kernel for a forward no gradient flows
through (``csrc/attention.cu``; no counterpart in the JAX package, whose
attention is jnp).

``apply_rope`` and ``attention`` are the block's plain steps: rope in
float32 cast back, then logits and softmax in float32 and bf16 P.V.
``rope_attention`` computes ``attention(apply_rope(q), apply_rope(k), v)``
in one call: on CPU tensors as exactly that composition
(``rope_attention_plain``), on the card as one launch of the kernel, which
rounds where the two steps round and sums in another order. The kernel has
no backward, so ``models/llama.py`` calls it only where no gradient flows;
on the card it launches or raises (its instances take head dims that are
multiples of 16 up to 128).
"""

from __future__ import annotations

import math

import torch

from scaling_retriever_tpu_torch.ops import cuda_lib

# the kernel's instances (csrc/attention.cu by_head_dim)
HEAD_DIMS = tuple(range(16, 129, 16))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, N, hd]; cos/sin [S, hd]. Computed in float32, cast back."""
    xf = x.float()
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, config=None) -> torch.Tensor:
    """GQA attention, logits and softmax in float32. q [B, S, Nq, hd], k/v
    [B, S, Nkv, hd], bias [B, 1, 1, S] → [B, S, Nq * hd]."""
    b_, s, nq, hd = q.shape
    rep = nq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd)) + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v)
    return out.reshape(b_, s, nq * hd)


def rope_attention_plain(q, k, v, cos, sin, bias) -> torch.Tensor:
    return attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                     bias)


def rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, bias: torch.Tensor
                   ) -> torch.Tensor:
    """q [B, S, Nq, hd] and k, v [B, S, Nkv, hd], unroped; cos/sin [S, hd]
    and bias [B, 1, 1, S] float32 → [B, S, Nq * hd]:
    ``attention(apply_rope(q), apply_rope(k), v, bias)``."""
    b_, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    if (k.shape != (b_, s, n_kv, hd) or v.shape != k.shape or n_q % n_kv
            or cos.shape != (s, hd) or sin.shape != cos.shape
            or bias.shape != (b_, 1, 1, s)):
        raise ValueError(
            f"rope_attention takes q [B, S, Nq, hd], k and v [B, S, Nkv, hd] "
            f"with Nkv dividing Nq, cos and sin [S, hd], bias [B, 1, 1, S]; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(cos.shape)}, {tuple(sin.shape)}, {tuple(bias.shape)}")
    if q.device.type == "cpu":
        return rope_attention_plain(q, k, v, cos, sin, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no rope_attention for device {q.device}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_cuda(name, t, torch.bfloat16, dev)
    for name, t in (("cos", cos), ("sin", sin), ("bias", bias)):
        cuda_lib.check_cuda(name, t, torch.float32, dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"rope_attention's kernel takes head dims that "
                         f"are multiples of 16 up to 128, got {hd}")
    out = torch.empty(b_, s, n_q * hd, dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    cuda_lib.launch("rope_attention", "srt_rope_attention", dev,
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), bias.data_ptr(), out.data_ptr(), b_, s,
                    n_q, n_kv, hd, 1.0 / math.sqrt(hd))
    return out
