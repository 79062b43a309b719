"""The plain reference of the sparse encoders: a bidirectional decoder
(RMSNorm, RoPE, non-causal grouped-query attention, SwiGLU, Qwen2's q/k/v
bias) and the SPLADE head, ``log(1 + relu(max over the text's tokens of
the LM-head logits * hidden**-0.25))``, in float32 with TF32 off.

It follows the published Llama/Qwen2/Mistral layer equations. Departures,
none of which changes the result: each text runs at positions 0..n-1 with
no padding token (pads are masked keys and masked from the max, and RoPE
sees only relative positions, so left padding changes nothing), and
Mistral's 4,096-token sliding window is left out (every text is shorter).

The weights are the benchmark's (``retrieval_bench.gen``), drawn again
here layer by layer in float32 from the same bits as the served bf16.
``precision="fp8"`` is the control: every linear layer's input and
weight rounded to float8 e4m3 with a per-tensor scale, as an fp8 serving
path would, accumulated in float32.
"""

from __future__ import annotations

import contextlib
import math

import torch

from retrieval_bench import gen

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products with TF32 off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at the per-tensor scale amax / 448 (float32)."""
    s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w.T, w [out, in]."""
    if precision == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return x @ w.T


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, N, hd] at positions 0..S-1, rotate-half convention."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    f = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([f, f], -1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def layer(m: dict, w: dict, x: torch.Tensor, keep: torch.Tensor,
          precision: str, lora=None, scale: float = 0.0) -> torch.Tensor:
    """One bidirectional decoder layer; ``keep`` [B, S] marks real
    tokens (the keys attention may read). ``lora`` maps a projection's
    name to its factors (a [in, r], b [r, out]): ``y += x @ a @ b *
    scale``."""
    def proj(v, name):
        y = linear(v, w[name], precision)
        if lora is not None and name in lora:
            a, b = lora[name]
            y = y + (v @ a) @ b * scale
        return y

    b, s, _ = x.shape
    hd = gen.head_dim(m)
    nq, nkv = m["num_attention_heads"], m["num_key_value_heads"]
    eps = m["rms_norm_eps"]
    h = rms_norm(x, w["input_norm"], eps)
    q = proj(h, "wq")
    k = proj(h, "wk")
    v = proj(h, "wv")
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.view(b, s, nq, hd), m["rope_theta"])
    k = rope(k.view(b, s, nkv, hd), m["rope_theta"])
    v = v.view(b, s, nkv, hd)
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    att = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
    att = att.masked_fill(~keep[:, None, None, :], float("-inf"))
    out = torch.einsum("bnqk,bknd->bqnd", att.softmax(-1), v)
    x = x + proj(out.reshape(b, s, nq * hd), "wo")
    h = rms_norm(x, w["post_attn_norm"], eps)
    mid = torch.nn.functional.silu(proj(h, "wg")) * proj(h, "wu")
    return x + proj(mid, "wd")


def sparse_reps(m: dict, seed: int, token_lists: list, device,
                precision: str = "f32", rows: int = 64) -> torch.Tensor:
    """[n, vocab] float32 reps of the texts' token lists, ``rows`` texts
    at a time through all layers."""
    out = []
    with exact_f32():
        emb = gen.embed_weights(m, seed, device)
        table = emb["embed"].float()
        head = gen.head_weight(m, seed, device)
        head = table if head is None else head.float()
        final = emb["final_norm"].float()
        for r0 in range(0, len(token_lists), rows):
            chunk = token_lists[r0:r0 + rows]
            s = max(len(t) for t in chunk)
            ids = torch.zeros((len(chunk), s), dtype=torch.long)
            keep = torch.zeros((len(chunk), s), dtype=torch.bool)
            for i, t in enumerate(chunk):
                ids[i, :len(t)] = torch.tensor(t)
                keep[i, :len(t)] = True
            ids, keep = ids.to(device), keep.to(device)
            x = table[ids]
            for li in range(m["num_hidden_layers"]):
                w = {k: v.float() for k, v in
                     gen.layer_weights(m, seed, li, device).items()}
                x = layer(m, w, x, keep, precision)
            x = rms_norm(x, final, m["rms_norm_eps"])
            logits = linear(x, head, precision)
            logits = logits * float(m["hidden_size"]) ** -0.25
            logits = logits.masked_fill(~keep[:, :, None], float("-inf"))
            out.append(torch.log1p(torch.relu(logits.amax(dim=1))))
    return torch.cat(out)
