"""A Kimi Delta Attention layer's mixing after its projections (the
linear-attention layers of Kimi-Linear, ``models/kimi_linear.py``; no
counterpart in the JAX package): from the raw projections q, k, v [B, S,
n d] (a pad position's taken as 0), each through its depthwise causal
convolution of width K and SiLU; q and k L2-normalised over each head's d
channels (eps 1e-6), q times d**-0.5; the per-channel decay ``g =
-exp(A_log[h]) softplus(f + dt_bias)``; per text and head a state S [d,
d], zero at the first position, advanced and read at each position t:

    S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

(the gated delta rule), then ``RMSNorm(o_t) w_norm sigmoid(gate_t)`` over
each head (eps given). beta [B, S, n] is the write strength; 0 at a pad,
so a pad adds nothing to a state, and with the pads' projections at 0 none
enters a real position's convolution window either.

``delta_attention`` launches ``csrc/kda.cu`` (one launch a call, no host
read, so it runs inside a captured CUDA graph; counted under ``kda`` in
``cuda_lib.LAUNCHES``) for tensors on the card, and takes the plain
PyTorch steps here (the recurrence a token loop) for CPU tensors only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scaling_retriever_tpu_torch.ops import cuda_lib

NORM_EPS = 1e-6
HEAD_DIM = 128          # the kernel's d (csrc/kda.cu D)
CONV_WIDTH = 4          # the kernel's convolution width (csrc/kda.cu K)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x over its last dimension, in float32: ``x / sqrt(sum x^2 + eps)``."""
    x = x.float()
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + NORM_EPS)


def short_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SiLU of the depthwise causal convolution of x [B, S, C] with weight
    [C, 1, K] (no bias), in float32: ``y_t = sum_i w[K - 1 - i] x_{t -
    i}``."""
    s, k = x.shape[1], weight.shape[-1]
    y = F.conv1d(x.float().transpose(1, 2), weight.float(), padding=k - 1,
                 groups=weight.shape[0])[..., :s]
    return F.silu(y).transpose(1, 2)


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The gated delta rule as a token loop in float32: q, k, v, g [B, S,
    H, d] (q and k before their norms), beta [B, S, H] → o [B, S, H, d]."""
    b, s, h, d = q.shape
    qf = l2_normalize(q) * d ** -0.5
    kf = l2_normalize(k)
    vf, alpha, bf = v.float(), g.float().exp(), beta.float()
    state = torch.zeros(b, h, d, d, dtype=torch.float32, device=q.device)
    out = torch.empty(b, s, h, d, dtype=torch.float32, device=q.device)
    for t in range(s):
        kt = kf[:, t]
        state = state * alpha[:, t, :, :, None]
        u = torch.einsum("bhkv,bhk->bhv", state, kt)
        state = state + torch.einsum("bhk,bhv->bhkv", kt,
                                     bf[:, t, :, None] * (vf[:, t] - u))
        out[:, t] = torch.einsum("bhkv,bhk->bhv", state, qf[:, t])
    return out


def delta_attention_plain(q, k, v, f, beta, gate, mask, q_conv, k_conv,
                          v_conv, a_log, dt_bias, o_norm,
                          eps: float) -> torch.Tensor:
    """The plain steps (module docstring) → [B, S, n d] in q's dtype."""
    b, s, w = q.shape
    n = a_log.numel()
    d = w // n
    keep = mask.to(torch.float32)[:, :, None]
    qc, kc, vc = (short_conv(x.float() * keep, cw).view(b, s, n, d)
                  for x, cw in ((q, q_conv), (k, k_conv), (v, v_conv)))
    g = -a_log.float().exp().view(n, 1) * F.softplus(
        f.float().view(b, s, n, d) + dt_bias.float().view(n, d))
    o = recurrence(qc, kc, vc, g, beta)
    o = (o * torch.rsqrt(o.square().mean(-1, keepdim=True) + eps)
         * o_norm.float() * torch.sigmoid(gate.float().view(b, s, n, d)))
    return o.to(q.dtype).reshape(b, s, w)


def delta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    f: torch.Tensor, beta: torch.Tensor, gate: torch.Tensor,
                    mask: torch.Tensor, q_conv: torch.Tensor,
                    k_conv: torch.Tensor, v_conv: torch.Tensor,
                    a_log: torch.Tensor, dt_bias: torch.Tensor,
                    o_norm: torch.Tensor, eps: float) -> torch.Tensor:
    """q, k, v, f, gate [B, S, n d] (bf16 on the card); beta [B, S, n]
    float32; mask [B, S] (0 at pads); the convolutions [n d, 1, K]; a_log
    [n] (any shape of n entries) and dt_bias [n d] float32; o_norm [d] →
    the layer's mixing before its output projection, [B, S, n d] in q's
    dtype."""
    if q.device.type == "cpu":
        return delta_attention_plain(q, k, v, f, beta, gate, mask, q_conv,
                                     k_conv, v_conv, a_log, dt_bias, o_norm,
                                     eps)
    if q.device.type != "cuda":
        raise ValueError(f"no kda for device {q.device}")
    b, s, w = q.shape
    n = a_log.numel()
    dev = q.device
    if w != n * HEAD_DIM:
        raise ValueError(f"the kda kernel takes heads of {HEAD_DIM}, got "
                         f"{w // n}")
    for name, t in (("q", q), ("k", k), ("v", v), ("f", f), ("gate", gate)):
        cuda_lib.check_cuda(name, t, torch.bfloat16, dev)
        if t.shape != q.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
    for name, t in (("q_conv", q_conv), ("k_conv", k_conv),
                    ("v_conv", v_conv)):
        cuda_lib.check_cuda(name, t, torch.bfloat16, dev)
        if t.shape != (w, 1, CONV_WIDTH):
            raise ValueError(f"{name} is {tuple(t.shape)}, the kernel takes "
                             f"({w}, 1, {CONV_WIDTH})")
    mask = mask.to(torch.int32).contiguous()
    for name, t, dtype, shape in (
            ("beta", beta, torch.float32, (b, s, n)),
            ("mask", mask, torch.int32, (b, s)),
            ("a_log", a_log, torch.float32, a_log.shape),
            ("dt_bias", dt_bias, torch.float32, (w,)),
            ("o_norm", o_norm, torch.bfloat16, (HEAD_DIM,))):
        cuda_lib.check_cuda(name, t, dtype, dev)
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")
    out = torch.empty_like(q)
    if out.numel():
        cuda_lib.launch("kda", "srt_kda", dev, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), f.data_ptr(), gate.data_ptr(),
                        q_conv.data_ptr(), k_conv.data_ptr(),
                        v_conv.data_ptr(), o_norm.data_ptr(),
                        beta.data_ptr(), a_log.data_ptr(),
                        dt_bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
                        b, s, n, HEAD_DIM, eps)
    return out
