"""The plain reference of Kimi-Linear as a sparse encoder: Kimi Delta
Attention (KDA) layers beside bidirectional latent attention without
position encoding, a dense SwiGLU first, then a sigmoid-routed mixture of
experts beside one shared expert, and the SPLADE head, in float32 with
TF32 off.

It follows HF's ``modeling_kimi.py`` for Kimi-Linear (Moonshot AI's Kimi
Linear report, arXiv:2510.26692):

* KDA (``kda_layers``, counted from 1), n heads of d: ``q, k, v = x W^T``,
  each through a depthwise causal convolution of width 4 (no bias, the
  window the position and the 3 before it) and SiLU; ``g = -exp(A_log)
  softplus(x W_fa^T W_fb^T + dt_bias)`` per channel, ``beta = sigmoid(x
  W_b^T)`` per head; q and k L2-normalised per head (eps 1e-6), q times
  d**-0.5; per head a state S [d, d], zero before the first position:
  ``S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t
  v_t^T``, ``o_t = S_t^T q_t``, a loop over the positions; then
  ``RMSNorm_d(o) w_o * sigmoid(x W_ga^T W_gb^T + b_gb)`` (eps
  ``rms_norm_eps``) and ``W_o``. Causal, as published.
* MLA (``full_attn_layers``), no query compression and no rope
  (``mla_use_nope``): ``q = x W_q^T`` per head [dn + dr]; ``x W_kva^T``
  split into the latent c and one key part k_pe all heads share;
  ``RMSNorm(c) W_kvb^T`` (eps 1e-6) per head into k_nope and v; scores
  ``[q_nope, q_pe] . [k_nope, k_pe]`` times ``(dn + dr)**-0.5``, softmax
  over the text's keys (no causal mask), ``P v`` through ``W_o``.
* The FFN: ``W_d (silu(W_g x) * W_u x)`` in the first
  ``first_k_dense_replace`` layers; then the router: ``s = sigmoid(x
  W_r^T)`` over all the router's experts, the top-k of ``s +
  e_score_correction_bias``, their ``s`` renormalised (``moe_renormalize``)
  and times ``routed_scaling_factor``; the experts this card holds each a
  SwiGLU of width ``moe_intermediate_size``, run as a plain loop over the
  tokens routed to it, weighted and summed; plus the shared expert.

The held share (the configuration's ``expert_share``: ``num_experts``
held from ``first_held`` of the router's ``router_experts``): what the
absent experts would add is left out, as in the program; the router keeps
its published width and its top-k.

Departures, none of which changes the result: each text runs at positions
0..n-1 with its pads after it (masked keys and masked from the max; KDA is
causal, so trailing pads reach no real position); a token's routed
experts are summed in expert order, not in its top-k order (float32
addition order).

The weights are the benchmark's: each layer's from its own ``gen.draw``
stream in the order ``layer_shapes`` lists, drawn again here layer by layer
from the same bits as the served bf16 and taken in float32, with every
expert of the router drawn and the held ones kept, so every share of a
layer draws the same weights. Given the draw: the routing draw of
``reference/deepseek_v2.py`` (``ROUTE_SHARE``, ``ROUTER_SCALE``: the router
reads only residual dims that no layer writes, so it routes by token id),
but the experts' down projections as drawn (the renormalised sigmoid
weights, 2.446 a token, already give the held experts ~0.6 of a token's
weight against the shared expert's 1; four times that let bf16's routing
flips, ~2% of a layer's tokens, move the reps as far as fp8 does); each
convolution ``CONV_SCALE`` times the draw
(a std of 0.32, PyTorch's default range for a width-4 kernel); ``A_log =
log(1 + 15 u)`` and ``dt_bias`` the inverse softplus of ``exp(log(1e-3) +
u log(100))``, u the draw's normal quantile (the ranges fla's KDA
initialises from); ``e_score_correction_bias`` as drawn (std 0.02, about
the gap between a token's 8th and 9th scores). These
three are float32, as the published model keeps them. ``precision="fp8"``
is the control, as ``reference/decoder.py`` defines it: every projection's
input and weight (each expert's apart) rounded to float8 e4m3 at a
per-tensor scale; the router, the gates and the recurrence stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from retrieval_bench import gen
from retrieval_bench.reference.decoder import exact_f32, linear, rms_norm
from retrieval_bench.reference import deepseek_v2
from retrieval_bench.reference.deepseek_v2 import ROUTE_SHARE, ROUTER_SCALE

KV_NORM_EPS = 1e-6
QK_NORM_EPS = 1e-6
CONV_SCALE = 16       # a convolution's weights, times the draw


def router_experts(m: dict) -> int:
    share = m.get("expert_share")
    return share["router_experts"] if share else m["num_experts"]


def held(m: dict) -> tuple:
    """(first, count) of the experts this card holds."""
    share = m.get("expert_share")
    return (share["first_held"] if share else 0), m["num_experts"]


def is_kda_layer(m: dict, i: int) -> bool:
    return i + 1 in m["linear_attn_config"]["kda_layers"]


def is_moe_layer(m: dict, i: int) -> bool:
    return deepseek_v2.is_moe_layer({"n_routed_experts": m["num_experts"],
                         "first_k_dense_replace": m["first_k_dense_replace"],
                         "moe_layer_freq": m["moe_layer_freq"]}, i)


def layer_shapes(m: dict, i: int) -> list:
    """(name, shape, kind) of layer i's tensors in draw order; matrices
    [out, in]. The experts: ``w_gu`` [E, 2I, H] (each expert's gate rows,
    then its up rows) and ``w_d`` [E, H, I], E the router's experts."""
    h = m["hidden_size"]
    if is_kda_layer(m, i):
        la = m["linear_attn_config"]
        n, d, k = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
        w = n * d
        out = [("wq", (w, h), "mat"), ("wk", (w, h), "mat"),
               ("wv", (w, h), "mat"), ("q_conv", (w, 1, k), "mat"),
               ("k_conv", (w, 1, k), "mat"), ("v_conv", (w, 1, k), "mat"),
               ("A_log", (1, 1, n, 1), "mat"), ("wfa", (d, h), "mat"),
               ("wfb", (w, d), "mat"), ("dt_bias", (w,), "mat"),
               ("wb", (n, h), "mat"), ("wga", (d, h), "mat"),
               ("wgb", (w, d), "mat"), ("bgb", (w,), "mat"),
               ("o_norm", (d,), "norm"), ("wo", (h, w), "mat")]
    else:
        n = m["num_attention_heads"]
        dn, dr = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
        dv, r = m["v_head_dim"], m["kv_lora_rank"]
        out = [("wq", (n * (dn + dr), h), "mat"),
               ("wkv_a", (r + dr, h), "mat"), ("kv_norm", (r,), "norm"),
               ("wkv_b", (n * (dn + dv), r), "mat"),
               ("wo", (h, n * dv), "mat")]
    out += [("input_norm", (h,), "norm"), ("post_attn_norm", (h,), "norm")]
    if not is_moe_layer(m, i):
        f = m["intermediate_size"]
        return out + [("wg", (f, h), "mat"), ("wu", (f, h), "mat"),
                      ("wd", (h, f), "mat")]
    e, f = router_experts(m), m["moe_intermediate_size"]
    s = f * m["num_shared_experts"]
    return out + [("router", (e, h), "mat"), ("bias", (e,), "mat"),
                  ("w_gu", (e, 2 * f, h), "mat"), ("w_d", (e, h, f), "mat"),
                  ("sg", (s, h), "mat"), ("su", (s, h), "mat"),
                  ("sd", (h, s), "mat")]


def layer_weights(m: dict, seed: int, i: int, device,
                  dtype=torch.bfloat16) -> dict:
    """Layer i's tensors (the held experts only) from stream i, in
    ``dtype`` but ``A_log``, ``dt_bias`` and the correction ``bias`` in
    float32, with the draws of the module's docstring."""
    w = gen.draw(layer_shapes(m, i), seed, i, device, dtype)
    s = m["hidden_size"] // ROUTE_SHARE
    for name in ("wo", "wd", "sd"):
        if name in w:
            w[name][:s] = 0
    if "w_d" in w:
        first, count = held(m)
        w["w_gu"] = w["w_gu"][first:first + count].clone()
        w["w_d"] = w["w_d"][first:first + count].clone()
        w["w_d"][:, :s] = 0
        w["router"][:, s:] = 0
        w["router"] *= ROUTER_SCALE
        w["bias"] = w["bias"].float()
    if "A_log" in w:
        for name in ("q_conv", "k_conv", "v_conv"):
            w[name] *= CONV_SCALE
        u = torch.special.ndtr(w["A_log"].float() / gen.WEIGHT_STD)
        w["A_log"] = torch.log1p(15.0 * u)
        u = torch.special.ndtr(w["dt_bias"].float() / gen.WEIGHT_STD)
        dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
        w["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    return w


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of x [B, S, C] with w [C,
    1, K]: y_t = sum_i w[:, 0, K - 1 - i] x_{t - i}."""
    k = w.shape[-1]
    y = torch.zeros_like(x)
    for i in range(k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        y = y + shifted * w[:, 0, k - 1 - i]
    return F.silu(y)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.square().sum(-1, keepdim=True) + QK_NORM_EPS)


def delta_rule(q, k, v, g, beta) -> torch.Tensor:
    """q, k, v, g [B, S, n, d], beta [B, S, n] → o [B, S, n, d]: the gated
    delta rule, one position at a time."""
    b, s, n, d = q.shape
    q = l2norm(q) * d ** -0.5
    k = l2norm(k)
    state = q.new_zeros(b, n, d, d)
    out = []
    for t in range(s):
        kt, bt = k[:, t, :, :, None], beta[:, t, :, None, None]
        decayed = g[:, t].exp()[..., None] * state
        # (I - b k k^T) D S = D S - b k (k^T D S): no [d, d] product
        read = (kt * decayed).sum(-2, keepdim=True)
        state = decayed + bt * kt * (v[:, t, :, None, :] - read)
        out.append((state * q[:, t, :, :, None]).sum(-2))
    return torch.stack(out, 1)


def kda(m: dict, w: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    la = m["linear_attn_config"]
    n, d = la["num_heads"], la["head_dim"]
    b, s, _ = x.shape
    q, k, v = (short_conv(linear(x, w[p], precision), w[c]).view(b, s, n, d)
               for p, c in (("wq", "q_conv"), ("wk", "k_conv"),
                            ("wv", "v_conv")))
    f = linear(linear(x, w["wfa"], precision), w["wfb"], precision)
    g = -w["A_log"].exp() * F.softplus(f.view(b, s, n, d)
                                       + w["dt_bias"].view(n, d))
    beta = torch.sigmoid(linear(x, w["wb"], precision))
    o = delta_rule(q, k, v, g, beta)
    gate = (linear(linear(x, w["wga"], precision), w["wgb"], precision)
            + w["bgb"]).view(b, s, n, d)
    o = rms_norm(o, w["o_norm"], m["rms_norm_eps"]) * torch.sigmoid(gate)
    return linear(o.reshape(b, s, n * d), w["wo"], precision)


def attention(m: dict, w: dict, x: torch.Tensor, keep: torch.Tensor,
              precision: str) -> torch.Tensor:
    b, s, _ = x.shape
    n = m["num_attention_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    q = linear(x, w["wq"], precision).view(b, s, n, dn + dr)
    ckv = linear(x, w["wkv_a"], precision)
    c, k_pe = ckv[..., :m["kv_lora_rank"]], ckv[..., m["kv_lora_rank"]:]
    kv = linear(rms_norm(c, w["kv_norm"], KV_NORM_EPS), w["wkv_b"],
                precision).view(b, s, n, dn + dv)
    kf = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(b, s, n, dr)], -1)
    att = torch.einsum("bqnd,bknd->bnqk", q, kf) * (dn + dr) ** -0.5
    att = att.masked_fill(~keep[:, None, None, :], float("-inf"))
    out = torch.einsum("bnqk,bknd->bqnd", att.softmax(-1), kv[..., dn:])
    return linear(out.reshape(b, s, n * dv), w["wo"], precision)


def swiglu(x, wg, wu, wd, precision: str) -> torch.Tensor:
    return linear(F.silu(linear(x, wg, precision)) * linear(x, wu, precision),
                  wd, precision)


def route(m: dict, w: dict, x: torch.Tensor) -> tuple:
    """x [T, H] → (weights [T, k], expert ids [T, k]) over the router's
    experts, float32."""
    scores = torch.sigmoid(x @ w["router"].T)
    ids = torch.topk(scores + w["bias"], m["num_experts_per_token"],
                     dim=-1).indices
    wt = scores.gather(-1, ids)
    if m.get("moe_renormalize", False):
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    return wt * m["routed_scaling_factor"], ids


def experts(m: dict, w: dict, x: torch.Tensor, precision: str,
            routes=None, shared: bool = True) -> torch.Tensor:
    """The MoE FFN of x [B, S, H] over the held experts, plus the shared
    expert unless ``shared`` is False; ``routes``, a list, gets the expert
    ids [B, S, k]."""
    xt = x.reshape(-1, x.shape[-1])
    wt, ids = route(m, w, xt)
    if routes is not None:
        routes.append(ids.view(*x.shape[:2], -1))
    f = m["moe_intermediate_size"]
    out = (swiglu(xt, w["sg"], w["su"], w["sd"], precision) if shared
           else torch.zeros_like(xt))
    first, count = held(m)
    for e in range(count):
        tok, j = torch.nonzero(ids == first + e, as_tuple=True)
        if len(tok) == 0:
            continue
        gu = w["w_gu"][e]
        y = swiglu(xt[tok], gu[:f], gu[f:], w["w_d"][e], precision)
        out = out.index_add(0, tok, y * wt[tok, j][:, None])
    return out.view(x.shape)


def layer(m: dict, i: int, w: dict, x: torch.Tensor, keep: torch.Tensor,
          precision: str, routes=None) -> torch.Tensor:
    eps = m["rms_norm_eps"]
    h = rms_norm(x, w["input_norm"], eps)
    x = x + (kda(m, w, h, precision) if is_kda_layer(m, i)
             else attention(m, w, h, keep, precision))
    h = rms_norm(x, w["post_attn_norm"], eps)
    if is_moe_layer(m, i):
        return x + experts(m, w, h, precision, routes)
    return x + swiglu(h, w["wg"], w["wu"], w["wd"], precision)


def sparse_reps(m: dict, seed: int, token_lists: list, device,
                precision: str = "f32", rows: int = 32,
                routes=None) -> torch.Tensor:
    """[n, vocab] float32 reps of the texts' token lists, ``rows`` texts
    at a time through all layers; ``routes``, a list, gets each MoE
    layer's expert ids of each chunk in order."""
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
                     layer_weights(m, seed, li, device).items()}
                x = layer(m, li, w, x, keep, precision, routes)
                del w
            x = rms_norm(x, final, m["rms_norm_eps"])
            logits = linear(x, head, precision)
            logits = logits * float(m["hidden_size"]) ** -0.25
            logits = logits.masked_fill(~keep[:, :, None], float("-inf"))
            out.append(torch.log1p(torch.relu(logits.amax(dim=1))))
    return torch.cat(out)
