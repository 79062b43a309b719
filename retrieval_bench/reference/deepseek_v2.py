"""The plain reference of DeepSeek-V2 as a sparse encoder: bidirectional
latent attention (MLA), a dense SwiGLU in the first layers and a mixture
of routed and shared experts in the rest, and the SPLADE head, in float32
with TF32 off.

It follows HF's ``modeling_deepseek.py`` for DeepSeek-V2 (no query
compression, softmax router, greedy top-k):

* MLA: ``q = x W_q^T`` split per head into q_nope (dn) and q_pe (dr);
  ``x W_kva^T`` split into the latent c (r) and one rope key k_pe that
  all heads share; ``RMSNorm(c) W_kvb^T`` (eps 1e-6) split per head into
  k_nope (dn) and v (dv). Rope on q_pe and k_pe: the last dimension
  de-interleaved (``view(d/2, 2).transpose``), then rotate-half, with
  yarn's frequencies and its cos/sin factor mscale(factor, mscale) /
  mscale(factor, mscale_all_dim). K and V are expanded per head (naive
  MLA): scores ``[q_nope, q_pe] . [k_nope, k_pe]`` times ``(dn + dr)**-0.5
  * mscale(factor, mscale_all_dim)**2``, softmax over the text's keys,
  ``P v`` through ``W_o``.
* The FFN: ``W_d (silu(W_g x) * W_u x)`` in the first
  ``first_k_dense_replace`` layers; then a router (``x W_r^T`` over the
  experts, softmax, top-k, weights not renormalised and times
  ``routed_scaling_factor``), each routed expert a SwiGLU of width
  ``moe_intermediate_size`` run as a plain loop over the tokens routed to
  it, weighted and summed, plus the shared experts, one SwiGLU of width
  ``n_shared_experts * moe_intermediate_size``.

Departures, none of which changes the result: each text runs at positions
0..n-1 with no padding token (pads are masked keys and masked from the
max, and rope sees only relative positions, so left padding changes
nothing); a token's routed experts are summed in expert order, not in its
top-k order (float32 addition order). ``norm_topk_prob``, other scoring
functions and group-limited top-k are not implemented (the configuration
sets none of them).

The weights are the benchmark's: each layer's from its own ``gen.draw``
stream in the order ``layer_shapes`` lists, drawn again here layer by layer
in float32 from the same bits as the served bf16, then given the routing
draw (``layer_weights``): the router reads only the first ``hidden_size //
ROUTE_SHARE`` dims of the residual stream, which no layer writes (those
rows of every output projection are 0), so they hold the token's
embedding and routing goes by token identity, as trained MoE routers
largely route; the router is ``ROUTER_SCALE`` times the draw there (at
DeepSeek-V2-Lite's widths a logit std of ~0.8 at the first MoE layer to
~0.3 at the last), and each routed expert's down projection
``EXPERT_SCALE`` times it. A router drawn over the whole random residual
stream puts the k-th and next scores within bf16's error on ~15% of
(token, layer) pairs, which hides a dropped expert among sound runs; this
draw leaves ~1.4%, and a dropped expert moves the reps ~3x as far as bf16
does (a sharper router, or larger experts, lets bf16 move the routing
weights and the reps further). The scalings are powers of 2, exact in
bf16. ``precision="fp8"`` is
the control, as ``reference/decoder.py`` defines it: every projection's
input and weight (each expert's apart) rounded to float8 e4m3 at a
per-tensor scale; the router stays float32, as a serving path keeps it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from retrieval_bench import gen
from retrieval_bench.reference.decoder import exact_f32, linear, rms_norm

KV_NORM_EPS = 1e-6
ROUTE_SHARE = 32      # the router reads hidden_size // ROUTE_SHARE dims
ROUTER_SCALE = 256    # times the draw, on those dims
EXPERT_SCALE = 4      # a routed expert's down projection, times the draw


def is_moe_layer(m: dict, i: int) -> bool:
    return (bool(m.get("n_routed_experts"))
            and i >= m.get("first_k_dense_replace", 0)
            and i % m.get("moe_layer_freq", 1) == 0)


def layer_shapes(m: dict, i: int) -> list:
    """(name, shape, kind) of layer i's tensors in draw order; matrices
    [out, in]. The stacked experts: ``w_gu`` [E, 2I, H] (each expert's
    gate rows, then its up rows) and ``w_d`` [E, H, I]."""
    h, n = m["hidden_size"], m["num_attention_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    r = m["kv_lora_rank"]
    out = [("wq", (n * (dn + dr), h), "mat"), ("wkv_a", (r + dr, h), "mat"),
           ("kv_norm", (r,), "norm"), ("wkv_b", (n * (dn + dv), r), "mat"),
           ("wo", (h, n * dv), "mat"), ("input_norm", (h,), "norm"),
           ("post_attn_norm", (h,), "norm")]
    if not is_moe_layer(m, i):
        f = m["intermediate_size"]
        return out + [("wg", (f, h), "mat"), ("wu", (f, h), "mat"),
                      ("wd", (h, f), "mat")]
    e, f = m["n_routed_experts"], m["moe_intermediate_size"]
    s = f * m["n_shared_experts"]
    return out + [("router", (e, h), "mat"), ("w_gu", (e, 2 * f, h), "mat"),
                  ("w_d", (e, h, f), "mat"), ("sg", (s, h), "mat"),
                  ("su", (s, h), "mat"), ("sd", (h, s), "mat")]


def layer_weights(m: dict, seed: int, i: int, device,
                  dtype=torch.bfloat16) -> dict:
    """Layer i's tensors in ``dtype``, from stream i, with the routing
    draw (module docstring): no output projection writes the first
    ``hidden_size // ROUTE_SHARE`` dims, the router reads only those, at
    ``ROUTER_SCALE`` times the draw, and the routed experts' down
    projections are ``EXPERT_SCALE`` times it."""
    w = gen.draw(layer_shapes(m, i), seed, i, device, dtype)
    s = m["hidden_size"] // ROUTE_SHARE
    for name in ("wo", "wd", "sd"):
        if name in w:
            w[name][:s] = 0
    if "w_d" in w:
        w["w_d"][:, :s] = 0
        w["w_d"] *= EXPERT_SCALE
    if "router" in w:
        w["router"][:, s:] = 0
        w["router"] *= ROUTER_SCALE
    return w


def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_tables(m: dict, s: int, device) -> tuple:
    """[s, dr] cos and sin at positions 0..s-1 (HF's
    ``DeepseekV2YarnRotaryEmbedding`` for a yarn config)."""
    d, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    expo = torch.arange(0, d, 2, dtype=torch.float32) / d
    inv = 1.0 / base ** expo
    rs = m.get("rope_scaling") or {}
    factor = 1.0
    if rs.get("type", rs.get("rope_type")) == "yarn":
        factor = rs["factor"]
        old = rs["original_max_position_embeddings"]

        def corr(rot):
            return d * math.log(old / (rot * 2 * math.pi)) / (2 * math.log(base))

        lo = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
        hi = min(math.ceil(corr(rs.get("beta_slow", 1))), d - 1)
        hi = hi + 0.001 if lo == hi else hi
        ramp = ((torch.arange(d // 2, dtype=torch.float32) - lo)
                / (hi - lo)).clamp(0, 1)
        keep = 1.0 - ramp
        inv = 1.0 / (factor * base ** expo) * (1 - keep) + inv * keep
        factor = (_mscale(factor, rs.get("mscale", 1))
                  / _mscale(factor, rs.get("mscale_all_dim", 0)))
    f = torch.arange(s, dtype=torch.float32)[:, None] * inv
    emb = torch.cat([f, f], -1)
    return (emb.cos() * factor).to(device), (emb.sin() * factor).to(device)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, N, d]: de-interleave the last dimension, then
    rotate-half."""
    b, s, n, d = x.shape
    x = x.view(b, s, n, d // 2, 2).transpose(4, 3).reshape(b, s, n, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def softmax_scale(m: dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    rs = m.get("rope_scaling") or {}
    if rs.get("mscale_all_dim"):
        k = _mscale(rs["factor"], rs["mscale_all_dim"])
        scale *= k * k
    return scale


def attention(m: dict, w: dict, x: torch.Tensor, keep: torch.Tensor,
              cos, sin, precision: str) -> torch.Tensor:
    b, s, _ = x.shape
    n = m["num_attention_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    q = linear(x, w["wq"], precision).view(b, s, n, dn + dr)
    ckv = linear(x, w["wkv_a"], precision)
    c, k_pe = ckv[..., :m["kv_lora_rank"]], ckv[..., m["kv_lora_rank"]:]
    kv = linear(rms_norm(c, w["kv_norm"], KV_NORM_EPS), w["wkv_b"],
                precision).view(b, s, n, dn + dv)
    q_pe = rope(q[..., dn:], cos, sin)
    k_pe = rope(k_pe.view(b, s, 1, dr), cos, sin).expand(b, s, n, dr)
    qf = torch.cat([q[..., :dn], q_pe], -1)
    kf = torch.cat([kv[..., :dn], k_pe], -1)
    att = torch.einsum("bqnd,bknd->bnqk", qf, kf) * softmax_scale(m)
    att = att.masked_fill(~keep[:, None, None, :], float("-inf"))
    out = torch.einsum("bnqk,bknd->bqnd", att.softmax(-1), kv[..., dn:])
    return linear(out.reshape(b, s, n * dv), w["wo"], precision)


def swiglu(x, wg, wu, wd, precision: str) -> torch.Tensor:
    return linear(F.silu(linear(x, wg, precision)) * linear(x, wu, precision),
                  wd, precision)


def route(m: dict, w: dict, x: torch.Tensor) -> tuple:
    """x [T, H] → (weights [T, k], expert ids [T, k]), float32."""
    scores = (x @ w["router"].T).softmax(-1)
    wt, ids = torch.topk(scores, m["num_experts_per_tok"], dim=-1)
    return wt * m.get("routed_scaling_factor", 1.0), ids


def experts(m: dict, w: dict, x: torch.Tensor, precision: str,
            routes=None) -> torch.Tensor:
    """The MoE FFN of x [B, S, H]; ``routes``, a list, gets the expert ids
    [B, S, k]."""
    xt = x.reshape(-1, x.shape[-1])
    wt, ids = route(m, w, xt)
    if routes is not None:
        routes.append(ids.view(*x.shape[:2], -1))
    f = m["moe_intermediate_size"]
    out = swiglu(xt, w["sg"], w["su"], w["sd"], precision)
    for e in range(m["n_routed_experts"]):
        tok, j = torch.nonzero(ids == e, as_tuple=True)
        if len(tok) == 0:
            continue
        gu = w["w_gu"][e]
        y = swiglu(xt[tok], gu[:f], gu[f:], w["w_d"][e], precision)
        out = out.index_add(0, tok, y * wt[tok, j][:, None])
    return out.view(x.shape)


def layer(m: dict, i: int, w: dict, x: torch.Tensor, keep: torch.Tensor,
          cos, sin, precision: str, routes=None) -> torch.Tensor:
    eps = m["rms_norm_eps"]
    x = x + attention(m, w, rms_norm(x, w["input_norm"], eps), keep, cos,
                      sin, precision)
    h = rms_norm(x, w["post_attn_norm"], eps)
    if is_moe_layer(m, i):
        return x + experts(m, w, h, precision, routes)
    return x + swiglu(h, w["wg"], w["wu"], w["wd"], precision)


def sparse_reps(m: dict, seed: int, token_lists: list, device,
                precision: str = "f32", rows: int = 64,
                routes=None) -> torch.Tensor:
    """[n, vocab] float32 reps of the texts' token lists, ``rows`` texts
    at a time through all layers; ``routes``, a list, gets each MoE
    layer's expert ids of each chunk in order ((chunk, layer) pairs of
    [rows, S, k])."""
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
            cos, sin = rope_tables(m, s, device)
            x = table[ids]
            for li in range(m["num_hidden_layers"]):
                w = {k: v.float() for k, v in
                     layer_weights(m, seed, li, device).items()}
                x = layer(m, li, w, x, keep, cos, sin, precision, routes)
                del w
            x = rms_norm(x, final, m["rms_norm_eps"])
            logits = linear(x, head, precision)
            logits = logits * float(m["hidden_size"]) ** -0.25
            logits = logits.masked_fill(~keep[:, :, None], float("-inf"))
            out.append(torch.log1p(torch.relu(logits.amax(dim=1))))
    return torch.cat(out)
