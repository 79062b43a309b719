"""The benchmark's generators, frozen: everything a run feeds the program
and the reference is made here from ``--seed`` and the cell's files.

* Weights: one ``torch.Generator`` stream per layer (and one each for the
  embeddings and the LM head), seeded by ``mix(seed, stream)``, drawn on
  the device in one ``randn`` call per stream and cast to the served
  dtype. The reference draws any layer again by itself, in float32 from
  the same bits.
* The uniform index (a frozen copy of the port's ``benches/corpora.py``
  ``uniform_rows`` and ``uniform_valbits``, bench.py's index): posting i of
  the term-major CSR is doc hash(i) mod n_docs, every value 1.0, each term
  holding n_docs * k // vocab postings.
* Texts of words ``w<id>`` and the stand-in tokenizer (a frozen copy of
  the non-HF mode of ``benches/common.py`` ``StandInTokenizer``): one
  token a word, left padding to the smallest length rung.
* Open-loop schedules and query streams: every seed gets the same set of
  sizes and gaps (quantiles of the mix's distributions), in its own order,
  so a seed changes which words and terms are drawn, never the amount of
  work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M64 = (1 << 64) - 1
PAD = 2048            # sentinel postings past the last list (>= one job)
STEP = 1 << 27        # postings per index generation step
WEIGHT_STD = 0.02     # the family's initializer_range
NORM_STD = 0.05       # norm weights 1 + NORM_STD * N(0, 1)

EMBED_STREAM = 1 << 20
HEAD_STREAM = (1 << 20) + 1


def mix(seed: int, stream: int) -> int:
    """A 63-bit generator seed from (seed, stream) by splitmix64."""
    z = (int(seed) ^ ((int(stream) + 1) * 0x9E3779B97F4A7C15)) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(mix(seed, stream))


# ---- weights ----------------------------------------------------------------


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"]


def layer_shapes(m: dict) -> list:
    """(name, shape, kind) of one decoder layer in draw order; matrices
    [out, in] (``y = x @ w.T``)."""
    h, i = m["hidden_size"], m["intermediate_size"]
    q = m["num_attention_heads"] * head_dim(m)
    kv = m["num_key_value_heads"] * head_dim(m)
    out = [("wq", (q, h), "mat"), ("wk", (kv, h), "mat"),
           ("wv", (kv, h), "mat"), ("wo", (h, q), "mat"),
           ("wg", (i, h), "mat"), ("wu", (i, h), "mat"),
           ("wd", (h, i), "mat"),
           ("input_norm", (h,), "norm"), ("post_attn_norm", (h,), "norm")]
    if qkv_bias(m):
        out += [("bq", (q,), "mat"), ("bk", (kv,), "mat"),
                ("bv", (kv,), "mat")]
    return out


def qkv_bias(m: dict) -> bool:
    return m.get("model_type") == "qwen2" or bool(m.get("attention_bias"))


def draw(shapes, seed: int, stream: int, device, dtype) -> dict:
    """{name: tensor in ``dtype``} of (name, shape, kind) ``shapes``, in
    order from one float32 ``randn`` of stream ``stream``: a "mat" scaled
    by ``WEIGHT_STD``, a "norm" 1 + ``NORM_STD`` times it."""
    n = sum(math.prod(s) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(mix(seed, stream))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in shapes:
        x = flat[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        x = 1.0 + NORM_STD * x if kind == "norm" else x * WEIGHT_STD
        out[name] = x.to(dtype)
    return out


def layer_weights(m: dict, seed: int, layer: int, device,
                  dtype=torch.bfloat16) -> dict:
    """Layer ``layer``'s tensors, in ``dtype``."""
    return draw(layer_shapes(m), seed, layer, device, dtype)


def embed_weights(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The embeddings [vocab, hidden] and the final norm."""
    return draw([("embed", (m["vocab_size"], m["hidden_size"]), "mat"),
                 ("final_norm", (m["hidden_size"],), "norm")],
                seed, EMBED_STREAM, device, dtype)


def head_weight(m: dict, seed: int, device, dtype=torch.bfloat16):
    """The untied LM head [vocab, hidden]; None when tied."""
    if m.get("tie_word_embeddings", False):
        return None
    return draw([("head", (m["vocab_size"], m["hidden_size"]), "mat")],
                seed, HEAD_STREAM, device, dtype)["head"]


# ---- the uniform index ----------------------------------------------------


def per_term(ix: dict, vocab: int) -> int:
    return ix["n_docs"] * ix["postings_per_doc"] // vocab


def doc_of_posting(i: torch.Tensor, n_docs: int) -> torch.Tensor:
    """bench.py's hash of the flat posting index (int64) → doc row."""
    h = (i * 2654435761) & 0xFFFFFFFF
    h = (h ^ (h >> 13)) & 0xFFFFFF
    return h % n_docs


def index_rows(ix: dict, vocab: int, device):
    """The f32 layout's arrays: rows int32 [nnz + PAD] (the pad is the
    n_docs sentinel), value bits int32 [nnz + PAD] (1.0, 0 in the pad),
    host offsets [vocab + 1] int64, nnz."""
    n_docs = ix["n_docs"]
    pt = per_term(ix, vocab)
    nnz = pt * vocab
    rows = torch.full((nnz + PAD,), n_docs, dtype=torch.int32, device=device)
    for s in range(0, nnz, STEP):
        i = torch.arange(s, min(s + STEP, nnz), dtype=torch.int64,
                         device=device)
        rows[s:s + len(i)] = doc_of_posting(i, n_docs).to(torch.int32)
    one = int(np.float32(1.0).view(np.int32))
    bits = torch.full((nnz + PAD,), one, dtype=torch.int32, device=device)
    bits[nnz:] = 0
    offsets = np.arange(vocab + 1, dtype=np.int64) * pt
    return rows, bits, offsets, nnz


# ---- texts and the stand-in tokenizer --------------------------------------


class StandInTokenizer:
    """Texts of words ``w<id>`` → token id = id mod vocab, one a word,
    padded on the left to the smallest length rung that holds the batch:
    ``tok(texts, length=None) -> (ids, mask)`` int32, as the text frontend
    calls it; ``lengths`` are the rungs its warmup runs."""

    def __init__(self, vocab: int, lengths):
        self.vocab = vocab
        self.lengths = tuple(lengths)

    def tokens(self, text: str) -> list:
        return [int(w[1:]) % self.vocab for w in text.split()]

    def __call__(self, texts, length=None):
        toks = [self.tokens(t) for t in texts]
        if length is None:
            need = max(len(t) for t in toks)
            length = next(r for r in self.lengths if r >= need)
        ids = np.zeros((len(texts), length), np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, t in enumerate(toks):
            t = t[:length]
            if t:
                ids[i, length - len(t):] = t
                mask[i, length - len(t):] = 1
        return ids, mask


def fixed_counts(hist: dict, n: int) -> np.ndarray:
    """n sizes with the histogram's shares ({"size": weight}, as a mix's
    file gives it), by largest remainder: the same multiset for every
    seed."""
    sizes = np.array(sorted(int(k) for k in hist), np.int64)
    w = np.array([float(hist[str(k)]) for k in sizes])
    want = w / w.sum() * n
    cnt = np.floor(want).astype(np.int64)
    for j in np.argsort(-(want - cnt), kind="stable")[:n - cnt.sum()]:
        cnt[j] += 1
    return np.repeat(sizes, cnt)


def open_loop_schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds] of round(rate * seconds) Poisson arrivals:
    the exponential gaps' quantiles, in the seed's order, scaled to the
    window."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps[rng(seed, 1).permutation(n)]
    due = np.cumsum(gaps)
    return due * (seconds / due[-1])


def word_bank(vocab: int, size: int, seed: int) -> np.ndarray:
    """``size`` distinct word ids in [2, vocab)."""
    return rng(seed, 2).choice(np.arange(2, vocab), size=size, replace=False)


def texts(words_hist: dict, n: int, bank: np.ndarray, seed: int,
          stream: int = 3) -> list:
    """n distinct texts, word counts the histogram's fixed multiset in the
    seed's order, words drawn from the bank."""
    r = rng(seed, stream)
    counts = fixed_counts(words_hist, n)[rng(seed, stream + 1).permutation(n)]
    out, seen = [], set()
    for c in counts:
        while True:
            t = " ".join(f"w{w}" for w in r.choice(bank, size=int(c)))
            if t not in seen:
                break
        seen.add(t)
        out.append(t)
    return out


# ---- pre-encoded query streams ---------------------------------------------


def query_pool(vocab: int, n: int, terms: int, budget: int, lo: float,
               hi: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """n queries of ``terms`` distinct terms, weights U[lo, hi) f32, in a
    ``budget``-wide row (the slots past ``terms`` unused: term 0, weight
    0)."""
    r = rng(seed, 4)
    qt = np.zeros((n, budget), np.int32)
    qv = np.zeros((n, budget), np.float32)
    for j in range(n):
        qt[j, :terms] = r.choice(vocab, terms, replace=False)
    qv[:, :terms] = r.uniform(lo, hi, (n, terms)).astype(np.float32)
    return qt, qv


# ---- training: LoRA factors and batches -------------------------------------

LORA_STREAM = (1 << 20) + 2
BATCH_STREAM = 1 << 21
LORA_MODULES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                ("attn", "wo"), ("mlp", "wg"), ("mlp", "wu"), ("mlp", "wd"))


def lora_shapes(m: dict) -> dict:
    """(fan_in, fan_out) of each LoRA target, by its projection's name."""
    h, i = m["hidden_size"], m["intermediate_size"]
    q = m["num_attention_heads"] * head_dim(m)
    kv = m["num_key_value_heads"] * head_dim(m)
    return {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h),
            "wg": (h, i), "wu": (h, i), "wd": (i, h)}


def lora_factors(m: dict, r: int, seed: int, device) -> dict:
    """peft's initial factors for every projection of every layer, stacked
    over layers in float32: A [L, in, r] ~ U(+-1/sqrt(in)), B [L, r, out]
    zero, as {"layers": {group: {name: {"a", "b"}}}}."""
    g = torch.Generator(device=device).manual_seed(mix(seed, LORA_STREAM))
    n_l = m["num_hidden_layers"]
    out: dict = {"layers": {"attn": {}, "mlp": {}}}
    for group, name in LORA_MODULES:
        fan_in, fan_out = lora_shapes(m)[name]
        bound = 1.0 / math.sqrt(fan_in)
        a = torch.rand((n_l, fan_in, r), generator=g, device=device,
                       dtype=torch.float32) * (2 * bound) - bound
        out["layers"][group][name] = {
            "a": a, "b": torch.zeros((n_l, r, fan_out), device=device)}
    return out


def train_batch(vocab: int, seed: int, step: int, bz: int, n_negs: int,
                q_len: int, d_len: int, device) -> dict:
    """Step ``step``'s micro batch: bz queries of q_len tokens and bz * (1 +
    n_negs) contexts of d_len, ids uniform in [4, vocab), full masks;
    query i's positive is context i. Every step draws its own rows."""
    g = torch.Generator(device=device).manual_seed(mix(seed,
                                                       BATCH_STREAM + step))
    q = torch.randint(4, vocab, (bz, q_len), generator=g, device=device,
                      dtype=torch.int32)
    c = torch.randint(4, vocab, (bz * (1 + n_negs), d_len), generator=g,
                      device=device, dtype=torch.int32)
    return {"tokenized_queries": {"input_ids": q,
                                  "attention_mask": torch.ones_like(q)},
            "tokenized_contexts": {"input_ids": c,
                                   "attention_mask": torch.ones_like(c)},
            "target_labels": torch.arange(bz, device=device,
                                          dtype=torch.int32)}
