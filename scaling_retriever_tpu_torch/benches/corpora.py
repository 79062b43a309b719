"""The drivers' corpora, generated on the device from their parameters and
a seed (nothing is read from disk or downloaded).

* The uniform index of ``bench.py``: posting i of the flat CSR is doc
  hash(i) mod n_docs, every value 1.0, each of ``vocab`` terms holding
  n_docs * k // vocab postings; in the f32 (rows + value bits), bf16-pair
  and q8 ``(row24 << 8) | code8`` layouts.
* The power-law index of ``bench_zipf.py``: dyadic bands b of W0 * 2^b
  terms whose lists hold round(L0 * rho^b) postings, posting p of a list
  at in-list rank j is doc A * (p mod N) mod N with impact g(j) = (1 +
  j)^-gamma, so lists are impact-ordered by construction; its full and
  prefix CSR, the doc-major side (the inverse enumeration), the query
  streams, the calibration of their sampling exponent, and
  ``ZipfHostLane``, the host slow lane that regenerates posting lists from
  the same arithmetic. Integer arithmetic is int64 (the reference switches
  JAX to 64 bits around it); g(j) is a host table of the C library's
  single-precision ``powf``, the power the reference evaluates, so every
  array is bit-identical to the reference generator's on any device.
* The clustered corpus of ``bench_bmx.py`` (doc-reordered topic clusters
  with doc-sorted lists, values a regime base plus a period-256 jitter),
  its query tiles, its exactness test and its block-max index.
* The dense corpus: L2-normalized bf16 rows from a seeded generator, by
  chunks, on the device.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import itertools

import numpy as np
import torch

from scaling_retriever_tpu_torch.ops.fetch import ALIGN, CHUNK, CHUNK2

STEP = 1 << 27      # postings per generation step (int64 temporaries)


def _signed32(w: torch.Tensor) -> torch.Tensor:
    """int64 words < 2^32 → the int32 with the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


# ---- bench.py's uniform index --------------------------------------------


def uniform_rows(dev, n_docs: int, k_per_doc: int, vocab: int,
                 pad: int = CHUNK2):
    """Rows of the uniform index: int32 [nnz + pad], row i =
    hash(i) = ((i * 2654435761) ^ ((i * 2654435761) >> 13)) mod 2^24
    folded into [0, n_docs) (bench.py's hash, in int64 masked to 32 bits),
    the pad the n_docs sentinel. Returns (rows, host offsets [vocab + 1]
    int64, nnz)."""
    per_term = (n_docs * k_per_doc) // vocab
    nnz = per_term * vocab
    rows = torch.full((nnz + pad,), n_docs, dtype=torch.int32, device=dev)
    for s in range(0, nnz, STEP):
        i = torch.arange(s, min(s + STEP, nnz), dtype=torch.int64,
                         device=dev)
        h = (i * 2654435761) & 0xFFFFFFFF
        h = (h ^ (h >> 13)) & 0xFFFFFF
        rows[s:s + len(i)] = (h % n_docs).to(torch.int32)  # 2^24 < 2 n_docs
    offsets = np.arange(vocab + 1, dtype=np.int64) * per_term
    return rows, offsets, nnz


def uniform_valbits(nnz: int, n: int, dev) -> torch.Tensor:
    """f32 value bits [n]: 1.0 for the nnz postings, 0 in the pad."""
    one = int(np.float32(1.0).view(np.int32))
    bits = torch.full((n,), one, dtype=torch.int32, device=dev)
    bits[nnz:] = 0
    return bits


def uniform_pairs(nnz: int, n: int, dev) -> torch.Tensor:
    """bf16 value pairs [n // 2]: (1.0, 1.0) words, 0 past nnz (even)."""
    pair = int(np.array([0x3F80, 0x3F80], np.uint16).view(np.int32)[0])
    pairs = torch.full((n // 2,), pair, dtype=torch.int32, device=dev)
    pairs[nnz // 2:] = 0
    return pairs


def q8_words(rows: torch.Tensor, nnz: int, n_docs: int,
             out=None) -> torch.Tensor:
    """The q8 layout of uniform rows: (row << 8) | 255 (code 255 = 1.0 at
    scale 1/255, lossless here), the pad (n_docs << 8) with code 0.
    ``out=rows`` packs in place, as bench.py donates the rows buffer."""
    if out is None:
        out = torch.empty_like(rows)
    pad = n_docs << 8
    out[nnz:] = pad - (1 << 32) if pad >= 1 << 31 else pad
    for s in range(0, nnz, STEP):
        e = min(s + STEP, nnz)
        out[s:e] = _signed32((rows[s:e].long() << 8) | 255)
    return out


def q8_scales(vocab: int) -> np.ndarray:
    return np.full(vocab, np.float32(1.0) / np.float32(255.0), np.float32)


def gen_index(dev, n_docs: int, k_per_doc: int, vocab: int):
    """The uniform index in all three layouts at once, padded by CHUNK2 so
    the f32 and bf16 engines share the rows: (rows, valbits, bf16 pairs,
    packed q8, host offsets, host scales, nnz)."""
    rows, offsets, nnz = uniform_rows(dev, n_docs, k_per_doc, vocab)
    n = rows.shape[0]
    return (rows, uniform_valbits(nnz, n, dev), uniform_pairs(nnz, n, dev),
            q8_words(rows, nnz, n_docs), offsets, q8_scales(vocab), nnz)


# ---- bench_zipf.py's power-law index ------------------------------------


@dataclasses.dataclass(frozen=True)
class ZipfSpec:
    """bench_zipf.py's constants: MSMARCO's doc count, 13 dyadic bands
    from 16 terms of 4,000,000 postings at ratio 0.52 (~1.06B postings,
    list length ~ rank^-1.13), impacts (1 + j)^-0.6, a 4,096-deep impact
    prefix."""

    n_docs: int = 8_841_823
    w0: int = 16
    bands: int = 13
    l0: int = 4_000_000
    rho: float = 0.52
    gamma: float = 0.6
    prefix: int = 4096

    @property
    def a_mult(self) -> int:
        """The affine doc map's multiplier (coprime with n_docs)."""
        return 2_654_435_761 % self.n_docs


def band_tables(spec: ZipfSpec) -> dict:
    """Host-side tables of the bands (bench_zipf.build_band_tables)."""
    W = np.array([spec.w0 * 2 ** b for b in range(spec.bands)], np.int64)
    L = np.array([max(1, round(spec.l0 * spec.rho ** b))
                  for b in range(spec.bands)], np.int64)
    V = int(W.sum())
    term_start = np.concatenate([[0], np.cumsum(W)])
    post_start = np.concatenate([[0], np.cumsum(W * L)])
    pre_L = np.minimum(L, spec.prefix)
    pre_post_start = np.concatenate([[0], np.cumsum(W * pre_L)])
    lens = np.repeat(L, W)
    pre_lens = np.repeat(pre_L, W)
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    pre_offsets = np.zeros(V + 1, np.int64)
    np.cumsum(pre_lens, out=pre_offsets[1:])
    u_arr = np.where(lens > pre_lens,
                     (1.0 + pre_lens) ** -spec.gamma, 0.0).astype(np.float32)
    return dict(W=W, L=L, V=V, term_start=term_start, post_start=post_start,
                pre_L=pre_L, pre_post_start=pre_post_start,
                nnz=int(post_start[-1]), pre_nnz=int(pre_post_start[-1]),
                lens=lens, pre_lens=pre_lens, offsets=offsets,
                pre_offsets=pre_offsets, u_arr=u_arr)


def impacts(n: int, gamma: float) -> np.ndarray:
    """g(j) = (1 + j)^-gamma in float32 for j < n: ``powf(1 + j, -gamma)``
    of the C library, both operands float32, one call per j (a few
    seconds at n = 4M)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    powf = libm.powf
    powf.argtypes = (ctypes.c_float, ctypes.c_float)
    powf.restype = ctypes.c_float
    x = (np.float32(1.0) + np.arange(n, dtype=np.float32)).tolist()
    y = float(np.float32(-gamma))
    return np.fromiter(map(powf, x, itertools.repeat(y, n)), np.float32,
                       count=n)


class ZipfCorpus:
    """The power-law index's tables (``t``) and its device arrays."""

    def __init__(self, spec: ZipfSpec, dev):
        self.spec = spec
        self.dev = torch.device(dev)
        self.t = band_tables(spec)
        self.g = torch.from_numpy(
            impacts(int(self.t["L"].max()), spec.gamma)).to(self.dev)

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.dev)

    def _decode(self, p, post_start, term_start, L):
        """posting index → (term, in-list rank j), by a band table (the
        full CSR's or the prefix's)."""
        band = torch.searchsorted(post_start[1:], p, right=True)
        rel = p - post_start[band]
        ln = L[band]
        return term_start[band] + rel // ln, rel % ln

    def csr(self, prefix: bool, blk: int = 1 << 25):
        """The flat CSR of every list (``prefix=False``) or of each list's
        first ``spec.prefix`` entries: rows int32 and value bits int32
        [n + CHUNK], the pad the n_docs sentinel with value 0."""
        t, spec = self.t, self.spec
        n = t["pre_nnz"] if prefix else t["nnz"]
        starts = self._dev(t["pre_post_start"] if prefix
                           else t["post_start"])
        lens = self._dev(t["pre_L"] if prefix else t["L"])
        term_start = self._dev(t["term_start"])
        offsets = self._dev(t["offsets"])
        rows = torch.full((n + CHUNK,), spec.n_docs, dtype=torch.int32,
                          device=self.dev)
        bits = torch.zeros(n + CHUNK, dtype=torch.int32, device=self.dev)
        for lo in range(0, n, blk):
            pp = torch.arange(lo, min(lo + blk, n), dtype=torch.int64,
                              device=self.dev)
            term, j = self._decode(pp, starts, term_start, lens)
            # the prefix is the first entries of each impact-ordered list
            gp = offsets[term] + j
            doc = (spec.a_mult * (gp % spec.n_docs)) % spec.n_docs
            rows[lo:lo + len(pp)] = doc.to(torch.int32)
            bits[lo:lo + len(pp)] = self.g[j].view(torch.int32)
        return rows, bits

    def doc_major(self, block: int = 4096, dblk: int = 1 << 19):
        """The doc-major side: terms int32 and values f32 [N_pad, K] (K =
        ceil(nnz / n_docs), N_pad the next multiple of ``block`` above
        n_docs), doc d's slot m holding posting (A^-1 d mod N) + m N;
        empty slots and rows >= n_docs are zero. Returns (terms, vals,
        K)."""
        t, spec = self.t, self.spec
        N = spec.n_docs
        K = -(-t["nnz"] // N)
        n_pad = -(-(N + 1) // block) * block
        inv_a = pow(spec.a_mult, -1, N)
        post_start = self._dev(t["post_start"])
        term_start = self._dev(t["term_start"])
        L = self._dev(t["L"])
        m = torch.arange(K, dtype=torch.int64, device=self.dev)
        terms = torch.zeros((n_pad, K), dtype=torch.int32, device=self.dev)
        vals = torch.zeros((n_pad, K), dtype=torch.float32, device=self.dev)
        for lo in range(0, N, dblk):
            d = torch.arange(lo, min(lo + dblk, N), dtype=torch.int64,
                             device=self.dev)
            p = ((inv_a * d) % N)[:, None] + m[None, :] * N
            ok = p < t["nnz"]
            term, j = self._decode(torch.where(ok, p, 0).reshape(-1),
                                   post_start, term_start, L)
            term, j = term.view(p.shape), j.view(p.shape)
            terms[lo:lo + len(d)] = torch.where(ok, term, 0).to(torch.int32)
            vals[lo:lo + len(d)] = torch.where(ok, self.g[j], 0.0)
        return terms, vals, K


def make_queries(t: dict, rng, n_tiles: int, alpha: float, tile: int,
                 t_budget: int, l0_q: int) -> list:
    """Query tiles [(terms [tile, t_budget] int32, vals f32)], each query
    ``l0_q`` distinct terms drawn with probability ~ len^alpha, weights
    uniform in [0.1, 2) (bench_zipf.make_queries)."""
    probs = t["lens"].astype(np.float64) ** alpha
    probs /= probs.sum()
    tiles = []
    for _ in range(n_tiles):
        qt = np.zeros((tile, t_budget), np.int32)
        qv = np.zeros((tile, t_budget), np.float32)
        for i in range(tile):
            qt[i, :l0_q] = rng.choice(t["V"], size=l0_q, replace=False,
                                      p=probs)
            qv[i, :l0_q] = rng.uniform(0.1, 2.0, l0_q)
        tiles.append((qt, qv))
    return tiles


def query_pool(t: dict, rng, alpha: float, n: int, l0_q: int) -> list:
    """n single queries [(terms int32 [l0_q], vals f32)] drawn as in
    ``make_queries`` (bench_serving_zipf's pools)."""
    probs = t["lens"].astype(np.float64) ** alpha
    probs /= probs.sum()
    out = []
    for _ in range(n):
        terms = rng.choice(t["V"], size=l0_q, replace=False,
                           p=probs).astype(np.int32)
        vals = rng.uniform(0.1, 2.0, l0_q).astype(np.float32)
        out.append((terms, vals))
    return out


def calibrate_alpha(t: dict, target_matched: float, l0_q: int) -> float:
    """Bisection on the sampling exponent so the expected matched postings
    of an l0_q-term query hit ``target_matched`` (MSMARCO: ~425k at
    L0_q 48)."""
    lens = t["lens"].astype(np.float64)

    def expected(alpha):
        w = lens ** alpha
        return l0_q * float((lens * w).sum() / w.sum())

    lo, hi = -1.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if expected(mid) < target_matched:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def job_need(qt, qv, offsets, lens_arr, chunk: int = CHUNK) -> np.ndarray:
    """Per-query DMA job need [nq] of query terms/weights [nq, T] over a
    CSR with these offsets and list lengths, in jobs of ``chunk``
    postings aligned to ``chunk`` (CHUNK == ALIGN for the f32 and q8
    layouts, CHUNK2 for the bf16 pairs)."""
    lens = lens_arr[qt] * (qv > 0)
    heads = offsets[qt] % chunk
    return np.sum(-(-(heads + lens) // chunk) * (lens > 0), axis=1)


def jobs_for(tiles, offsets, lens_arr) -> int:
    """The largest per-query DMA job need over the tiles, rounded up to a
    multiple of 64 (at least 64)."""
    need = max(int(job_need(qt, qv, offsets, lens_arr).max())
               for qt, qv in tiles)
    return max(64, -(-need // 64) * 64)


class ZipfHostLane:
    """Host slow lane: exact term-at-a-time scoring with the posting lists
    regenerated from the band arithmetic (doc(p) = A (p mod N) mod N,
    value (1 + j)^-gamma in float64), without an 8.5 GB host copy of the
    CSR; the ``retrieve_sparse`` contract of the C++ engine. A list never
    holds a doc twice (it spans fewer than N postings), so one bincount
    over the matched lists in term order sums each doc's contributions in
    the reference's order: the same float64 scores as its one bincount per
    term."""

    def __init__(self, t: dict, spec: ZipfSpec):
        self.offsets = t["offsets"]
        self.lens = t["lens"]
        self.spec = spec

    def retrieve_sparse(self, terms, vals, topk):
        N, A = self.spec.n_docs, self.spec.a_mult
        docs, weights = [], []
        for t_, v_ in zip(terms, vals):
            if v_ <= 0:
                continue
            L = int(self.lens[t_])
            if L == 0:
                continue
            p = self.offsets[t_] + np.arange(L, dtype=np.int64)
            docs.append((A * (p % N)) % N)
            weights.append(float(v_) * (1.0 + np.arange(L, dtype=np.float64))
                           ** -self.spec.gamma)
        scores = (np.bincount(np.concatenate(docs),
                              weights=np.concatenate(weights), minlength=N)
                  if docs else np.zeros(N, np.float64))
        k = min(topk, N)
        top = np.argpartition(-scores, k - 1)[:k]
        order = top[np.argsort(-scores[top], kind="stable")]
        return order.astype(np.int64), scores[order].astype(np.float32)


# ---- bench_bmx.py's clustered corpus ------------------------------------


def make_cfg(C=1024, S=8634, PT=64, L_IN=8192, L_BG=4096,
             V_G=2000, L_G=40960, n_topic_q=12, n_generic_q=10):
    """bench_bmx.py's construction (its defaults are the published sizes):
    C topic clusters of S docs (plus one cluster-free block), PT topical
    terms per cluster posting L_IN times inside their cluster at high
    impact and L_BG times outside at low impact, V_G generic terms posting
    L_G times corpus-wide at low impact. List lengths are multiples of
    ALIGN, so no fetch window straddles two lists."""
    L_T = L_IN + L_BG
    assert L_T % ALIGN == 0 and L_G % ALIGN == 0, (L_T, L_G)
    assert S > L_IN
    cfg = dict(C=C, S=S, N=(C + 1) * S, PT=PT, V_T=C * PT, L_IN=L_IN,
               L_BG=L_BG, L_T=L_T, V_G=V_G, L_G=L_G, n_topic_q=n_topic_q,
               n_generic_q=n_generic_q)
    cfg["T_NNZ"] = cfg["V_T"] * L_T
    cfg["NNZ"] = cfg["T_NNZ"] + V_G * L_G
    cfg["V"] = cfg["V_T"] + V_G
    assert cfg["NNZ"] + CHUNK < 2 ** 31
    offsets = np.zeros(cfg["V"] + 1, np.int64)
    offsets[:cfg["V_T"] + 1] = np.arange(cfg["V_T"] + 1, dtype=np.int64) * L_T
    offsets[cfg["V_T"]:] = (cfg["T_NNZ"]
                            + np.arange(V_G + 1, dtype=np.int64) * L_G)
    cfg["offsets"] = offsets
    return cfg


def decode(pp: torch.Tensor, cfg):
    """Posting index (int64) -> (doc int64, value f32): piecewise-linear
    ascending doc maps, so every list is doc-sorted by construction.
    Topical term t of cluster c posts before, inside (high impact) and
    after [cS, cS+S); generic terms stride over the whole corpus. Values
    are a regime base plus a period-256 jitter. bench_bmx.decode's
    formulas, whose int32 products never overflow, so int64 gives the
    same integers."""
    C, S, N, PT = cfg["C"], cfg["S"], cfg["N"], cfg["PT"]
    L_T, L_IN, L_BG, L_G = cfg["L_T"], cfg["L_IN"], cfg["L_BG"], cfg["L_G"]
    T_NNZ, V_T = cfg["T_NNZ"], cfg["V_T"]
    topical = pp < T_NNZ
    ppt = torch.where(topical, pp, 0)
    t_t = ppt // L_T
    j_t = ppt % L_T
    ppg = torch.where(topical, 0, pp - T_NNZ)
    g = ppg // L_G
    j_g = ppg % L_G
    c = t_t // PT
    cs = c * S
    ce = cs + S
    j1 = (L_BG * c) // C
    j2 = j1 + L_IN
    th = t_t % 9973
    bpre = (th * 30011 + t_t * 7) % cs.clamp_min(1)
    bin_ = (th * 48271 + t_t) % L_IN
    lp = L_BG - j1
    rp = N - ce
    bpost = (th * 69621 + t_t * 13) % rp.clamp_min(1)
    j1m = j1.clamp_min(1)
    jp = torch.minimum(j_t, (j1 - 1).clamp_min(0))
    d_pre = jp * (cs // j1m) + (jp * (cs % j1m) + bpre) // j1m
    ji = (j_t - j1).clamp(0, L_IN - 1)
    d_in = cs + ji * (S // L_IN) + (ji * (S % L_IN) + bin_) // L_IN
    lpm = lp.clamp_min(1)
    jj = torch.minimum((j_t - j2).clamp_min(0), (lp - 1).clamp_min(0))
    d_post = ce + jj * (rp // lpm) + (jj * (rp % lpm) + bpost) // lpm
    d_top = torch.where(j_t < j1, d_pre, torch.where(j_t < j2, d_in, d_post))
    in_regime = topical & (j_t >= j1) & (j_t < j2)
    bg = ((g + 3) * 1013904) % N
    d_gen = j_g * (N // L_G) + (j_g * (N % L_G) + bg) // L_G
    doc = torch.where(topical, d_top, d_gen)
    term = torch.where(topical, t_t, V_T + g)
    j = torch.where(topical, j_t, j_g)
    jit8 = ((j * 13 + term * 37) % 256).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=pp.device)
    base = torch.where(topical,
                       torch.where(in_regime, torch.tensor(0.8, **f32),
                                   torch.tensor(0.05, **f32)),
                       torch.tensor(0.1, **f32))
    scale = torch.where(topical, torch.where(in_regime,
                                             torch.tensor(0.4, **f32),
                                             torch.tensor(0.2, **f32)),
                        torch.tensor(0.3, **f32))
    val = base + scale * (jit8 * torch.tensor(1.0 / 256.0, **f32))
    return doc, val


def gen_device_csr(cfg, dev):
    """Flat CSR on the device by arithmetic: rows int32 (the N sentinel
    past nnz, padded by CHUNK), f32 value bits as int32."""
    NNZ, N = cfg["NNZ"], cfg["N"]
    step = 1 << 26
    rows = torch.full((NNZ + CHUNK,), N, dtype=torch.int32, device=dev)
    bits = torch.zeros(NNZ + CHUNK, dtype=torch.int32, device=dev)
    for s in range(0, NNZ, step):
        pp = torch.arange(s, min(s + step, NNZ), dtype=torch.int64, device=dev)
        doc, val = decode(pp, cfg)
        rows[s:s + len(pp)] = doc.to(torch.int32)
        bits[s:s + len(pp)] = val.view(torch.int32)
    return rows, bits


def make_tiles(cfg, rng, n_tiles, tile: int = 64, t_budget: int = 32):
    """SPLADE-shaped query tiles: n_topic_q high-weight terms from one
    cluster plus n_generic_q low-weight expansion terms
    (bench_bmx.make_tiles, the same draws)."""
    nt, ng = cfg["n_topic_q"], cfg["n_generic_q"]
    tiles = []
    for _ in range(n_tiles):
        qt = np.zeros((tile, t_budget), np.int32)
        qv = np.zeros((tile, t_budget), np.float32)
        for i in range(tile):
            c = rng.integers(cfg["C"])
            tt = c * cfg["PT"] + rng.choice(cfg["PT"], nt, replace=False)
            gg = cfg["V_T"] + rng.choice(cfg["V_G"], ng, replace=False)
            qt[i, :nt + ng] = np.concatenate([tt, gg])
            qv[i, :nt] = rng.uniform(0.7, 1.3, nt)
            qv[i, nt:nt + ng] = rng.uniform(0.2, 0.5, ng)
        tiles.append((qt, qv))
    return tiles


def cross_check(s_a, r_a, s_b, r_b, atol: float = 2e-4) -> float:
    """bench_bmx.py's exactness test: scores allclose; rows equal except
    where the score gap is inside the tolerance (another summation order
    and sort). Raises AssertionError; returns the share of identical
    rows."""
    np.testing.assert_allclose(s_a, s_b, atol=atol, rtol=atol)
    neq = r_a != r_b
    if neq.any():
        gap = float(np.abs(s_a[neq] - s_b[neq]).max())
        assert gap < atol, f"rows differ outside the tie tolerance ({gap})"
    return float((~neq).mean())


def clustered_index(dev, cfg, topk: int = 1000, t_budget: int = 32):
    """The clustered corpus on the device, its block-max meta (computed
    from the device's tensors) and the unpruned engine over it. Returns
    (csr, meta, base engine)."""
    from scaling_retriever_tpu_torch.ops.blockmax import build_chunk_meta
    from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine

    rows, bits = gen_device_csr(cfg, dev)
    meta = build_chunk_meta(cfg["offsets"], rows, bits.view(torch.float32))
    csr = (rows, bits, cfg["offsets"], cfg["N"])
    base = SegsortEngine(topk=topk, query_terms_budget=t_budget,
                         device_csr=csr)
    return csr, meta, base


# ---- the dense corpus ----------------------------------------------------


def corpus_chunks(dev, seed: int, n_rows: int, dim: int, chunk: int):
    """``n_rows`` L2-normalized ``dim``-wide rows made on ``dev`` by
    chunks of ``chunk`` rows from a seeded generator and rounded to bf16,
    so that their f32 widening equals the bf16 layout: yields (first row,
    bf16 [n, dim])."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for s0 in range(0, n_rows, chunk):
        n = min(chunk, n_rows - s0)
        v = torch.randn(n, dim, generator=g, device=dev)
        yield s0, torch.nn.functional.normalize(v, dim=1).bfloat16()


def dense_corpus(idx, chunks):
    """Add ``corpus_chunks`` to an empty ``DenseFlatIndexer`` as tensors on
    its device (ids = rows), so its store is the bf16 layout there."""
    for s0, v in chunks:
        idx.add_batch(range(s0, s0 + len(v)), v)
    if idx.device.type == "cuda":
        torch.cuda.synchronize(idx.device)
    return idx
