"""The port's maxscore engine (scaling_retriever_tpu_torch/ops/maxscore.py)
against the JAX package on the same index and queries. Values and weights
are dyadic, so scores are bit-equal and rows equal up to ties; the
certificate sees the same partial scores and bounds, so both engines fall
back on the same tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index.inverted_index import SparseIndex as RefIndex
from scaling_retriever_tpu.ops import maxscore as ref
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import maxscore as port
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

torch.set_num_threads(1)

V = 40
N_DOCS = 300
T = 8


def _index(cls):
    """Skewed lists (term t posts in about N/(t+2) docs) with many tied
    impacts (k/8 for k in 1..24), so the prefix cut lands inside ties."""
    rng = np.random.default_rng(0)
    rows, cols, vals = [], [], []
    for t in range(V):
        docs = np.nonzero(rng.random(N_DOCS) < 1.0 / (0.5 * t + 1))[0]
        rows += docs.tolist()
        cols += [t] * len(docs)
        vals += (rng.integers(1, 25, len(docs)) / 8.0).tolist()
    return cls.from_triples(np.array(rows), np.array(cols),
                            np.array(vals, np.float32),
                            [f"d{d}" for d in range(N_DOCS)], V)


def _dense_queries(seed, nq):
    rng = np.random.default_rng(seed)
    q = np.zeros((nq, V), np.float32)
    for i in range(nq):
        t = rng.choice(V, size=int(rng.integers(2, T + 1)), replace=False)
        q[i, t] = rng.integers(1, 9, len(t)) / 4.0
    return q


def _same(s0, r0, s1, r1):
    s0, r0, s1, r1 = map(np.asarray, (s0, r0, s1, r1))
    np.testing.assert_array_equal(s1, s0)
    for i in range(s0.shape[0]):
        fin = np.isfinite(s0[i])
        tie_equal_topk(r0[i][fin], s0[i][fin], r1[i][fin], s1[i][fin],
                       rtol=0.0)


@pytest.mark.parametrize("prefix", [1, 7, 50, 10_000])
def test_build_impact_prefix_matches_reference(prefix):
    mine, theirs = _index(SparseIndex), _index(RefIndex)
    want, u_want = ref.build_impact_prefix(theirs, prefix)
    # host, then the torch build with chunks that split the index by term
    for kw in ({}, {"device": "cpu", "chunk": 1}, {"device": "cpu",
                                                    "chunk": 500}):
        got, u_got = port.build_impact_prefix(mine, prefix, **kw)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_array_equal(got.doc_rows, want.doc_rows)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(u_got, u_want)
        assert got.doc_ids == want.doc_ids


def test_rescore_candidates_matches_reference():
    theirs = _index(RefIndex)
    terms, vals = theirs.to_doc_major()
    n_pad = N_DOCS + 4
    terms = np.vstack([terms, np.zeros((4, terms.shape[1]), np.int32)])
    vals = np.vstack([vals, np.zeros((4, vals.shape[1]), np.float32)])
    rng = np.random.default_rng(1)
    nq, C, k = 5, 30, 10
    cand = rng.integers(0, N_DOCS, (nq, C)).astype(np.int32)
    cand[:, -3:] = N_DOCS                                  # sentinel slots
    ps = -np.sort(-(rng.integers(0, 40, (nq, C)) / 4.0), axis=1)
    ps = ps.astype(np.float32)
    ps[:, -3:] = -np.inf
    ps[0, -5:] = 0.0
    qt = rng.integers(0, V, (nq, T)).astype(np.int32)
    qv = (rng.integers(0, 9, (nq, T)) / 4.0).astype(np.float32)
    bound = np.array([0.0, 0.5, 4.0, 100.0, 1.25], np.float32)
    s0, r0, ok0 = ref.rescore_candidates(
        jnp.asarray(terms), jnp.asarray(vals), jnp.asarray(ps),
        jnp.asarray(cand), jnp.asarray(qt), jnp.asarray(qv),
        jnp.asarray(bound), k=k, n_docs=N_DOCS)
    s1, r1, ok1 = port.rescore_candidates(
        torch.from_numpy(terms), torch.from_numpy(vals), torch.from_numpy(ps),
        torch.from_numpy(cand), torch.from_numpy(qt), torch.from_numpy(qv),
        torch.from_numpy(bound), k, N_DOCS)
    assert terms.shape[0] == n_pad
    _same(s0, r0, s1.numpy(), r1.numpy())
    np.testing.assert_array_equal(ok1.numpy(), np.asarray(ok0))
    assert ok1.any() and not ok1.all()


@pytest.mark.parametrize("prefix,fetch", [(10_000, "auto"), (6, "auto"),
                                          (6, "dma")])
def test_engine_matches_reference(prefix, fetch):
    """prefix 10,000 keeps every list (bound 0: always certified); prefix 6
    cuts the long lists, so some queries fail the certificate and take the
    exhaustive scan. The port's prefix engine runs on the CPU gather path
    ("auto") and on the DMA path of the card."""
    mine, theirs = _index(SparseIndex), _index(RefIndex)
    kw = dict(topk=12, prefix=prefix, candidates=24, query_terms_budget=T,
              min_budget=256, block=64)
    eng = port.MaxScoreEngine(mine, device="cpu", fetch=fetch, **kw)
    r_eng = ref.MaxScoreEngine(theirs, **kw)
    q = _dense_queries(2, 10)
    _same(*r_eng.retrieve_tile(q), *eng.retrieve_tile(q))
    q = _dense_queries(3, 21)
    _same(*r_eng.retrieve_batch(q, tile=8), *eng.retrieve_batch(q, tile=8))
    assert (eng.tiles, eng.fallbacks) == (r_eng.tiles, r_eng.fallbacks)
    if prefix < 100:
        assert 0 < eng.fallbacks
    else:
        assert eng.fallbacks == 0
