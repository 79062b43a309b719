"""The torch segsort engine (scaling_retriever_tpu_torch/ops/segsort_scoring.py)
against the JAX engine (Pallas in interpret mode on the CPU) and a
brute-force oracle, f32 and q8 layouts. Index values and query weights are
dyadic (and the q8 scales powers of two), so every score is exact in f32
and both engines must return the same scores bit for bit; rows may differ
only among tied scores, since ``torch.topk`` documents no tie order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index.inverted_index import SparseIndex as RefIndex
from scaling_retriever_tpu.ops import segsort_scoring as ref
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import segsort_scoring as port
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

torch.set_num_threads(1)

V = 96
N_DOCS = 300
T = 8


def _index(rng, cls=SparseIndex) -> SparseIndex:
    """Values code/64 with code in [1, 255], and one doc holding every term
    at 255/64, so each term's q8 scale is exactly 1/64."""
    rows, cols, vals = [], [], []
    for d in range(N_DOCS - 1):
        nnz = int(rng.integers(3, 9))
        rows += [d] * nnz
        cols += rng.choice(V, size=nnz, replace=False).tolist()
        vals += (rng.integers(1, 256, nnz) / 64.0).tolist()
    rows += [N_DOCS - 1] * V
    cols += list(range(V))
    vals += [255 / 64.0] * V
    return cls.from_triples(np.array(rows), np.array(cols),
                            np.array(vals, np.float32),
                            [f"d{d}" for d in range(N_DOCS)], V)


def _queries(rng, nq=4):
    qt = np.zeros((nq, T), np.int32)
    qv = np.zeros((nq, T), np.float32)
    for i in range(nq):
        t = int(rng.integers(3, T + 1))
        qt[i, :t] = rng.choice(V, size=t, replace=False)
        qv[i, :t] = rng.integers(1, 9, t) / 4.0
    return qt, qv


def _dense(qt, qv):
    q = np.zeros((qt.shape[0], V), np.float32)
    np.put_along_axis(q, qt.astype(np.int64), qv, axis=1)
    q[:, 0] = np.where((qt == 0) & (qv > 0), qv, 0).max(axis=1)
    return q


def _assert_same(s_ref, r_ref, s_got, r_got):
    """Bit-equal scores; rows equal except among ties."""
    s_ref, r_ref = np.asarray(s_ref), np.asarray(r_ref)
    s_got, r_got = np.asarray(s_got), np.asarray(r_got)
    np.testing.assert_array_equal(s_got, s_ref)
    for i in range(s_ref.shape[0]):
        fin = np.isfinite(s_ref[i])
        tie_equal_topk(r_ref[i][fin], s_ref[i][fin], r_got[i][fin],
                       s_got[i][fin], rtol=0.0)


def _oracle(idx, qt, qv, k):
    dense = np.zeros((N_DOCS, V), np.float64)
    for t in range(V):
        r, v = idx.posting(t)
        dense[r, t] = v
    q = np.zeros((qt.shape[0], V))
    for i in range(qt.shape[0]):
        for t, w in zip(qt[i], qv[i]):
            if w > 0:
                q[i, t] = w
    return q @ dense.T


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    return _index(rng), _index(np.random.default_rng(5), RefIndex)


@pytest.mark.parametrize("val_dtype", ["f32", "q8"])
@pytest.mark.parametrize("k", [10, 40])
def test_engine_matches_reference_and_oracle(corpus, val_dtype, k):
    """k=40 leaves the merged top-k short of finite candidates (all docs
    sit in one 4096-slot block), so the blocked certificate fails and both
    engines take the full top-k: that branch is on the line too."""
    idx, ref_idx = corpus
    qt, qv = _queries(np.random.default_rng(k))
    mine = port.SegsortEngine(idx, topk=k, query_terms_budget=T,
                              val_dtype=val_dtype, device="cpu")
    theirs = ref.SegsortEngine(ref_idx, topk=k, query_terms_budget=T,
                               min_budget=256, fetch="dma",
                               val_dtype=val_dtype)
    s_got, r_got = mine.finalize(mine.retrieve_tile_async(
        None, k, sparsified=(qt, qv)))
    s_ref, r_ref = theirs.finalize(theirs.retrieve_tile_async(
        None, k, sparsified=(qt, qv)))
    _assert_same(s_ref, r_ref, s_got, r_got)
    want = _oracle(idx, qt, qv, k)
    for i in range(qt.shape[0]):
        fin = np.isfinite(s_got[i])
        order = np.argsort(-want[i], kind="stable")
        pos = order[want[i][order] > 0][:k]
        tie_equal_topk(pos, want[i][pos], r_got[i][fin], s_got[i][fin],
                       rtol=1e-6)


def test_segsort_functions_match_reference(corpus):
    """segsort_retrieve_dma{,_q8,_packed,_packed_q8} on the same device
    arrays as the reference's, including the packed (score bits | rows |
    need) handoff buffer and a truncating job bucket."""
    idx, ref_idx = corpus
    qt, qv = _queries(np.random.default_rng(3))
    eng = port.SegsortEngine(idx, topk=10, query_terms_budget=T, device="cpu")
    q8 = port.SegsortEngine(idx, topk=10, query_terms_budget=T,
                            val_dtype="q8", device="cpu")
    r_eng = ref.SegsortEngine(ref_idx, topk=10, query_terms_budget=T,
                              min_budget=256, fetch="dma")
    J = ref.bucket_jobs(int(eng.job_need(qt, qv).max()))
    tq, tv = torch.from_numpy(qt), torch.from_numpy(qv)
    jq, jv = jnp.asarray(qt), jnp.asarray(qv)
    kw = dict(k=10, jobs_per_query=J, n_docs=N_DOCS)
    rf = (r_eng.rows_flat, r_eng.valbits_flat, r_eng.offsets)

    s0, r0, n0 = ref.segsort_retrieve_dma(*rf, jq, jv, interpret=True, **kw)
    s1, r1, n1 = port.segsort_retrieve_dma(eng.rows_flat, eng.valbits_flat,
                                           eng.offsets, tq, tv, **kw)
    _assert_same(s0, r0, s1, r1)
    np.testing.assert_array_equal(np.asarray(n0), n1.numpy())

    scales = q8._host_scales
    qv8 = qv * scales[qt]
    packed_ref = ref.pack_postings_q8(idx.offsets, idx.doc_rows, idx.values,
                                      N_DOCS, idx.nnz + 1024)[0]
    s0, r0, _ = ref.segsort_retrieve_dma_q8(
        jnp.asarray(packed_ref), r_eng.offsets, jq, jnp.asarray(qv8),
        interpret=True, **kw)
    np.testing.assert_array_equal(packed_ref, q8.rows_flat.numpy())
    s1, r1, _ = port.segsort_retrieve_dma_q8(q8.rows_flat, q8.offsets, tq,
                                             torch.from_numpy(qv8), **kw)
    _assert_same(s0, r0, s1, r1)

    for jobs in (J, 1):   # 1 truncates every query: need says so
        kw["jobs_per_query"] = jobs
        b0 = np.asarray(ref.segsort_retrieve_dma_packed(
            *rf, jq, jv, interpret=True, **kw))
        b1 = port.segsort_retrieve_dma_packed(
            eng.rows_flat, eng.valbits_flat, eng.offsets, tq, tv, **kw).numpy()
        np.testing.assert_array_equal(b1[:, 20], eng.job_need(qt, qv))
        np.testing.assert_array_equal(b1[:, 20], b0[:, 20])
        _assert_same(b0[:, :10].view(np.float32), b0[:, 10:20],
                     b1[:, :10].view(np.float32), b1[:, 10:20])
    b0 = np.asarray(ref.segsort_retrieve_dma_packed_q8(
        jnp.asarray(packed_ref), jnp.asarray(scales), r_eng.offsets, jq, jv,
        interpret=True, **kw))
    b1 = port.segsort_retrieve_dma_packed_q8(
        q8.rows_flat, torch.from_numpy(scales), q8.offsets, tq, tv,
        **kw).numpy()
    np.testing.assert_array_equal(b1[:, 20], b0[:, 20])
    _assert_same(b0[:, :10].view(np.float32), b0[:, 10:20],
                 b1[:, :10].view(np.float32), b1[:, 10:20])


def test_real_valued_engine_is_tie_equal():
    """Real-valued impacts and weights: sums differ in association between
    the engines, so the results agree to f32 rounding, up to ties."""
    rng = np.random.default_rng(8)
    rows = np.repeat(np.arange(N_DOCS), 6)
    cols = np.concatenate([rng.choice(V, 6, replace=False)
                           for _ in range(N_DOCS)])
    vals = rng.uniform(0.1, 3.0, len(rows)).astype(np.float32)
    ids = [f"d{d}" for d in range(N_DOCS)]
    qt, qv = _queries(rng)
    qv = qv * rng.uniform(0.9, 1.1, qv.shape).astype(np.float32)
    mine = port.SegsortEngine(SparseIndex.from_triples(rows, cols, vals, ids, V),
                              topk=20, query_terms_budget=T, device="cpu")
    theirs = ref.SegsortEngine(RefIndex.from_triples(rows, cols, vals, ids, V),
                               topk=20, query_terms_budget=T, min_budget=256,
                               fetch="dma")
    s1, r1 = mine.retrieve_tile(_dense(qt, qv))
    s0, r0 = theirs.retrieve_tile(_dense(qt, qv))
    for i in range(qt.shape[0]):
        fin = np.isfinite(s0[i])
        tie_equal_topk(r0[i][fin], s0[i][fin], r1[i][fin], s1[i][fin],
                       rtol=1e-6)


def test_sparsify_and_pack_match_reference():
    rng = np.random.default_rng(4)
    q = np.where(rng.random((5, V)) < 0.1, rng.random((5, V)), 0
                 ).astype(np.float32)
    q[0, :20] = 1.0   # 20 nonzeros > T: the width grows to 24
    for a, b in zip(port.sparsify_reps(q, T), ref.sparsify_reps(q, T)):
        np.testing.assert_array_equal(a, b)
    for need in (1, 64, 65, 97, 300, 1000):
        assert port.bucket_jobs(need) == ref.bucket_jobs(need)


def test_index_files_load_in_both_packages(tmp_path):
    """save/load round trip across the packages, both directions."""
    rng = np.random.default_rng(6)
    mine = _index(rng)
    mine.save(str(tmp_path / "a"))
    theirs = RefIndex.load(str(tmp_path / "a"))
    theirs.save(str(tmp_path / "b"))
    back = SparseIndex.load(str(tmp_path / "b"))
    for x in (theirs, back):
        np.testing.assert_array_equal(x.offsets, mine.offsets)
        np.testing.assert_array_equal(x.doc_rows, mine.doc_rows)
        np.testing.assert_array_equal(x.values, mine.values)
        assert x.doc_ids == mine.doc_ids and x.dim == mine.dim
    for name in ("doc_ids.json", "index_dist.json", "index_stats.json"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()


def test_engine_rejects_what_it_lacks(corpus):
    idx, _ = corpus
    with pytest.raises(NotImplementedError):
        port.SegsortEngine(idx, val_dtype="bf16", device="cpu")
    rows = torch.zeros(idx.nnz, dtype=torch.int32)    # no CHUNK pad
    with pytest.raises(ValueError, match="padded"):
        port.SegsortEngine(device_csr=(rows, rows, idx.offsets, N_DOCS))
