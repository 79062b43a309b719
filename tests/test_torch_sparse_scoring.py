"""The port's doc-major scan (scaling_retriever_tpu_torch/ops/sparse_scoring.py)
and ``SparseIndex.to_doc_major`` against the JAX package on the same numpy
inputs. Values and query weights are dyadic, so every score is exact in f32:
scores are bit-equal and rows equal up to ties (``torch.topk`` documents no
tie order, ``lax.top_k`` takes the lower index)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index.inverted_index import SparseIndex as RefIndex
from scaling_retriever_tpu.ops import sparse_scoring as ref
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import sparse_scoring as port
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

torch.set_num_threads(1)

V = 64
N_DOCS = 150


def _triples(rng, dup=False):
    """Docs of 1-11 distinct terms (doc 7 empty), values k/16; ``dup``
    repeats one (doc, term) posting, which the doc-major row then holds
    twice."""
    rows, cols, vals = [], [], []
    for d in range(N_DOCS):
        if d == 7:
            continue
        nnz = int(rng.integers(1, 12))
        rows += [d] * nnz
        cols += rng.choice(V, size=nnz, replace=False).tolist()
        vals += (rng.integers(1, 64, nnz) / 16.0).tolist()
    if dup:
        rows.append(rows[0])
        cols.append(cols[0])
        vals.append(0.5)
    return np.array(rows), np.array(cols), np.array(vals, np.float32)


def _indexes(seed, dup=False):
    r, c, v = _triples(np.random.default_rng(seed), dup)
    ids = [f"d{i}" for i in range(N_DOCS)]
    return (SparseIndex.from_triples(r, c, v, ids, V),
            RefIndex.from_triples(r, c, v, ids, V))


def _q_t(rng, nq):
    q = np.where(rng.random((nq, V)) < 0.2, rng.integers(1, 9, (nq, V)) / 4.0,
                 0.0).astype(np.float32)
    q[-1] = 0.0                                   # an all-zero query
    return np.ascontiguousarray(q.T)


@pytest.mark.parametrize("dup", [False, True])
def test_to_doc_major_matches_reference(dup):
    mine, theirs = _indexes(1, dup)
    want_t, want_v = theirs.to_doc_major()
    got_t, got_v = mine.to_doc_major()
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_v, want_v)
    # the torch build, in chunks that split docs' postings across steps,
    # with padding rows and a given K
    for chunk in (7, 64, 1 << 20):
        tt, tv = mine.to_doc_major(device="cpu", chunk=chunk,
                                   n_rows=N_DOCS + 5)
        assert tt.dtype == torch.int32 and tv.dtype == torch.float32
        np.testing.assert_array_equal(tt[:N_DOCS].numpy(), want_t)
        np.testing.assert_array_equal(tv[:N_DOCS].numpy(), want_v)
        assert not tt[N_DOCS:].any() and not tv[N_DOCS:].any()
    k = want_t.shape[1] + 8
    tt, tv = mine.to_doc_major(k=k, device="cpu", chunk=50)
    np.testing.assert_array_equal(tt.numpy(), theirs.to_doc_major(k=k)[0])
    with pytest.raises(ValueError):
        mine.to_doc_major(k=1)


@pytest.mark.parametrize("block", [8, 32])
def test_retrieve_doc_major_matches_reference(block):
    mine, theirs = _indexes(2)
    terms_np, vals_np = theirs.to_doc_major()
    rt, rv = ref.pad_docs(jnp.asarray(terms_np), jnp.asarray(vals_np), block)
    pt, pv = port.pad_docs(torch.from_numpy(terms_np),
                           torch.from_numpy(vals_np), block)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    assert pt.shape[0] % block == 0 and pt.shape[0] >= N_DOCS
    q_t = _q_t(np.random.default_rng(block), 5)
    want = np.asarray(ref.score_doc_major(rt, rv, jnp.asarray(q_t),
                                          block=block))
    # a small step budget forces one block per step; the default takes
    # every block in one step
    for gb in (1, port.STEP_BYTES):
        got = port.score_doc_major(pt, pv, torch.from_numpy(q_t), block,
                                   step_bytes=gb)
        np.testing.assert_array_equal(got.numpy(), want)
        for k in (10, 40):
            s0, r0 = ref.retrieve_doc_major(rt, rv, jnp.asarray(q_t), k=k,
                                            block=block)
            s1, r1 = port.retrieve_doc_major(pt, pv, torch.from_numpy(q_t),
                                             k=k, block=block, step_bytes=gb)
            s0, r0 = np.asarray(s0), np.asarray(r0)
            np.testing.assert_array_equal(s1.numpy(), s0)
            for i in range(s0.shape[0]):
                tie_equal_topk(r0[i], s0[i], r1[i].numpy(), s1[i].numpy(),
                               rtol=0.0)
    # bf16 values (the driver's default value dtype) are exact on k/16
    got = port.score_doc_major(pt, pv.to(torch.bfloat16),
                               torch.from_numpy(q_t), block)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="multiple"):
        port.score_doc_major(pt[:-1], pv[:-1], torch.from_numpy(q_t), block)
