"""The bf16-pair index layout of the torch port (6 B per posting: rows
int32 plus two bf16 values per int32 word) against the JAX package's
(``pack_values_bf16``, the bf16 ``SegsortEngine`` with Pallas in interpret
mode) and the f32 engine, mirroring ``tests/test_bf16_index.py``."""

import ml_dtypes
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index.inverted_index import SparseIndex as RefIndex
from scaling_retriever_tpu.ops import segsort_scoring as ref
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import segsort_scoring as port
from scaling_retriever_tpu_torch.ops.fetch import CHUNK2
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

torch.set_num_threads(1)

V = 96
N_DOCS = 300
T = 8


def _triples(rng, bf16_exact: bool):
    rows, cols, vals = [], [], []
    for d in range(N_DOCS):
        nnz = int(rng.integers(3, 9))
        rows += [d] * nnz
        cols += rng.choice(V, size=nnz, replace=False).tolist()
        if bf16_exact:
            # <= 7 significant bits: exactly representable in bf16
            vals += (rng.integers(1, 128, size=nnz) / 64.0).tolist()
        else:
            vals += rng.uniform(0.1, 3.0, size=nnz).tolist()
    return (np.array(rows), np.array(cols), np.array(vals, np.float32),
            [f"d{d}" for d in range(N_DOCS)], V)


def _queries(rng, n, t=6):
    qt = np.zeros((n, T), np.int32)
    qv = np.zeros((n, T), np.float32)
    for i in range(n):
        qt[i, :t] = rng.choice(V, size=t, replace=False)
        qv[i, :t] = rng.integers(1, 64, size=t) / 32.0     # bf16-exact
    return qt, qv


def test_pack_values_bf16_matches_reference():
    """Bit-equal to ml_dtypes' rounding: ties to even, values that round
    up into the next binade, tiny and subnormal values, signs, zeros and
    odd lengths with and without padding."""
    rng = np.random.default_rng(1)
    base = np.array([1.0, 2.0, 3.0], np.float32)
    # exact ties: bit 15 set and bits 0-14 clear, for even and odd bf16
    ties = (np.array([0x3F808000, 0x3F818000, 0x3FFF8000, 0xBF808000],
                     np.uint32)).view(np.float32)
    tiny = np.array([1e-38, 1e-40, 1e-45, -1e-41, 0.0, -0.0, 3.4e38],
                    np.float32)
    rand = rng.standard_normal(1001).astype(np.float32) * 10
    for v in (base, ties, tiny, rand, rand[:1], np.zeros(0, np.float32)):
        for pad in (0, len(v), len(v) + 5, 2048):
            got = port.pack_values_bf16(v, pad)
            want = ref.pack_values_bf16(v, pad)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32 and 2 * len(got) >= pad
    got = port.pack_values_bf16(base, 4).view(np.uint16)
    np.testing.assert_array_equal(
        got.view(ml_dtypes.bfloat16).astype(np.float32), [1, 2, 3, 0])


@pytest.mark.parametrize("k", [10, 40])
def test_bf16_engine_matches_reference(k):
    """General f32 values (rounded to bf16 by both packages): scores at
    rtol 1e-5, rows tie-equal. k=40 takes the full top-k fallback."""
    tri = _triples(np.random.default_rng(2), bf16_exact=False)
    qt, qv = _queries(np.random.default_rng(k), 5)
    mine = port.SegsortEngine(SparseIndex.from_triples(*tri), topk=k,
                              query_terms_budget=T, val_dtype="bf16",
                              device="cpu")
    theirs = ref.SegsortEngine(RefIndex.from_triples(*tri), topk=k,
                               query_terms_budget=T, min_budget=256,
                               fetch="dma", val_dtype="bf16")
    np.testing.assert_array_equal(mine.valbits_flat.numpy(),
                                  np.asarray(theirs.valbits_flat))
    np.testing.assert_array_equal(mine.rows_flat.numpy(),
                                  np.asarray(theirs.rows_flat))
    s1, r1 = mine.finalize(mine.retrieve_tile_async(None, k,
                                                    sparsified=(qt, qv)))
    s0, r0 = theirs.finalize(theirs.retrieve_tile_async(
        None, k, sparsified=(qt, qv)))
    for i in range(len(qt)):
        fin = np.isfinite(s0[i])
        np.testing.assert_array_equal(fin, np.isfinite(s1[i]))
        tie_equal_topk(r0[i][fin], s0[i][fin], r1[i][fin], s1[i][fin],
                       rtol=1e-5)


def test_bf16_engine_matches_f32_on_representable_values():
    idx = SparseIndex.from_triples(*_triples(np.random.default_rng(3),
                                             bf16_exact=True))
    f32 = port.SegsortEngine(idx, topk=20, query_terms_budget=T,
                             device="cpu")
    bf16 = port.SegsortEngine(idx, topk=20, query_terms_budget=T,
                              val_dtype="bf16", device="cpu")
    assert bf16.valbits_flat.nbytes * 2 <= f32.valbits_flat.nbytes + 8192
    qt, qv = _queries(np.random.default_rng(4), 5)
    s0, r0 = f32.finalize(f32.retrieve_tile_async(None, 20,
                                                  sparsified=(qt, qv)))
    s1, r1 = bf16.finalize(bf16.retrieve_tile_async(None, 20,
                                                    sparsified=(qt, qv)))
    np.testing.assert_array_equal(s1, s0)    # dyadic values: exact sums
    for i in range(len(qt)):
        tie_equal_topk(r0[i], s0[i], r1[i], s1[i], rtol=0.0)


def test_bf16_segsort_function_and_plain_ops():
    """``segsort_retrieve_dma_bf16`` on the engine's arrays equals the
    engine's tile, and an engine built with the plain ops agrees."""
    idx = SparseIndex.from_triples(*_triples(np.random.default_rng(5),
                                             bf16_exact=False))
    eng = port.SegsortEngine(idx, topk=10, query_terms_budget=T,
                             val_dtype="bf16", device="cpu")
    plain = port.SegsortEngine(idx, topk=10, query_terms_budget=T,
                               val_dtype="bf16", device="cpu",
                               ops=port.PLAIN)
    qt, qv = _queries(np.random.default_rng(6), 4)
    J = port.bucket_jobs(int(eng.job_need(qt, qv).max()))
    s0, r0, total = port.segsort_retrieve_dma_bf16(
        eng.rows_flat, eng.valbits_flat, eng.offsets, torch.from_numpy(qt),
        torch.from_numpy(qv), 10, J, N_DOCS)
    lens = np.diff(idx.offsets)[qt] * (qv > 0)
    np.testing.assert_array_equal(total.numpy(), lens.sum(axis=1))
    for e in (eng, plain):
        s1, r1 = e.finalize(e.retrieve_tile_async(None, 10,
                                                  sparsified=(qt, qv)))
        np.testing.assert_array_equal(s1, s0.numpy())
        np.testing.assert_array_equal(r1, r0.numpy())


def test_bf16_job_need_counts_chunk2_jobs():
    tri = _triples(np.random.default_rng(7), bf16_exact=True)
    idx = SparseIndex.from_triples(*tri)
    f32 = port.SegsortEngine(idx, topk=10, query_terms_budget=T, device="cpu")
    bf16 = port.SegsortEngine(idx, topk=10, query_terms_budget=T,
                              val_dtype="bf16", device="cpu")
    theirs = ref.SegsortEngine(RefIndex.from_triples(*tri), topk=10,
                               query_terms_budget=T, fetch="dma",
                               val_dtype="bf16")
    qt, qv = _queries(np.random.default_rng(8), 6)
    need = bf16.job_need(qt, qv)
    np.testing.assert_array_equal(need, theirs.job_need(qt, qv))
    assert (need <= f32.job_need(qt, qv)).all()
    starts = idx.offsets[qt]
    lens = np.diff(idx.offsets)[qt] * (qv > 0)
    want = np.where(lens > 0, -(-(starts % CHUNK2 + lens) // CHUNK2), 0)
    np.testing.assert_array_equal(need, want.sum(axis=1))
    assert bf16.rows_flat.shape[0] == idx.nnz + CHUNK2
