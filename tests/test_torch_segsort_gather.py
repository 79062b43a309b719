"""The segsort engine's gather path (``fetch="gather"``, ``segsort_retrieve``)
and its rank tail against the JAX package, and against the port's own DMA
engine. Values and weights are dyadic, so sums are exact in any order:
scores bit-equal, rows equal up to ties."""

import jax
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

V = 80
N_DOCS = 400
T = 16


def _index(cls, seed=0):
    """Docs of 2-9 terms at k/32; terms 0-11 post in every doc of 0..39, so
    a query over them builds doc runs longer than the assumed 8."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for d in range(N_DOCS):
        nnz = int(rng.integers(2, 10))
        rows += [d] * nnz
        cols += rng.choice(np.arange(16, V), size=nnz, replace=False).tolist()
        vals += (rng.integers(1, 96, nnz) / 32.0).tolist()
        if d < 40:
            rows += [d] * 12
            cols += list(range(12))
            vals += (rng.integers(1, 96, 12) / 32.0).tolist()
    return cls.from_triples(np.array(rows), np.array(cols),
                            np.array(vals, np.float32),
                            [f"d{d}" for d in range(N_DOCS)], V)


def _queries(rng, nq=6, long_runs=False):
    qt = np.zeros((nq, T), np.int32)
    qv = np.zeros((nq, T), np.float32)
    for i in range(nq):
        t = int(rng.integers(3, T + 1))
        pool = np.arange(V) if long_runs else np.arange(16, V)
        qt[i, :t] = rng.choice(pool, size=t, replace=False)
        if long_runs:
            qt[i, :12] = np.arange(12)
            t = max(t, 12)
        qv[i, :t] = rng.integers(1, 9, t) / 4.0
    return qt, qv


def _same(s_ref, r_ref, s_got, r_got):
    s_ref, r_ref = np.asarray(s_ref), np.asarray(r_ref)
    s_got, r_got = np.asarray(s_got), np.asarray(r_got)
    np.testing.assert_array_equal(s_got, s_ref)
    for i in range(s_ref.shape[0]):
        fin = np.isfinite(s_ref[i])
        tie_equal_topk(r_ref[i][fin], s_ref[i][fin], r_got[i][fin],
                       s_got[i][fin], rtol=0.0)


def test_segmented_sums_match_reference():
    rng = np.random.default_rng(1)
    n = 160
    vals = (rng.integers(-40, 40, n) / 8.0).astype(np.float32)
    keys = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    starts = np.concatenate([[True], keys[1:] != keys[:-1]])
    got = port._segmented_sum_scan(torch.from_numpy(vals),
                                   torch.from_numpy(starts))
    want = jax.jit(ref._segmented_sum_scan)(jnp.asarray(vals),
                                            jnp.asarray(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    max_run = int(np.max(np.unique(keys, return_counts=True)[1]))
    for run in (max_run, max_run + 5):
        got = port._segmented_sum_bounded(torch.from_numpy(vals),
                                          torch.from_numpy(keys), run)
        want = jax.jit(ref._segmented_sum_bounded, static_argnums=2)(
            jnp.asarray(vals), jnp.asarray(keys), run)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("long_runs", [False, True])
def test_rank_tail_certificate_matches_reference(long_runs):
    """The gather path's rank tail against the reference's ``topm="xla"``
    tail, whose assumed-run certificate holds after three passes with runs
    of at most 8, and takes the remaining passes with runs of 12. The
    port's tail (``_rank_tail``, the DMA path's) sums every run in full."""
    rng = np.random.default_rng(2)
    nq, P, sent = 3, 512, N_DOCS
    rows = rng.integers(0, 390, (nq, P)).astype(np.int32)
    if long_runs:
        rows[:, :12] = 5
    rows[:, -40:] = sent
    contrib = (rng.integers(1, 64, (nq, P)) / 16.0).astype(np.float32)
    contrib[rows == sent] = 0.0
    srow = np.sort(rows, axis=1)
    long_run = ((srow[:, 8:] == srow[:, :-8]) & (srow[:, 8:] != sent)).any()
    assert bool(long_run) == long_runs
    s0, r0 = ref._rank_tail(jnp.asarray(rows), jnp.asarray(contrib),
                            jnp.int32(sent), 20, T, topm="xla")
    for ops in (port.KERNELS, port.PLAIN):
        s1, r1 = port._rank_tail(torch.from_numpy(rows),
                                 torch.from_numpy(contrib), sent, 20, T, ops)
        _same(s0, r0, s1, r1)
    # the passes themselves, continued from the assumed-run result as the
    # reference's certificate continues them
    order = np.argsort(rows, axis=1, kind="stable")
    sc = np.take_along_axis(contrib, order, 1)
    part = ref._segsum_passes(jnp.asarray(sc), jnp.asarray(srow), 1, 8)
    want = ref._segsum_passes(part, jnp.asarray(srow), 8, T)
    got_part = port._segsum_passes(torch.from_numpy(sc),
                                   torch.from_numpy(srow), 1, 8)
    np.testing.assert_array_equal(got_part.numpy(), np.asarray(part))
    got = port._segsum_passes(got_part, torch.from_numpy(srow), 8, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not long_runs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(part))


@pytest.mark.parametrize("long_runs", [False, True])
def test_segsort_retrieve_matches_reference(long_runs):
    idx, ref_idx = _index(SparseIndex), _index(RefIndex)
    qt, qv = _queries(np.random.default_rng(3), long_runs=long_runs)
    packed = port.pack_postings(idx.offsets, idx.doc_rows, idx.values)
    np.testing.assert_array_equal(
        packed, ref.pack_postings(ref_idx.offsets, ref_idx.doc_rows,
                                  ref_idx.values))
    off = idx.offsets.astype(np.int64)
    for k, p_budget in ((10, 512), (60, 1024)):
        s0, r0, n0 = ref.segsort_retrieve(
            jnp.asarray(packed), jnp.asarray(off), jnp.asarray(qt),
            jnp.asarray(qv), k=k, p_budget=p_budget, n_docs=N_DOCS)
        s1, r1, n1 = port.segsort_retrieve(
            torch.from_numpy(packed), torch.from_numpy(off),
            torch.from_numpy(qt), torch.from_numpy(qv), k, p_budget, N_DOCS)
        _same(s0, r0, s1, r1)
        np.testing.assert_array_equal(n1.numpy(), np.asarray(n0))


def test_gather_engine_matches_reference_and_dma_engine():
    idx, ref_idx = _index(SparseIndex, 4), _index(RefIndex, 4)
    gather = port.SegsortEngine(idx, topk=25, query_terms_budget=T,
                                device="cpu", fetch="auto", min_budget=256)
    assert gather.fetch == "gather" and gather.rows_flat is None
    np.testing.assert_array_equal(
        gather.packed.numpy(),
        port.pack_postings(idx.offsets, idx.doc_rows, idx.values))
    dma = port.SegsortEngine(idx, topk=25, query_terms_budget=T,
                             device="cpu")
    theirs = ref.SegsortEngine(ref_idx, topk=25, query_terms_budget=T,
                               min_budget=256, fetch="gather")
    for seed, long_runs in ((5, False), (6, True)):
        qt, qv = _queries(np.random.default_rng(seed), long_runs=long_runs)
        s_g, r_g = gather.finalize(gather.retrieve_tile_async(
            None, 25, sparsified=(qt, qv)))
        s_d, r_d = dma.finalize(dma.retrieve_tile_async(
            None, 25, sparsified=(qt, qv)))
        s_r, r_r = theirs.finalize(theirs.retrieve_tile_async(
            None, 25, sparsified=(qt, qv)))
        _same(s_r, r_r, s_g, r_g)
        _same(s_d, r_d, s_g, r_g)


def test_fetch_choice():
    idx = _index(SparseIndex)
    with pytest.raises(ValueError, match="fetch"):
        port.SegsortEngine(idx, device="cpu", fetch="scan")
    # bf16 and q8 exist only on the DMA path
    for vd in ("bf16", "q8"):
        assert port.SegsortEngine(idx, device="cpu", val_dtype=vd,
                                  fetch="gather").fetch == "dma"
    gather = port.SegsortEngine(idx, device="cpu", fetch="gather")
    with pytest.raises(ValueError, match="handoff"):
        gather.retrieve_tile_handoff_async(
            torch.zeros((1, T), dtype=torch.int32), torch.ones((1, T)), 64)
