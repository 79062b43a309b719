"""The block-max pruned engine of the torch port
(scaling_retriever_tpu_torch/ops/blockmax.py) against the JAX package's
(``ops/blockmax.py``, Pallas in interpret mode on the CPU) and a
brute-force oracle, on a copy of ``tests/test_blockmax.py``'s clustered
corpus. The host pruner is the same numpy on both sides, so its arrays are
compared bit for bit; scores at rtol 1e-5, rows up to ties."""

import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index.inverted_index import SparseIndex as RefIndex
from scaling_retriever_tpu.ops import blockmax as ref
from scaling_retriever_tpu.ops.segsort_scoring import \
    SegsortEngine as RefEngine
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import blockmax as port
from scaling_retriever_tpu_torch.ops.fetch import CHUNK
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    PLAIN, SegsortEngine,
)
from scaling_retriever_tpu_torch.utils.utils import (
    depth2_pipeline, staged_pipeline, tie_equal_topk,
)

torch.set_num_threads(1)

V = 60
N_DOCS = 40000
TOPICS = 8
PER_TOPIC = 6
TB = 24


def make_clustered(seed=0, in_block_sz=3000, bg_sz=200, generic_sz=12000):
    """Topic-clustered corpus (tests/test_blockmax.py): contiguous topic
    blocks, high-impact in-block postings plus a low-impact scattered tail
    per topic term, and long uniform low-impact generic lists. Returns the
    (rows, cols, vals, ids, V) triples, doc-sorted within each term."""
    rng = np.random.default_rng(seed)
    block = N_DOCS // TOPICS
    rows, cols, vals = [], [], []
    for t in range(TOPICS * PER_TOPIC):
        topic = t // PER_TOPIC
        in_block = rng.choice(block, size=in_block_sz,
                              replace=False) + topic * block
        bg = rng.choice(N_DOCS, size=bg_sz, replace=False)
        rows += [in_block, bg]
        cols += [np.full(in_block_sz, t), np.full(bg_sz, t)]
        vals += [rng.uniform(0.8, 1.2, in_block_sz).astype(np.float32),
                 rng.uniform(0.05, 0.25, bg_sz).astype(np.float32)]
    for t in range(TOPICS * PER_TOPIC, V):
        docs = rng.choice(N_DOCS, size=generic_sz, replace=False)
        rows.append(docs)
        cols.append(np.full(generic_sz, t))
        vals.append(rng.uniform(0.1, 0.4, generic_sz).astype(np.float32))
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int64)
    vals = np.concatenate(vals)
    order = np.lexsort((rows, cols))
    return (rows[order], cols[order], vals[order],
            [str(i) for i in range(N_DOCS)], V)


def make_queries(nq, seed=1, n_topic=6, n_generic=8):
    rng = np.random.default_rng(seed)
    qt = np.zeros((nq, TB), np.int32)
    qv = np.zeros((nq, TB), np.float32)
    nt = n_topic + n_generic
    for i in range(nq):
        topic = rng.integers(TOPICS)
        tt = rng.choice(PER_TOPIC, size=n_topic,
                        replace=False) + topic * PER_TOPIC
        gg = rng.choice(V - TOPICS * PER_TOPIC, size=n_generic,
                        replace=False) + TOPICS * PER_TOPIC
        qt[i, :nt] = np.concatenate([tt, gg])
        qv[i, :n_topic] = rng.uniform(0.7, 1.3, n_topic)
        qv[i, n_topic:nt] = rng.uniform(0.2, 0.5, n_generic)
    return qt, qv


def brute_force(idx, qt, qv, k):
    dense = np.zeros((qt.shape[0], idx.nb_docs()), np.float32)
    for i in range(qt.shape[0]):
        for t, w in zip(qt[i], qv[i]):
            if w > 0:
                s, e = idx.offsets[t], idx.offsets[t + 1]
                np.add.at(dense[i], idx.doc_rows[s:e], w * idx.values[s:e])
    top = np.argsort(-dense, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dense, top, axis=1), top


def _assert_exact(s, r, bs, br, rtol=1e-5):
    for i in range(len(s)):
        fin = bs[i] > 0
        tie_equal_topk(br[i][fin], bs[i][fin], r[i][fin], s[i][fin],
                       rtol=rtol)


def _scattered(tri):
    """The same postings under a random doc permutation, lists re-sorted:
    every window's doc span covers most of the corpus."""
    rows, cols, vals, ids, _ = tri
    perm = np.random.default_rng(7).permutation(N_DOCS).astype(np.int32)
    rows2 = perm[rows]
    order = np.lexsort((rows2, cols))
    return rows2[order], cols[order], vals[order], ids, V


@pytest.fixture(scope="module")
def clustered():
    tri = make_clustered()
    qt, qv = make_queries(6)
    return (SparseIndex.from_triples(*tri), RefIndex.from_triples(*tri),
            qt, qv, tri)


def test_check_doc_sorted(clustered):
    idx, _, _, _, _ = clustered
    assert port.check_doc_sorted(idx.offsets, idx.doc_rows)
    bad = idx.doc_rows.copy()
    t = int(np.argmax(np.diff(idx.offsets)))
    s = int(idx.offsets[t])
    bad[s], bad[s + 1] = bad[s + 1], bad[s]
    assert not port.check_doc_sorted(idx.offsets, bad)
    assert not ref.check_doc_sorted(idx.offsets, bad)
    assert port.check_doc_sorted(np.array([0, 2, 4]),
                                 np.array([5, 9, 1, 2], np.int32))


@pytest.mark.parametrize("sub", [256, 128])
def test_chunk_meta_matches_reference(clustered, sub):
    """From numpy arrays and from tensors padded past nnz (the device_csr
    form, where the per-sub-block max is a segment_reduce)."""
    idx, _, _, _, _ = clustered
    want = ref.build_chunk_meta(idx.offsets, idx.doc_rows, idx.values,
                                sub=sub)
    rows = torch.from_numpy(np.concatenate(
        [idx.doc_rows, np.full(CHUNK, N_DOCS, np.int32)]))
    vals = torch.from_numpy(np.concatenate(
        [idx.values, np.full(CHUNK, 9.0, np.float32)]))
    for got in (port.build_chunk_meta(idx.offsets, idx.doc_rows, idx.values,
                                      sub=sub),
                port.build_chunk_meta(idx.offsets, rows, vals, sub=sub)):
        assert got["sub"] == want["sub"]
        for key in ("term_chunk_offset", "sub_max", "sub_lo", "sub_hi"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])


def test_pruner_matches_reference(clustered):
    """build_overlay, cover_tau, keep_entries and both passes' job tables
    (pass 2 compacted through q_rows), array for array."""
    idx, _, qt, qv, _ = clustered
    meta = port.build_chunk_meta(idx.offsets, idx.doc_rows, idx.values)
    offs = np.asarray(idx.offsets, np.int64)
    ov = port.build_overlay(meta, offs, qt, qv, N_DOCS)
    ov_ref = ref.build_overlay(meta, offs, qt, qv, N_DOCS)
    assert ov.keys() == ov_ref.keys()
    for key in ov:
        np.testing.assert_array_equal(ov[key], ov_ref[key], err_msg=key)
    tau = port.cover_tau(ov, 4.0 * 20)
    np.testing.assert_array_equal(tau, ref.cover_tau(ov_ref, 4.0 * 20))
    kept = port.keep_entries(ov, tau)
    np.testing.assert_array_equal(kept, ref.keep_entries(ov_ref, tau))
    assert 0 < kept.mean() < 1
    q_rows = np.array([0, -1, 1, -1, 2, -1])
    kept2 = kept & (q_rows[ov["e_q"]] >= 0)
    for args in ((kept,), (kept2, q_rows)):
        got = port.job_table(ov, *args)
        want = ref.job_table(ov_ref, *args)
        assert got["jobs_per_query"] == want["jobs_per_query"]
        for key in ("packed", "dropped_any"):
            np.testing.assert_array_equal(got[key], want[key])
    assert port.build_overlay(meta, offs, qt, np.zeros_like(qv),
                              N_DOCS) is None
    assert [port._rung(n) for n in (1, 5, 64, 65)] == [4, 8, 64, 128]


def test_blockmax_retrieve_dma_matches_reference(clustered):
    """The packed [nq, 2k] result of one pass against the reference's, on
    a real pass-1 table with one extra entry of weight -1 over a full
    window: the reference's valid mask drops it (qw > 0), so must ours."""
    import jax.numpy as jnp

    idx, ref_idx, qt, qv, _ = clustered
    k = 20
    meta = port.build_chunk_meta(idx.offsets, idx.doc_rows, idx.values)
    ov = port.build_overlay(meta, np.asarray(idx.offsets, np.int64), qt, qv,
                            N_DOCS)
    plan = port.job_table(ov, port.keep_entries(ov, port.cover_tau(ov, 80)))
    packed = plan["packed"].copy()
    J = plan["jobs_per_query"]
    free = int(np.flatnonzero(packed[3, 0] == 0)[0])
    packed[:, 0, free] = [int(packed[0, 0, 0]), 0, CHUNK,
                          np.float32(-1.0).view(np.int32)]
    mine = SegsortEngine(idx, topk=k, query_terms_budget=TB, device="cpu")
    theirs = RefEngine(ref_idx, topk=k, query_terms_budget=TB, fetch="dma",
                       min_budget=256)
    want = np.asarray(ref.blockmax_retrieve_dma(
        theirs.rows_flat, theirs.valbits_flat, jnp.asarray(packed), k=k,
        jobs_per_query=J, n_docs=N_DOCS, max_run=TB, interpret=True))
    for ops in (port.KERNELS, PLAIN):
        got = port.blockmax_retrieve_dma(
            mine.rows_flat, mine.valbits_flat, torch.from_numpy(packed), k, J,
            N_DOCS, TB, ops=ops).numpy()
        assert got.shape == want.shape == (qt.shape[0], 2 * k)
        _assert_exact(got[:, :k].copy().view(np.float32), got[:, k:],
                      want[:, :k].copy().view(np.float32), want[:, k:])
    with pytest.raises(ValueError, match="jobs per query"):
        port.blockmax_retrieve_dma(mine.rows_flat, mine.valbits_flat,
                                   torch.from_numpy(packed), k, J + 1,
                                   N_DOCS, TB)


def test_engine_matches_reference_and_oracle(clustered):
    """Both engines prune (no gate) with the same stats() counts, and
    return brute force's top-k."""
    idx, ref_idx, qt, qv, _ = clustered
    k = 20
    mine = port.BlockMaxSegsortEngine(idx, topk=k, query_terms_budget=TB,
                                      cover=8.0, gate=0.95, device="cpu")
    theirs = ref.BlockMaxSegsortEngine(ref_idx, topk=k, query_terms_budget=TB,
                                       cover=8.0, gate=0.95, min_budget=256)
    s1, r1 = mine.finalize(mine.retrieve_tile_async(None, k,
                                                    sparsified=(qt, qv)))
    s0, r0 = theirs.finalize(theirs.retrieve_tile_async(
        None, k, sparsified=(qt, qv)))
    st, st_ref = mine.stats(), theirs.stats()
    assert st["pruned_tiles"] == 1 and st["gated_tiles"] == 0
    assert st["mean_kept_frac"] < 0.9
    for key in st:
        if key != "host_ms":
            assert st[key] == st_ref[key], key
    assert set(st["host_ms"]) == set(st_ref["host_ms"])
    _assert_exact(s1, r1, s0, r0)
    _assert_exact(s1, r1, *brute_force(idx, qt, qv, k))


def test_engine_prunes_to_pass2_and_matches_oracle(clustered):
    """Aggressive cover: pass 1 cannot certify every query, so the
    compacted pass 2 runs (a rung of 4 or more rows)."""
    idx, ref_idx, qt, qv, _ = clustered
    k = 10
    mine = port.BlockMaxSegsortEngine(idx, topk=k, query_terms_budget=TB,
                                      cover=1.5, gate=0.99, device="cpu")
    theirs = ref.BlockMaxSegsortEngine(ref_idx, topk=k, query_terms_budget=TB,
                                       cover=1.5, gate=0.99, min_budget=256)
    s1, r1 = mine.finalize(mine.retrieve_tile_async(None, k,
                                                    sparsified=(qt, qv)))
    theirs.finalize(theirs.retrieve_tile_async(None, k, sparsified=(qt, qv)))
    st = mine.stats()
    assert st["pass2_tiles"] == 1 and st["n_q_pass2"] > 0
    for key in ("pass2_tiles", "n_q_certified", "n_q_pass2",
                "mean_kept_frac"):
        assert st[key] == theirs.stats()[key], key
    _assert_exact(s1, r1, *brute_force(idx, qt, qv, k))


def test_gate_on_scattered(clustered):
    _, _, qt, qv, tri = clustered
    idx2 = SparseIndex.from_triples(*_scattered(tri))
    k = 50
    eng = port.BlockMaxSegsortEngine(idx2, topk=k, query_terms_budget=TB,
                                     cover=4.0, gate=0.5, device="cpu")
    base = SegsortEngine(idx2, topk=k, query_terms_budget=TB, device="cpu")
    s, r = eng.finalize(eng.retrieve_tile_async(None, k, sparsified=(qt, qv)))
    assert eng.stats()["gated_tiles"] >= 1
    # the gated path is the base engine's: the same tile bit for bit
    s0, r0 = base.finalize(base.retrieve_tile_async(None, k,
                                                    sparsified=(qt, qv)))
    np.testing.assert_array_equal(s, s0)
    np.testing.assert_array_equal(r, r0)
    _assert_exact(s, r, *brute_force(idx2, qt, qv, k))


def test_rejects_unsorted_lists_and_other_layouts(clustered):
    idx, _, _, _, _ = clustered
    bad_rows = idx.doc_rows.copy()
    t = int(np.argmax(np.diff(idx.offsets)))
    s = int(idx.offsets[t])
    bad_rows[s], bad_rows[s + 1] = bad_rows[s + 1], bad_rows[s]
    idx2 = SparseIndex(idx.offsets, bad_rows, idx.values, idx.doc_ids, V)
    with pytest.raises(ValueError, match="doc-sorted"):
        port.BlockMaxSegsortEngine(idx2, topk=10, device="cpu")
    for val_dtype in ("bf16", "q8"):
        with pytest.raises(ValueError, match="f32"):
            port.BlockMaxSegsortEngine(idx, topk=10, val_dtype=val_dtype,
                                       device="cpu")


def test_device_csr_requires_meta_and_matches_host_engine(clustered):
    """Over flat arrays already on the device the engine needs meta=; with
    the meta computed from those tensors it returns the host engine's
    results bit for bit."""
    idx, _, qt, qv, _ = clustered
    rows = torch.from_numpy(np.concatenate(
        [idx.doc_rows, np.full(CHUNK, N_DOCS, np.int32)]))
    bits = torch.from_numpy(np.concatenate(
        [idx.values, np.zeros(CHUNK, np.float32)]).view(np.int32))
    csr = (rows, bits, idx.offsets, N_DOCS)
    with pytest.raises(ValueError, match="meta"):
        port.BlockMaxSegsortEngine(None, topk=20, device_csr=csr)
    meta = port.build_chunk_meta(idx.offsets, rows, bits.view(torch.float32))
    dev_eng = port.BlockMaxSegsortEngine(None, topk=20, query_terms_budget=TB,
                                         cover=8.0, gate=0.95, meta=meta,
                                         device_csr=csr)
    host_eng = port.BlockMaxSegsortEngine(idx, topk=20, query_terms_budget=TB,
                                          cover=8.0, gate=0.95, device="cpu")
    a = dev_eng.finalize(dev_eng.retrieve_tile_async(None, 20,
                                                     sparsified=(qt, qv)))
    b = host_eng.finalize(host_eng.retrieve_tile_async(None, 20,
                                                       sparsified=(qt, qv)))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert dev_eng.stats()["pruned_tiles"] == 1


def test_staged_driver_equals_collapsed_finalize(clustered):
    """staged_pipeline (continue_async between dispatch and the final
    read) gives what finalize of the raw payload gives, tile by tile."""
    idx, _, qt, qv, _ = clustered
    tiles = [(qt[i:i + 2], qv[i:i + 2]) for i in range(0, 6, 2)]
    tiles.append((qt[:3], np.zeros_like(qv[:3])))        # all-empty tile

    def run(staged):
        eng = port.BlockMaxSegsortEngine(idx, topk=15, query_terms_budget=TB,
                                         cover=1.5, gate=0.99, device="cpu")
        out = []

        def dispatch(t):
            return eng.retrieve_tile_async(None, 15, sparsified=t)

        def drain(p):
            out.append(eng.finalize(p))

        if staged:
            staged_pipeline(tiles, dispatch, eng.continue_async, drain)
        else:
            depth2_pipeline(tiles, dispatch, drain)
        return out, eng.stats()

    staged, st1 = run(True)
    collapsed, st2 = run(False)
    assert st1["pass2_tiles"] >= 1
    assert {k: v for k, v in st1.items() if k != "host_ms"} == \
        {k: v for k, v in st2.items() if k != "host_ms"}
    for (s1, r1), (s2, r2) in zip(staged, collapsed):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(r1, r2)


def test_chip_smoke_clustered_corpus_matches_bench_bmx():
    """benches/corpora.py keeps a torch copy of bench_bmx.py's clustered
    corpus, which chip_smoke.py imports (neither may import JAX nor the
    JAX package): the same offsets,
    postings bit for bit and query tiles at a small configuration, meta
    from its tensors within bench_bmx's closed-form bound, and the
    block-max engine over that device_csr equal to the unpruned engine
    (bench_bmx's cross_check) with pruning engaged."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import bench_bmx
    import chip_smoke
    from scaling_retriever_tpu_torch.benches import corpora

    assert chip_smoke.make_cfg is corpora.make_cfg

    kw = dict(C=32, S=2560, PT=8, L_IN=2048, L_BG=1024, V_G=64, L_G=8192,
              n_topic_q=4, n_generic_q=4)
    cfg = corpora.make_cfg(**kw)
    want = bench_bmx.make_cfg(**kw, k=50)
    np.testing.assert_array_equal(cfg["offsets"], want["offsets"])
    p = np.arange(cfg["NNZ"], dtype=np.int64)
    doc, val, _, _ = bench_bmx.decode(np, p, want)
    rows, bits = corpora.gen_device_csr(cfg, torch.device("cpu"))
    np.testing.assert_array_equal(rows[:cfg["NNZ"]].numpy(), doc)
    np.testing.assert_array_equal(
        bits[:cfg["NNZ"]].view(torch.float32).numpy(), val)
    assert (rows[cfg["NNZ"]:] == cfg["N"]).all()
    for a, b in zip(corpora.make_tiles(cfg, np.random.default_rng(0), 2,
                                       tile=8, t_budget=16),
                    bench_bmx.make_tiles(want, np.random.default_rng(0), 2,
                                         tile=8, t_budget=16)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    meta = port.build_chunk_meta(cfg["offsets"], rows,
                                 bits.view(torch.float32))
    closed = bench_bmx.analytic_meta(want)
    for key in ("term_chunk_offset", "sub_lo", "sub_hi"):
        np.testing.assert_array_equal(meta[key], closed[key])
    assert (closed["sub_max"] - meta["sub_max"] > -1e-6).all()

    csr = (rows, bits, cfg["offsets"], cfg["N"])
    base = SegsortEngine(topk=50, query_terms_budget=16, device_csr=csr)
    bmx = port.BlockMaxSegsortEngine(None, topk=50, query_terms_budget=16,
                                     meta=meta, device_csr=csr)
    tiles = corpora.make_tiles(cfg, np.random.default_rng(0), 2, tile=8,
                               t_budget=16)
    out = {}
    for name, eng, staged in (("base", base, False), ("bmx", bmx, True)):
        res = []

        def dispatch(t, eng=eng):
            return eng.retrieve_tile_async(None, 50, sparsified=t)

        def drain(pl, eng=eng, res=res):
            res.append(eng.finalize(pl))

        if staged:
            staged_pipeline(tiles, dispatch, eng.continue_async, drain)
        else:
            depth2_pipeline(tiles, dispatch, drain)
        out[name] = [np.concatenate(x) for x in zip(*res)]
    corpora.cross_check(*out["bmx"], *out["base"])
    st = bmx.stats()
    assert st["pruned_tiles"] > 0 and st["mean_kept_frac"] < 0.6, st
