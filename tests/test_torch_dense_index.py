"""The port's dense index (scaling_retriever_tpu_torch/index/dense_index.py)
against the JAX package's on the same numpy inputs.

Tolerances: int8 quantization, ``_score_slab`` and the serialized files are
bit-equal; the chunked and blocked searches run on dyadic data (every
product and sum exact in f32 in any order), so scores and certificates are
bit-equal and rows tie-equal (``torch.topk`` documents no tie order).
"""

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index import dense_index as ref
from scaling_retriever_tpu_torch.index import dense_index as port
from scaling_retriever_tpu_torch.parallel.mesh import make_mesh
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

torch.set_num_threads(1)


def _dyadic(rng, shape, lo=-64, hi=65, den=16.0):
    return (rng.integers(lo, hi, shape) / den).astype(np.float32)


def _rows_tie_equal(rows_a, scores_a, rows_b, scores_b):
    for i in range(len(rows_a)):
        tie_equal_topk(rows_a[i], scores_a[i], rows_b[i], scores_b[i],
                       rtol=0.0)


def test_int8_quantization_bit_equal():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((64, 48)).astype(np.float32)
    v[3] = 0.0                                    # a zero row: scale 1
    v[5, :4] = [127.0, 63.5, -0.5, 1.5]           # halves: rint to even
    v[5, 4:] = 0.0
    want_c, want_s = ref.quantize_embeddings_int8(v)
    got_c, got_s = port.quantize_embeddings_int8(v)
    assert got_c.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_c, want_c)
    assert got_s.tobytes() == want_s.tobytes()
    assert want_s[3] == 1.0 and (want_c[3] == 0).all()
    qc, qs = ref._quantize_queries_int8(v)
    tc, ts = port._quantize_queries_int8(torch.from_numpy(v))
    np.testing.assert_array_equal(tc.numpy(), qc)
    assert ts.numpy().tobytes() == qs.tobytes()


def test_score_slab_bit_equal():
    rng = np.random.default_rng(1)
    q = _dyadic(rng, (5, 32))
    d = _dyadic(rng, (40, 32))
    want = np.asarray(ref._score_slab(jnp.asarray(q), jnp.asarray(d),
                                      None, None))
    got = port._score_slab(torch.from_numpy(q), torch.from_numpy(d), None,
                           None).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    # bf16 docs and queries: f32 output on the same exact values
    got16 = port._score_slab(torch.from_numpy(q).bfloat16(),
                             torch.from_numpy(d).bfloat16(), None, None)
    assert got16.dtype == torch.float32
    assert got16.numpy().tobytes() == want.tobytes()
    # int8: the s32 dot then the scale outer product, 5 query rows padded
    # for the product and sliced off
    v = rng.standard_normal((40, 32)).astype(np.float32)
    qv = rng.standard_normal((5, 32)).astype(np.float32)
    codes, sc = ref.quantize_embeddings_int8(v)
    qc, qs = ref._quantize_queries_int8(qv)
    want8 = np.asarray(ref._score_slab(jnp.asarray(qc), jnp.asarray(codes),
                                       jnp.asarray(qs), jnp.asarray(sc)))
    got8 = port._score_slab(torch.from_numpy(qc), torch.from_numpy(codes),
                            torch.from_numpy(qs), torch.from_numpy(sc))
    assert got8.shape == (5, 40)
    assert got8.numpy().tobytes() == want8.tobytes()


def _layouts(rng, n, d, nq, quantize):
    docs = _dyadic(rng, (n, d))
    q = _dyadic(rng, (nq, d))
    if quantize:
        codes, sd = ref.quantize_embeddings_int8(docs)
        qc, qs = ref._quantize_queries_int8(q)
        return codes, qc, sd, qs
    return docs, q, None, None


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_search_chunked_and_blocked_match_reference(quantize):
    """test_index.py's sizes: 1024 x 16 docs, chunk 256, block 128, m 4,
    k 9; the JAX blocked search with its kernel in interpret mode."""
    rng = np.random.default_rng(22)
    docs, q, sd, qs = _layouts(rng, 1024, 16, 8, quantize)
    j = dict(doc_scales=None if sd is None else jnp.asarray(sd),
             q_scale=None if qs is None else jnp.asarray(qs))
    t = dict(doc_scales=None if sd is None else torch.from_numpy(sd),
             q_scale=None if qs is None else torch.from_numpy(qs))
    kw = dict(k=9, chunk=256)
    ws, wr = ref._search_chunked(jnp.asarray(docs), jnp.asarray(q), **kw, **j)
    gs, gr = port._search_chunked(torch.from_numpy(docs), torch.from_numpy(q),
                                  **kw, **t)
    assert gr.dtype == torch.int32
    assert gs.numpy().tobytes() == np.asarray(ws).tobytes()
    _rows_tie_equal(gr.numpy(), gs.numpy(), np.asarray(wr), np.asarray(ws))

    bkw = dict(kw, m=4, block=128)
    ws, wr, wok = ref._search_chunked_blocked(
        jnp.asarray(docs), jnp.asarray(q), topm="pallas_interpret", **bkw, **j)
    for topm in ("pallas", "pallas_interpret", "xla"):
        gs, gr, gok = port._search_chunked_blocked(
            torch.from_numpy(docs), torch.from_numpy(q), topm=topm, **bkw,
            **t)
        assert gs.numpy().tobytes() == np.asarray(ws).tobytes(), topm
        np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
        _rows_tie_equal(gr.numpy(), gs.numpy(), np.asarray(wr),
                        np.asarray(ws))
    # the chunks given as a list are the same search
    chunks = list(torch.from_numpy(docs).split(256))
    ls, _, lok = port._search_chunked_blocked(
        chunks, torch.from_numpy(q), topm="pallas", **bkw,
        **dict(t, doc_scales=None if sd is None
               else list(t["doc_scales"].split(256))))
    assert torch.equal(ls, gs) and torch.equal(lok, gok)
    with pytest.raises(ValueError, match="topm"):
        port._search_chunked_blocked(torch.from_numpy(docs),
                                     torch.from_numpy(q), topm="nope",
                                     **bkw, **t)


def _indexers(docs, ids, **kw):
    ref_kw = dict(kw)
    if "dtype" in ref_kw:
        ref_kw["dtype"] = {torch.float32: jnp.float32,
                           torch.bfloat16: jnp.bfloat16}[ref_kw["dtype"]]
    mine = port.DenseFlatIndexer(device="cpu", **kw)
    theirs = ref.DenseFlatIndexer(**ref_kw)
    for ix in (mine, theirs):
        ix.init_index(docs.shape[1])
        ix.index_data(list(zip(ids[:50], docs[:50])))
        ix.add_batch(ids[50:], docs[50:])
    return mine, theirs


def _same_results(got, want):
    assert len(got) == len(want)
    for (gi, gs), (wi, ws) in zip(got, want):
        assert np.asarray(gs, np.float32).tobytes() == \
            np.asarray(ws, np.float32).tobytes()
        tie_equal_topk(gi, gs, wi, ws, rtol=0.0)


LAYOUTS = [("f32", torch.float32, None), ("bf16", torch.bfloat16, None),
           ("int8", torch.bfloat16, "int8")]


@pytest.mark.parametrize("name,dtype,quantize", LAYOUTS,
                         ids=[x[0] for x in LAYOUTS])
def test_flat_indexer_search_knn_matches_reference(name, dtype, quantize):
    """Blocked (auto) and direct selection over 2 chunks, with ragged query
    tiles (10 queries in tiles of 4: the last is padded with zero rows)."""
    rng = np.random.default_rng(33)
    n, d, nq, k = 1000, 16, 10, 12
    docs = _dyadic(rng, (n, d))
    queries = _dyadic(rng, (nq, d))
    ids = [f"doc{i}" for i in range(n)]
    for selection in ("auto", "direct"):
        mine, theirs = _indexers(docs, ids, dtype=dtype, quantize=quantize,
                                 chunk=512, sel_block=128, block_m=8,
                                 query_tile=4, selection=selection)
        assert mine.ntotal == theirs.ntotal == n
        assert mine._blocked(k) == (selection == "auto")
        _same_results(mine.search_knn(queries, k),
                      theirs.search_knn(queries, k))
        assert mine.fallbacks == theirs.fallbacks
    # a top_docs above ntotal is cut to it; padding rows (score 0) take
    # places in the top-k as in the reference, but never come back
    got = mine.search_knn(queries[:2], 5000)
    _same_results(got, theirs.search_knn(queries[:2], 5000))
    assert all(0 < len(g[0]) <= n and len(set(g[0])) == len(g[0])
               for g in got)


def test_forced_certificate_failure_reruns_exactly():
    """A block holding near-copies of the query: its m-th value beats the
    merged k-th, the tile reruns on the direct path, and the results are
    the exact top-k (equal to the reference, which reruns too)."""
    rng = np.random.default_rng(5)
    n, d, k = 2048, 16, 12
    docs = _dyadic(rng, (n, d), -8, 9)
    queries = _dyadic(rng, (3, d), -8, 9)
    docs[64:64 + 40] = queries[1] + _dyadic(rng, (40, d), -1, 2, 64.0)
    ids = [f"doc{i}" for i in range(n)]
    mine, theirs = _indexers(docs, ids, dtype=torch.float32, chunk=512,
                             sel_block=64, block_m=4, query_tile=8)
    got = mine.search_knn(queries, k)
    _same_results(got, theirs.search_knn(queries, k))
    assert mine.fallbacks == theirs.fallbacks == 1
    exact = queries @ docs.T
    for qi, (gi, gs) in enumerate(got):
        order = np.argsort(-exact[qi], kind="stable")[:k]
        tie_equal_topk(gi, gs, [ids[r] for r in order], exact[qi][order],
                       rtol=0.0)


def test_dispatch_drain_and_tile_results():
    """The async protocol the serving backend uses: a ragged tile whose
    padded rows would fail the certificate does not fall back."""
    rng = np.random.default_rng(6)
    docs = _dyadic(rng, (512, 16))
    ids = [f"d{i}" for i in range(512)]
    mine, _ = _indexers(docs, ids, dtype=torch.float32, chunk=256,
                        sel_block=128, block_m=8)
    q = np.zeros((8, 16), np.float32)
    q[:3] = _dyadic(rng, (3, 16))
    scores, rows = mine.drain_tile(mine.dispatch_tile(q, 5), 3)
    assert scores.shape == rows.shape == (8, 5) and mine.fallbacks == 0
    hits = mine.tile_results(scores, rows, 3)
    assert len(hits) == 3
    for qi, (hid, hs) in enumerate(hits):
        want = np.argsort(-(docs @ q[qi]), kind="stable")[:5]
        tie_equal_topk(hid, hs, [ids[r] for r in want],
                       (docs @ q[qi])[want], rtol=0.0)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_serialize_deserialize_across_packages(tmp_path, direction):
    rng = np.random.default_rng(7)
    docs = rng.standard_normal((300, 24)).astype(np.float32)
    ids = [f"d{i}" for i in range(300)]
    mine, theirs = _indexers(docs, ids, dtype=torch.float32, chunk=128)
    a, b = tmp_path / "a", tmp_path / "b"
    writer, reader_cls = ((theirs, lambda: port.DenseFlatIndexer(
        device="cpu", chunk=128, dtype=torch.float32))
        if direction == "ref_to_port" else
        (mine, lambda: ref.DenseFlatIndexer(chunk=128, dtype=jnp.float32)))
    writer.serialize(str(a))
    reader = reader_cls()
    reader.deserialize(str(a))
    assert reader.ntotal == 300
    assert reader.index_id_to_db_id == ids
    reader.serialize(str(b))
    # each npz member's bytes (the zip headers carry a timestamp) and the
    # id list's bytes are the same
    for name in (port.DenseFlatIndexer.INDEX_FILE,):
        with zipfile.ZipFile(a / name) as za, zipfile.ZipFile(b / name) as zb:
            assert za.namelist() == zb.namelist() == ["vectors.npy",
                                                      "vector_sz.npy"]
            for member in za.namelist():
                assert za.read(member) == zb.read(member)
    meta = port.DenseFlatIndexer.META_FILE
    assert (a / meta).read_bytes() == (b / meta).read_bytes()
    with open(a / meta) as f:
        assert json.load(f) == ids
    np.testing.assert_array_equal(np.load(a / port.DenseFlatIndexer.INDEX_FILE)
                                  ["vectors"], docs)


def test_store_is_chunked_in_place_and_layout_follows():
    """Vectors land in [chunk, D] chunks with a zero tail; a bf16 tensor is
    kept as bf16 and serialized as its f32 widening; switching ``quantize``
    rebuilds the layout from the same store; mixed dtypes and widths
    raise."""
    rng = np.random.default_rng(8)
    v = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    ix = port.DenseFlatIndexer(device="cpu", chunk=128)
    ix.init_index(8)
    ix.add_batch(range(300), v.bfloat16())
    assert len(ix._store) == 3 and ix._store[0].dtype == torch.bfloat16
    assert (ix._store[2][300 - 256:] == 0).all()
    assert ix._materialize()[0] is ix._store[0]     # bf16 layout = the store
    assert np.array_equal(ix._host_vectors(), v.bfloat16().float().numpy())
    ix.quantize = "int8"
    codes = ix._materialize()
    want_c, want_s = ref.quantize_embeddings_int8(
        np.pad(v.bfloat16().float().numpy(), ((0, 84), (0, 0))))
    np.testing.assert_array_equal(torch.cat(codes).numpy(), want_c)
    np.testing.assert_array_equal(torch.cat(ix._layout[2]).numpy(), want_s)
    with pytest.raises(ValueError, match="store"):
        ix.add_batch([0], v[:1])
    with pytest.raises(ValueError, match="width"):
        ix.add_batch([0], torch.zeros(1, 9, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="ids"):
        ix.add_batch([0, 1], v[:1].bfloat16())
    # the store's chunks as two shards of a two-entry mesh (rows past 300
    # are the zero tail, row id -1): the direct search over the whole
    # store, scores bit-equal and ids tie-equal
    q = v[:4].bfloat16()
    ids = torch.arange(384)
    ids = torch.where(ids < 300, ids, -1)
    got_s, got_r = port.make_sharded_dense_search(
        make_mesh(devices=["cpu"] * 2), "data", k=10, chunk=128)(
        [ix._store[:2], ix._store[2:]], [ids[:256], ids[256:]], q)
    want_s, want_r = port._search_chunked(ix._store, q, k=10, chunk=128)
    np.testing.assert_array_equal(got_s.numpy(), want_s.numpy())
    for i in range(4):
        tie_equal_topk(want_r[i].tolist(), want_s[i].tolist(),
                       got_r[i].tolist(), got_s[i].tolist(), rtol=0.0)


def test_default_device_is_cuda_without_fallback():
    """Built with the default device, the index puts its layout on CUDA
    (numpy rows stay in a host store): on a machine without it the first
    search raises rather than running on the CPU."""
    ix = port.DenseFlatIndexer()
    assert ix.device.type == "cuda"
    ix.init_index(8)
    ix.add_batch([0], np.ones((1, 8), np.float32))
    assert ix._store[0].device.type == "cpu"
    if torch.cuda.is_available():
        assert ix._materialize()[0].device.type == "cuda"
        ix.add_batch([1], torch.ones(1, 8, device="cuda"))
        assert ix._store[0].device.type == "cpu"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        ix.search_knn(np.ones((1, 8), np.float32), 1)


def test_host_store_keeps_numpy_chunks_and_builds_layout_by_rows(
        monkeypatch):
    """Numpy rows stay on the host: full chunks of the added array are kept
    as views, the partial tail is copied into a zeroed chunk, and the
    layout on the index's device (here the meta device, as a card would
    be) is built from them; on the CPU the bf16 and int8 layouts, built
    MOVE_ROWS rows at a time, equal a cast and the reference's
    quantization of the padded rows, bit for bit."""
    monkeypatch.setattr(port, "MOVE_ROWS", 48)
    rng = np.random.default_rng(9)
    v = rng.standard_normal((300, 8)).astype(np.float32)
    meta = port.DenseFlatIndexer(device="meta", chunk=128)
    meta.init_index(8)
    meta.add_batch(range(300), v)
    assert [b.device.type for b in meta._store] == ["cpu"] * 3
    assert all(np.shares_memory(meta._store[c].numpy(), v) for c in (0, 1))
    assert not np.shares_memory(meta._store[2].numpy(), v)
    layout = meta._materialize()
    assert [(b.device.type, b.dtype, tuple(b.shape)) for b in layout] == [
        ("meta", torch.bfloat16, (128, 8))] * 3
    meta.quantize = "int8"
    assert {b.device.type for b in meta._materialize() + meta._layout[2]} \
        == {"meta"}

    ix = port.DenseFlatIndexer(device="cpu", chunk=128)
    ix.init_index(8)
    ix.add_batch(range(300), v)
    padded = np.pad(v, ((0, 84), (0, 0)))
    assert np.array_equal(ix._host_vectors(), v)
    got = torch.cat(ix._materialize())
    assert torch.equal(got, torch.from_numpy(padded).bfloat16())
    ix.quantize = "int8"
    want_c, want_s = ref.quantize_embeddings_int8(padded)
    np.testing.assert_array_equal(torch.cat(ix._materialize()).numpy(),
                                  want_c)
    assert torch.cat(ix._layout[2]).numpy().tobytes() == want_s.tobytes()


@pytest.mark.parametrize("store", ["f32_host", "bf16"])
def test_serialize_streams_the_store_without_a_second_copy(tmp_path, store):
    """``serialize`` writes the vectors member chunk by chunk: numpy's
    allocations (tracemalloc) stay under a quarter of the store while it
    runs (concatenating the chunks first, as before, allocates the whole
    store again); the file has np.savez's members, dtypes and shapes, and
    loads in the reference and back."""
    import tracemalloc

    rng = np.random.default_rng(10)
    n, d, chunk = 6000, 96, 1024             # a 2.3 MB store, 6 chunks
    v = rng.standard_normal((n, d)).astype(np.float32)
    ix = port.DenseFlatIndexer(device="cpu", chunk=chunk)
    ix.init_index(d)
    ids = [f"d{i}" for i in range(n)]
    ix.add_batch(ids, v if store == "f32_host"
                 else torch.from_numpy(v).bfloat16())
    want = ix._host_vectors()
    tracemalloc.start()
    try:
        ix.serialize(str(tmp_path / "s"))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < v.nbytes / 4, (peak, v.nbytes)
    path = tmp_path / "s" / port.DenseFlatIndexer.INDEX_FILE
    with np.load(path) as z:
        assert z.files == ["vectors", "vector_sz"]
        assert z["vectors"].dtype == np.float32 and z["vectors"].shape == (
            n, d)
        assert z["vector_sz"].dtype == np.int64 and int(z["vector_sz"]) == d
        np.testing.assert_array_equal(z["vectors"], want)
    np.savez(tmp_path / "plain.npz", vectors=want, vector_sz=np.int64(d))
    with zipfile.ZipFile(path) as za, \
            zipfile.ZipFile(tmp_path / "plain.npz") as zb:
        for member in ("vectors.npy", "vector_sz.npy"):
            assert za.read(member) == zb.read(member)
    theirs = ref.DenseFlatIndexer(chunk=chunk, dtype=jnp.float32)
    theirs.deserialize(str(tmp_path / "s"))
    assert theirs.ntotal == n and theirs.index_id_to_db_id == ids
    theirs.serialize(str(tmp_path / "r"))
    back = port.DenseFlatIndexer(device="cpu", chunk=chunk,
                                 dtype=torch.float32)
    back.deserialize(str(tmp_path / "r"))
    np.testing.assert_array_equal(back._host_vectors(), want)
    # an empty index writes a [0, D] member
    empty = port.DenseFlatIndexer(device="cpu", chunk=chunk)
    empty.init_index(d)
    empty.serialize(str(tmp_path / "e"))
    with np.load(tmp_path / "e" / port.DenseFlatIndexer.INDEX_FILE) as z:
        assert z["vectors"].shape == (0, d)
