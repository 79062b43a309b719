"""The port's sharded entry points against the JAX package's on its
8-device CPU mesh: a port mesh is a list of torch devices, here
``["cpu"] * 8`` (or ``* 4`` where the JAX test takes ``devices[:4]``).

Covered: ``make_sharded_retrieve``, ``make_sharded_dense_search`` (f32,
bf16, int8), ``ShardedSegsortEngine`` (every shard dispatched before any
read), ``SparseRetrieval(mesh=)`` on the "xla" and "segsort" engines, the
sharded engine served through ``RetrievalServer``, the partition specs of
``parallel/partitioning.py`` at tiny and at published Llama widths, the
runtime helpers of ``utils/utils.py`` and the cls-token collator.

Tolerances. Sparse: dyadic values, scores bit-equal and rows equal (each
doc carries a value of its own on term 0, so no two docs tie; the merge is
a stable sort, as ``lax.top_k`` keeps the lower index). Dense: dyadic f32,
bit-equal; bf16 (no unique column fits its 8 bits) scores bit-equal and
ids tie-equal; int8 codes exact, bit-equal.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_tiny_tokenizer  # noqa: E402
from test_retrieval_drivers import V as DRV_V  # noqa: E402
from test_retrieval_drivers import FakeSparseEncoder, _batches  # noqa: E402

from scaling_retriever_tpu.data import collators as ref_collators  # noqa: E402
from scaling_retriever_tpu.index import dense_index as ref_dense  # noqa: E402
from scaling_retriever_tpu.index import sparse_retrieval as ref_sr  # noqa: E402
from scaling_retriever_tpu.index.indexer import SparseIndexer  # noqa: E402
from scaling_retriever_tpu.index.inverted_index import \
    SparseIndex as RefIndex  # noqa: E402
from scaling_retriever_tpu.models import llama as ref_llama  # noqa: E402
from scaling_retriever_tpu.models.config import \
    ModelConfig as RefConfig  # noqa: E402
from scaling_retriever_tpu.ops import segsort_scoring as ref_seg  # noqa: E402
from scaling_retriever_tpu.ops import sparse_scoring as ref_ss  # noqa: E402
from scaling_retriever_tpu.parallel import partitioning as ref_part  # noqa: E402
from scaling_retriever_tpu.serving import server as ref_server  # noqa: E402
from scaling_retriever_tpu.utils import utils as ref_utils  # noqa: E402
from scaling_retriever_tpu_torch.data import collators  # noqa: E402
from scaling_retriever_tpu_torch.index import dense_index  # noqa: E402
from scaling_retriever_tpu_torch.index import sparse_retrieval  # noqa: E402
from scaling_retriever_tpu_torch.index.inverted_index import \
    SparseIndex  # noqa: E402
from scaling_retriever_tpu_torch.models.config import ModelConfig  # noqa: E402
from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP  # noqa: E402
from scaling_retriever_tpu_torch.models.weights import params_from_jax  # noqa: E402
from scaling_retriever_tpu_torch.ops import segsort_scoring as seg  # noqa: E402
from scaling_retriever_tpu_torch.ops import sparse_scoring  # noqa: E402
from scaling_retriever_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from scaling_retriever_tpu_torch.parallel import partitioning as part  # noqa: E402
from scaling_retriever_tpu_torch.serving.server import (  # noqa: E402
    RetrievalServer, SparseTileBackend,
)
from scaling_retriever_tpu_torch.utils import utils  # noqa: E402
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk  # noqa: E402

torch.set_num_threads(1)

V = 64
N_DOCS = 150


def _cpu_mesh(n):
    return mesh_lib.make_mesh(devices=["cpu"] * n)


def _jax_mesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _triples(seed):
    """Docs of 1-11 terms, values k/4; term 0 holds (d + 1) / 4096 in every
    doc d, below the others' 1/16 grid, so every score is distinct and
    exact in f32 for queries that weigh term 0 by 1."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for d in range(N_DOCS):
        nnz = int(rng.integers(1, 12))
        rows += [d] * (nnz + 1)
        cols += [0] + rng.choice(np.arange(1, V), size=nnz,
                                 replace=False).tolist()
        vals += [(d + 1) / 4096.0] + (rng.integers(1, 8, nnz) / 4.0).tolist()
    return np.array(rows), np.array(cols), np.array(vals, np.float32)


@pytest.fixture(scope="module")
def indexes():
    r, c, v = _triples(0)
    ids = [f"d{i}" for i in range(N_DOCS)]
    return (SparseIndex.from_triples(r, c, v, ids, V),
            RefIndex.from_triples(r, c, v, ids, V))


def _queries(seed, nq, n_terms=6):
    rng = np.random.default_rng(seed)
    q = np.zeros((nq, V), np.float32)
    for i in range(nq):
        q[i, rng.choice(np.arange(1, V), size=n_terms, replace=False)] = \
            rng.integers(1, 8, n_terms) / 4.0
    q[:, 0] = 1.0
    return q


def _brute(idx: SparseIndex, q):
    dense = np.zeros((idx.nb_docs(), V), np.float32)
    for t in range(V):
        s, e = idx.offsets[t], idx.offsets[t + 1]
        dense[idx.doc_rows[s:e], t] = idx.values[s:e]
    return q @ dense.T


# ---- the doc-sharded scan ---------------------------------------------

@pytest.mark.parametrize("k", [7, 40])
def test_make_sharded_retrieve_matches_reference(indexes, k):
    mine, theirs = indexes
    q = _queries(1, 4)
    block, n_dev = 8, 8
    terms, vals = theirs.to_doc_major()
    n = terms.shape[0]
    n_pad = -(-n // (block * n_dev)) * block * n_dev
    terms = np.pad(terms, ((0, n_pad - n), (0, 0)))
    vals = np.pad(vals, ((0, n_pad - n), (0, 0)))
    row_ids = np.arange(n_pad, dtype=np.int32)
    fn = ref_ss.make_sharded_retrieve(_jax_mesh(n_dev), "data", k=k,
                                      block=block)
    want_s, want_r = fn(jnp.asarray(terms), jnp.asarray(vals),
                        jnp.asarray(row_ids), jnp.asarray(q.T))
    mt, mv = mine.to_doc_major()
    np.testing.assert_array_equal(mt, terms[:n])
    per = n_pad // n_dev
    mt = torch.from_numpy(np.pad(mt, ((0, n_pad - n), (0, 0))))
    mv = torch.from_numpy(np.pad(mv, ((0, n_pad - n), (0, 0))))
    got_s, got_r = sparse_scoring.make_sharded_retrieve(
        _cpu_mesh(n_dev), "data", k=k, block=block)(
        [mt[i * per:(i + 1) * per] for i in range(n_dev)],
        [mv[i * per:(i + 1) * per] for i in range(n_dev)],
        [torch.arange(i * per, (i + 1) * per) for i in range(n_dev)],
        torch.from_numpy(np.ascontiguousarray(q.T)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    want = _brute(mine, q)
    np.testing.assert_array_equal(
        got_s.numpy(), -np.sort(-np.pad(want, ((0, 0), (0, n_pad - n))),
                                axis=1)[:, :k])


def test_merge_shards_is_stable():
    """Equal scores keep the lower position of [shard 0 | shard 1 | ...],
    as lax.top_k over the reference's all-gather does."""
    s = [torch.tensor([[3.0, 1.0]]), torch.tensor([[3.0, 2.0]]),
         torch.tensor([[1.0, 0.0]])]
    r = [torch.tensor([[10, 11]]), torch.tensor([[20, 21]]),
         torch.tensor([[30, 31]])]
    top_s, top_r = sparse_scoring.merge_shards(s, r, 4, torch.device("cpu"))
    assert top_s.tolist() == [[3.0, 3.0, 2.0, 1.0]]
    assert top_r.tolist() == [[10, 20, 21, 11]]
    want_s, want_i = jax.lax.top_k(jnp.asarray(torch.cat(s, 1).numpy()), 4)
    assert top_s.tolist() == np.asarray(want_s).tolist()
    assert top_r.tolist() == torch.cat(r, 1).numpy()[
        0, np.asarray(want_i)[0]][None].tolist()


# ---- the doc-sharded dense search --------------------------------------

def _dense_data(dtype, n, d, nq, seed):
    """Dyadic rows (halves in [-2, 2]); under f32 column 0 holds (row + 1)
    / 8192 and queries weigh it by 1, so every score is distinct."""
    rng = np.random.default_rng(seed)
    docs = (rng.integers(-4, 5, (n, d)) / 2.0).astype(np.float32)
    queries = (rng.integers(-4, 5, (nq, d)) / 2.0).astype(np.float32)
    if dtype == "f32":
        docs[:, 0] = (np.arange(n) + 1) / 8192.0
        queries[:, 0] = 1.0
    return docs, queries


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sharded_dense_search_matches_reference(dtype):
    n_dev, n, d, nq, k, chunk = 8, 8 * 64 * 3, 16, 5, 7, 64
    docs, queries = _dense_data(dtype, n, d, nq, 3)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    mesh = _jax_mesh(n_dev)
    sh = JNamedSharding(mesh, P("data"))
    fn = ref_dense.make_sharded_dense_search(mesh, "data", k=k, chunk=chunk)
    want_s, want_r = fn(jax.device_put(jnp.asarray(docs, jdt), sh),
                        jax.device_put(jnp.arange(n, dtype=jnp.int32), sh),
                        jnp.asarray(queries, jdt))
    want_s, want_r = np.asarray(want_s), np.asarray(want_r)
    per = n // n_dev
    t_docs = torch.from_numpy(docs).to(tdt)
    # one shard as a tensor, the others as lists of their chunks
    shards = [t_docs[i * per:(i + 1) * per] if i == 0
              else list(t_docs[i * per:(i + 1) * per].split(chunk))
              for i in range(n_dev)]
    got_s, got_r = dense_index.make_sharded_dense_search(
        _cpu_mesh(n_dev), "data", k=k, chunk=chunk)(
        shards, [torch.arange(i * per, (i + 1) * per)
                 for i in range(n_dev)],
        torch.from_numpy(queries).to(tdt))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    if dtype == "f32":
        np.testing.assert_array_equal(got_r.numpy(), want_r)
    else:
        for i in range(nq):
            tie_equal_topk(want_r[i].tolist(), want_s[i].tolist(),
                           got_r[i].tolist(), got_s[i].numpy().tolist(),
                           rtol=0.0)
    want = queries @ docs.T
    np.testing.assert_array_equal(got_s.numpy(),
                                  -np.sort(-want, axis=1)[:, :k])


def test_sharded_dense_search_int8_matches_reference():
    rng = np.random.default_rng(41)
    n_dev, n, d, nq, k, block = 8, 8 * 8 * 4, 16, 5, 7, 8
    docs = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    codes, sd = ref_dense.quantize_embeddings_int8(docs)
    qc, qs = ref_dense._quantize_queries_int8(queries)
    fn = ref_dense.make_sharded_dense_search(_jax_mesh(n_dev), "data", k=k,
                                             chunk=block, quantize="int8")
    want_s, want_r = fn(jnp.asarray(codes), jnp.arange(n, dtype=jnp.int32),
                        jnp.asarray(sd), jnp.asarray(qc), jnp.asarray(qs))
    per = n // n_dev
    tc, ts = torch.from_numpy(codes), torch.from_numpy(sd)
    # pad rows: the last shard's final chunk zeroed, row id -1
    row_ids = [torch.arange(i * per, (i + 1) * per) for i in range(n_dev)]
    got_s, got_r = dense_index.make_sharded_dense_search(
        _cpu_mesh(n_dev), "data", k=k, chunk=block, quantize="int8")(
        [tc[i * per:(i + 1) * per] for i in range(n_dev)], row_ids,
        [ts[i * per:(i + 1) * per] for i in range(n_dev)],
        torch.from_numpy(qc), torch.from_numpy(qs))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def test_sharded_dense_pad_rows_map_to_minus_one():
    """A shard with fewer real rows than k: its pad rows (id -1) and
    unfilled slots stay -1 after the merge."""
    docs = torch.zeros((2 * 4, 2))
    docs[0] = torch.tensor([1.0, 0.0])
    docs[4] = torch.tensor([2.0, 0.0])
    row_ids = [torch.tensor([0, -1, -1, -1]), torch.tensor([1, -1, -1, -1])]
    s, r = dense_index.make_sharded_dense_search(
        _cpu_mesh(2), "data", k=6, chunk=4)(
        [docs[:4], docs[4:]], row_ids, torch.tensor([[1.0, 0.0]]))
    assert r[0, :2].tolist() == [1, 0] and s[0, :2].tolist() == [2.0, 1.0]
    assert (r[0, 2:] == -1).all()


# ---- the sharded segsort engine ---------------------------------------

@pytest.mark.parametrize("val_dtype", ["f32", "bf16"])
def test_sharded_segsort_engine_matches_reference(indexes, val_dtype,
                                                  monkeypatch):
    mine, theirs = indexes
    nq, k = 4, 9
    q = _queries(2, nq, n_terms=10)
    sharded = seg.ShardedSegsortEngine(mine, ["cpu"] * 4, topk=k,
                                       query_terms_budget=16,
                                       min_budget=256, val_dtype=val_dtype)
    assert [e.n_docs for e in sharded.shards] == [38, 38, 38, 36]
    dispatched = []
    orig_async = seg.SegsortEngine.retrieve_tile_async

    def spy_async(self, qd, topk=None, sparsified=None):
        out = orig_async(self, qd, topk, sparsified=sparsified)
        assert isinstance(out[0], torch.Tensor)      # nothing read yet
        dispatched.append(self)
        return out

    def no_blocking(self, qd, topk=None):
        raise AssertionError("the sharded engine must not read per shard")

    def no_read(self, payload):
        assert len(dispatched) == 4, "a shard was read before all dispatched"
        return orig_finalize(self, payload)

    orig_finalize = seg.SegsortEngine.finalize
    monkeypatch.setattr(seg.SegsortEngine, "retrieve_tile_async", spy_async)
    monkeypatch.setattr(seg.SegsortEngine, "retrieve_tile", no_blocking)
    monkeypatch.setattr(seg.SegsortEngine, "finalize", no_read)
    got_s, got_r = sharded.retrieve_tile(q, k)
    monkeypatch.undo()
    assert dispatched == sharded.shards
    single = seg.SegsortEngine(mine, topk=k, query_terms_budget=16,
                               val_dtype=val_dtype, device="cpu")
    s1, r1 = single.retrieve_tile(q, k)
    np.testing.assert_array_equal(got_s, s1)
    np.testing.assert_array_equal(got_r, r1)
    if val_dtype == "f32":
        ref_eng = ref_seg.ShardedSegsortEngine(
            theirs, devices=jax.devices()[:4], topk=k,
            query_terms_budget=16, min_budget=256)
        want_s, want_r = ref_eng.retrieve_tile(q, k)
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_r, want_r)
    want = _brute(mine, q)
    np.testing.assert_array_equal(got_s, -np.sort(-want, axis=1)[:, :k])


def test_sharded_segsort_async_pipeline_and_sparsify(indexes):
    """Two tiles in flight at once, pre-sparsified or dense: each finalize
    gives its own tile's result; ``T`` and ``sparsify_queries`` are the
    shards'."""
    mine, _ = indexes
    sharded = seg.ShardedSegsortEngine(mine, ["cpu"] * 3, topk=12,
                                       query_terms_budget=16)
    assert sharded.T == 16 and sharded.n_docs == N_DOCS
    qa, qb = _queries(5, 3), _queries(6, 5)
    pa = sharded.retrieve_tile_async(None, sparsified=sharded
                                     .sparsify_queries(qa))
    pb = sharded.retrieve_tile_async(qb, topk=5)
    sb, rb = sharded.finalize(pb)
    sa, ra = sharded.finalize(pa)
    assert sa.shape == (3, 12) and sb.shape == (5, 5)
    for q, s, r in ((qa, sa, ra), (qb, sb, rb)):
        want = _brute(mine, q)
        np.testing.assert_array_equal(s, -np.sort(-want, axis=1)[:, :s.shape[1]])
        np.testing.assert_array_equal(
            np.take_along_axis(want, r.astype(np.int64), axis=1), s)
    # built from a split made once: the same engine
    split = seg.ShardedSegsortEngine(mine.shard_by_rows(3), ["cpu"] * 3,
                                     topk=12, query_terms_budget=16)
    assert split.row_offsets == sharded.row_offsets == [0, 50, 100]
    s2, r2 = split.retrieve_tile(qa)
    np.testing.assert_array_equal(s2, sa)
    np.testing.assert_array_equal(r2, ra)
    with pytest.raises(ValueError, match="shards"):
        seg.ShardedSegsortEngine(mine.shard_by_rows(2), ["cpu"] * 3)


# ---- SparseRetrieval over a mesh --------------------------------------

@pytest.fixture(scope="module")
def retrieval_setup(tmp_path_factory):
    model = FakeSparseEncoder()
    root = tmp_path_factory.mktemp("torch_sharded_sr")
    index_dir = str(root / "index")
    SparseIndexer(model, index_dir, dim_voc=DRV_V).index(
        _batches(100, 16, 12, "d", seed=0))
    return model, index_dir, _batches(23, 4, 5, "q", seed=1)


def _same_runs(got, want, rtol=0.0):
    assert got.keys() == want.keys()
    for qid, w in want.items():
        w = sorted(w.items(), key=lambda kv: -kv[1])
        g = sorted(got[qid].items(), key=lambda kv: -kv[1])
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=rtol)


@pytest.mark.parametrize("engine,n_dev", [("xla", 8), ("segsort", 4)])
def test_sparse_retrieval_over_a_mesh_matches_reference(retrieval_setup,
                                                        tmp_path, engine,
                                                        n_dev):
    model, index_dir, q_batches = retrieval_setup
    kw = dict(topk=10, engine=engine, query_tile=4)
    if engine == "xla":
        kw["block"] = 8
    want_sr = ref_sr.SparseRetrieval(
        model, index_dir, out_dir=str(tmp_path / "ref"), mesh=_jax_mesh(n_dev),
        value_dtype=jnp.float32, **kw)
    got_sr = sparse_retrieval.SparseRetrieval(
        model, index_dir, out_dir=str(tmp_path / "port"),
        mesh=_cpu_mesh(n_dev), value_dtype=torch.float32, **kw)
    if engine == "segsort":
        assert isinstance(got_sr._seg, seg.ShardedSegsortEngine)
        for eng in want_sr._seg.shards + got_sr._seg.shards:
            eng.min_budget = 256
            eng.T = 16
    else:
        assert len(got_sr.terms) == n_dev and got_sr.terms[0].shape[0] == 16
    want, _ = want_sr.retrieve(q_batches)
    got, stats = got_sr.retrieve(q_batches)
    assert len(got) == 23 and stats["L0_q"] > 0
    _same_runs(got, want)
    # the same run as one device
    one, _ = sparse_retrieval.SparseRetrieval(
        model, index_dir, device="cpu", value_dtype=torch.float32,
        **kw).retrieve(q_batches)
    _same_runs(got, one)


def test_other_engines_ignore_the_mesh(retrieval_setup):
    model, index_dir, q_batches = retrieval_setup
    for engine in ("maxscore", "bmx", "cpp"):
        sr = sparse_retrieval.SparseRetrieval(model, index_dir, topk=10,
                                              engine=engine,
                                              mesh=_cpu_mesh(4))
        assert not isinstance(getattr(sr, "_seg", None),
                              seg.ShardedSegsortEngine)
        assert sr.device == torch.device("cpu")


# ---- served through the broker ----------------------------------------

def test_sharded_engine_through_server(indexes):
    mine, theirs = indexes
    eng = seg.ShardedSegsortEngine(mine, ["cpu"] * 4, topk=10,
                                   query_terms_budget=8, min_budget=256)
    ref_eng = ref_seg.ShardedSegsortEngine(theirs,
                                           devices=jax.devices()[:4],
                                           topk=10, query_terms_budget=8,
                                           min_budget=256)
    q = _queries(7, 6, n_terms=5)
    reqs = [(np.nonzero(r)[0].astype(np.int32), r[r > 0]) for r in q]
    backend = SparseTileBackend(eng, mine.doc_ids, mine.nb_docs(), width=4,
                                t_budget=8, topk=10)
    assert backend.request_cost(reqs[0]) == 0        # no job_need
    ref_backend = ref_server.SparseTileBackend(
        ref_eng, theirs.doc_ids, theirs.nb_docs(), width=4, t_budget=8,
        topk=10)
    with RetrievalServer(backend, max_wait_ms=2.0) as server, \
            ref_server.RetrievalServer(ref_backend,
                                       max_wait_ms=2.0) as ref_srv:
        for (terms, vals), qr in zip(reqs, q):
            ids, scores = server.search((terms, vals))
            want_ids, want_scores = ref_srv.search((terms, vals))
            assert ids == want_ids
            np.testing.assert_array_equal(scores, want_scores)
            want = _brute(mine, qr[None])[0]
            np.testing.assert_array_equal(scores, -np.sort(-want)[:10])


# ---- partition specs ---------------------------------------------------

def _tiny_pair(layers=8, bias=True, tie=False, seed=0):
    cfg = RefConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=layers, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=64,
                    tie_word_embeddings=tie, attention_qkv_bias=bias)
    params = jax.tree_util.tree_map(
        np.asarray, ref_llama.init_params(cfg, jax.random.PRNGKey(seed)))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pcfg = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if f.name in fields
                          and f.name not in ("dtype", "param_dtype")})
    return params, params_from_jax(params, pcfg, "cpu")


def _ref_specs(tree):
    return {tuple(k.key for k in kp): tuple(s.spec) for kp, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree):
    return {p: s.spec for p, s in part._flatten(tree)}


@pytest.mark.parametrize("shape,n", [((4096,), 8), ((16, 2048, 512), 8),
                                     ((16, 512, 2048), 8), ((3, 5), 1),
                                     ((128256, 2048), 8), ((7, 9000), 8),
                                     ((8, 1024, 1024), 8), ((64, 64), 4)])
@pytest.mark.parametrize("min_size", [1, 2 ** 16])
def test_fsdp_spec_matches_reference(shape, n, min_size):
    assert part.fsdp_spec(shape, n, min_size) == tuple(
        ref_part.fsdp_spec(shape, n, min_size))


@pytest.mark.parametrize("layers,bias,tie", [(2, False, False),
                                             (8, True, False),
                                             (4, True, True)])
@pytest.mark.parametrize("min_size", [64, 2 ** 16])
def test_fsdp_shardings_match_reference(layers, bias, tie, min_size):
    params, module = _tiny_pair(layers, bias, tie)
    want = _ref_specs(ref_part.fsdp_shardings(
        params, JMesh(np.array(jax.devices()), ("data",)),
        min_size=min_size))
    got = _port_specs(part.fsdp_shardings(module, _cpu_mesh(8),
                                          min_size=min_size))
    assert got == want
    assert _port_specs(part.replicated_shardings(module, _cpu_mesh(8))) == \
        _ref_specs(ref_part.replicated_shardings(
            params, JMesh(np.array(jax.devices()), ("data",))))


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (8, 1), (1, 8)])
@pytest.mark.parametrize("fsdp", [False, True])
def test_model_parallel_shardings_match_reference(data, model, fsdp):
    params, module = _tiny_pair(8, True, False)
    jmesh = JMesh(np.array(jax.devices()).reshape(data, model),
                  ("data", "model"))
    pmesh = mesh_lib.make_mesh(data, model, devices=["cpu"] * 8)
    for min_size in (64, 2 ** 16):
        want = _ref_specs(ref_part.model_parallel_shardings(
            params, jmesh, fsdp=fsdp, min_size=min_size))
        got = _port_specs(part.model_parallel_shardings(
            module, pmesh, fsdp=fsdp, min_size=min_size))
        assert got == want


def test_lora_tree_specs_and_apply_map_axes_onto_the_port():
    """A LoRA tree is already in the reference's layout; a module's specs
    land on its tensors transposed (``nn.Linear`` keeps [out, in]), the
    stacked layer axis dropped."""
    params, module = _tiny_pair(8, True, False)
    lora = {"layers": {"attn": {"wq": {"a": np.zeros((8, 64, 4), np.float32),
                                       "b": np.zeros((8, 4, 64),
                                                     np.float32)}}}}
    tl = {"layers": {"attn": {"wq": {k: torch.from_numpy(v).requires_grad_()
                                     for k, v in
                                     lora["layers"]["attn"]["wq"].items()}}}}
    mesh = _cpu_mesh(8)
    assert _port_specs(part.fsdp_shardings(tl, mesh, min_size=64)) == \
        _ref_specs(ref_part.fsdp_shardings(
            lora, JMesh(np.array(jax.devices()), ("data",)), min_size=64))
    placed = part.apply_shardings(tl, part.fsdp_shardings(tl, mesh,
                                                          min_size=64))
    a = placed["layers"]["attn"]["wq"]["a"]
    assert a is tl["layers"]["attn"]["wq"]["a"] and a.requires_grad
    assert a.sharding_spec == (None, "data", None)
    sh = part.model_parallel_shardings(module, mesh=mesh_lib.make_mesh(
        4, 2, devices=["cpu"] * 8), fsdp=True, min_size=64)
    assert sh["layers"]["attn"]["wq"].spec == (None, "data", "model")
    out = part.apply_shardings(module, sh)
    assert out is module
    assert module.layers[3].wq.weight.sharding_spec == ("model", "data")
    assert module.layers[0].wo.weight.sharding_spec == ("data", "model")
    assert module.layers[0].wq.bias.sharding_spec == ("model",)
    assert sh["embed_tokens"].spec == ("data", None)     # [V, H] in both
    assert module.embed_tokens.weight.sharding_spec == ("data", None)
    assert sh["lm_head"].spec == (None, "data")         # [H, V] there
    assert module.lm_head.weight.sharding_spec == ("data", None)
    shapes = part.reference_shapes(module)
    assert shapes["layers"]["mlp"]["wd"] == params["layers"]["mlp"]["wd"].shape
    assert shapes["lm_head"] == params["lm_head"].shape
    with pytest.raises(NotImplementedError, match="torchrun"):
        part.apply_shardings(module, part.replicated_shardings(
            module, mesh_lib.make_mesh(devices=["cuda:0", "cuda:1"])))


# published widths (each checkpoint's config.json), as the reference's
# shard proof builds them
REAL_WIDTHS = {
    "llama-3.2-1b": dict(vocab_size=128256, hidden_size=2048,
                         intermediate_size=8192, num_hidden_layers=16,
                         num_attention_heads=32, num_key_value_heads=8,
                         head_dim=64, tie_word_embeddings=True),
    "llama-3.2-3b": dict(vocab_size=128256, hidden_size=3072,
                         intermediate_size=8192, num_hidden_layers=28,
                         num_attention_heads=24, num_key_value_heads=8,
                         head_dim=128, tie_word_embeddings=True),
    "llama-3.1-8b": dict(vocab_size=128256, hidden_size=4096,
                         intermediate_size=14336, num_hidden_layers=32,
                         num_attention_heads=32, num_key_value_heads=8,
                         head_dim=128, tie_word_embeddings=False),
}


@pytest.mark.parametrize("name", list(REAL_WIDTHS))
def test_fsdp_specs_cover_real_widths(name):
    """Every parameter >= 2^16 elements shards 8 ways at the published
    widths, built on the meta device; the specs equal the reference's on
    its abstract params."""
    kw = REAL_WIDTHS[name]
    with torch.device("meta"):
        module = LlamaBiForMNTP(ModelConfig(max_position_embeddings=128,
                                            **kw))
    sh = part.fsdp_shardings(module, _cpu_mesh(8))
    audit = part.shard_audit(module, sh)
    assert not audit["unsharded_big"], audit["unsharded_big"]
    assert audit["param_bytes_sharded"] / audit["param_bytes_total"] > 0.99
    cfg = RefConfig(max_position_embeddings=128, **kw)
    abstract = jax.eval_shape(
        lambda: ref_llama.init_params(cfg, jax.random.PRNGKey(0)))
    assert _port_specs(sh) == _ref_specs(ref_part.fsdp_shardings(
        abstract, JMesh(np.array(jax.devices()), ("data",))))
    assert part.reference_shapes(module) == jax.tree_util.tree_map(
        lambda x: tuple(x.shape), abstract)


# ---- meshes, runtime helpers, the cls-token collator -------------------

def test_mesh_over_repeated_entries():
    mesh = mesh_lib.make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4 and not mesh.distinct
    assert mesh_lib.make_mesh(devices=["cpu"] * 8).shape == {"data": 8,
                                                             "model": 1}
    order = mesh_lib.make_mesh(devices=["cuda:1", "cuda:0", "cuda:1"])
    assert [d.index for d in order.devices] == [1, 0, 1] and order.distinct
    assert order.device == torch.device("cuda", 1)
    assert mesh_lib.local_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(3, 2, devices=["cpu"] * 4)


def test_weighted_average_and_sum_match_psum():
    mesh = JMesh(np.array(jax.devices()), ("data",))
    vals = jnp.arange(8, dtype=jnp.float32)
    weights = jnp.arange(1, 9, dtype=jnp.float32)
    fn = jax.shard_map(
        lambda v, w: ref_utils.distributed_weighted_average(v[0], w[0],
                                                            "data"),
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P())
    want = float(jnp.asarray(fn(vals, weights)).reshape(()))
    tv = [torch.tensor(float(v)) for v in range(8)]
    tw = [torch.tensor(float(w)) for w in range(1, 9)]
    assert float(utils.distributed_weighted_average(tv, tw)) == want
    fs = jax.shard_map(lambda v: ref_utils.sum_to_main(v[0], "data"),
                       mesh=mesh, in_specs=(P("data"),), out_specs=P())
    assert float(utils.sum_to_main(tv)) == float(
        jnp.asarray(fs(vals)).reshape(()))
    zero = [torch.zeros(()), torch.zeros(())]
    assert float(utils.distributed_weighted_average(zero, zero)) == 0.0


def test_runtime_helpers_match_reference():
    import argparse

    assert utils.is_first_worker() and ref_utils.is_first_worker()
    x = np.arange(6).reshape(2, 3)
    assert utils.to_list(x) == ref_utils.to_list(x)
    assert utils.to_list(torch.from_numpy(x)) == ref_utils.to_list(x)
    assert utils.supports_bfloat16("cpu")
    b = utils.batch_to_device({"ids": np.arange(3), "names": ["a"]}, "cpu")
    assert isinstance(b["ids"], torch.Tensor) and b["names"] == ["a"]
    for kw in ({}, {"query_path": "data/msmarco/queries.tsv"},
               {"corpus_path": "x/wiki/collection.tsv"},
               {"train_path": "t.jsonl", "corpus_path": ""}):
        ns = argparse.Namespace(**kw)
        assert utils.get_data_source(ns) == ref_utils.get_data_source(ns)


def test_cls_token_collator_matches_reference(tmp_path):
    tok = make_tiny_tokenizer(str(tmp_path / "tok"))
    tok.cls_token = "</s>"
    texts = ["w1 w2 w3", "w4", "w5 w6 w7 w8 w9 w10 w11 w12 w13 w14 w15"]
    for max_length in (4, 9, 16):
        got = collators.tokenize_add_cls_token_id_and_padding(
            tok, texts, max_length)
        want = ref_collators.tokenize_add_cls_token_id_and_padding(
            tok, texts, max_length)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    tok.padding_side = "right"
    with pytest.raises(ValueError, match="left"):
        collators.tokenize_add_cls_token_id_and_padding(tok, texts, 8)
