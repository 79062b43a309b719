"""Serving through the torch port: the ``tests/test_text_handoff.py``
scenarios (device encode→retrieve handoff, over-bucket re-route, standing
bucket sizing, resolver failure) and the pre-encoded ``RetrievalServer``
path, against a brute-force oracle and the JAX stack's results; and the
whole text slice (Llama encoder → top-T handoff → segsort engine → server)
against the JAX stack on the same weights."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index.inverted_index import SparseIndex as RefIndex
from scaling_retriever_tpu.models import encoder as ref_encoder
from scaling_retriever_tpu.models import llama as ref_llama
from scaling_retriever_tpu.ops.segsort_scoring import \
    SegsortEngine as RefEngine
from scaling_retriever_tpu.serving import server as ref_server
from scaling_retriever_tpu.serving import text_frontend as ref_frontend
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
from scaling_retriever_tpu_torch.models.weights import (
    params_from_jax, random_params,
)
from scaling_retriever_tpu_torch.ops.segsort_scoring import (
    SegsortEngine, bucket_jobs, segsort_retrieve_dma,
)
from scaling_retriever_tpu_torch.serving.server import (
    RetrievalServer, SparseTileBackend,
)
from scaling_retriever_tpu_torch.serving.text_frontend import (
    QueryEncoderFrontend, make_encode_fn, make_encode_fn_handoff,
    make_hf_tokenize_fn,
)
from scaling_retriever_tpu_torch.utils.utils import (
    depth2_pipeline, staged_pipeline, tie_equal_topk,
)

torch.set_num_threads(1)

V = 96
N_DOCS = 60
T = 8
K = 10


def _triples(rng):
    rows, cols, vals = [], [], []
    for d in range(N_DOCS):
        nnz = int(rng.integers(3, 9))
        rows += [d] * nnz
        cols += rng.choice(V, size=nnz, replace=False).tolist()
        vals += rng.uniform(0.1, 3.0, size=nnz).tolist()
    return (np.array(rows), np.array(cols), np.array(vals, np.float32),
            [f"d{d}" for d in range(N_DOCS)], V)


def _val_of(term):
    return ((term % 5) + 1).astype(np.float32) / 2.0


def fake_tokenize(texts, length=None):
    ids = np.zeros((len(texts), T), np.int32)
    mask = np.zeros((len(texts), T), np.int32)
    for i, t in enumerate(texts):
        toks = [int(w[1:]) for w in t.split()][:T]
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return ids, mask


def fake_encode_handoff():
    """Deterministic 'encoder': terms are the token ids, weights a fixed
    function of the id."""
    def dispatch(ids, mask):
        vals = (_val_of(ids) * mask).astype(np.float32)
        return torch.from_numpy(ids.copy()), torch.from_numpy(vals)

    dispatch.dispatch = dispatch
    dispatch.handoff = True
    return dispatch


def _texts(rng, n, t=5):
    return [" ".join(f"t{x}" for x in rng.choice(V, size=t, replace=False))
            for _ in range(n)]


def _reps(text):
    terms = np.asarray([int(w[1:]) for w in text.split()], np.int32)
    return terms, _val_of(terms)


def _oracle(idx, text):
    terms, vals = _reps(text)
    dense = np.zeros(V, np.float32)
    dense[terms] = vals
    scores = np.zeros(N_DOCS, np.float32)
    for t in range(V):
        r, v = idx.posting(t)
        scores[r] += dense[t] * v
    order = np.argsort(-scores, kind="stable")[:K]
    keep = [d for d in order if scores[d] > 0]
    return [f"d{d}" for d in keep], scores[keep]


@pytest.fixture(scope="module")
def stack():
    tri = _triples(np.random.default_rng(11))
    idx = SparseIndex.from_triples(*tri)
    eng = SegsortEngine(idx, topk=K, query_terms_budget=T, device="cpu")
    backend = SparseTileBackend(eng, idx.doc_ids, idx.nb_docs(), width=8,
                                t_budget=T, topk=K)
    ref_idx = RefIndex.from_triples(*tri)
    ref_eng = RefEngine(ref_idx, topk=K, query_terms_budget=T,
                        min_budget=256, fetch="dma")
    ref_srv = ref_server.RetrievalServer(ref_server.SparseTileBackend(
        ref_eng, ref_idx.doc_ids, ref_idx.nb_docs(), width=8, t_budget=T,
        topk=K))
    return idx, eng, RetrievalServer(backend, max_wait_ms=2.0), ref_srv


def _check_texts(frontend, idx, ref_srv, texts):
    with ref_srv:
        for text in texts:
            ids, scores = frontend.search_text(text)
            want_ids, want_scores = _oracle(idx, text)
            tie_equal_topk(want_ids, want_scores, ids, scores, rtol=1e-5)
            ref_ids, ref_scores = ref_srv.search(_reps(text))
            tie_equal_topk(ref_ids, ref_scores, ids, scores, rtol=1e-5)


def test_packed_variant_matches_dma(stack):
    """The engine's handoff payload carries the same scores/rows as
    segsort_retrieve_dma and the host job_need."""
    _, eng, _, _ = stack
    ids, mask = fake_tokenize(_texts(np.random.default_rng(1), 4))
    qv = (_val_of(ids) * mask).astype(np.float32)
    J = bucket_jobs(int(eng.job_need(ids, qv).max()))
    s0, r0, _ = segsort_retrieve_dma(
        eng.rows_flat, eng.valbits_flat, eng.offsets, torch.from_numpy(ids),
        torch.from_numpy(qv), k=K, jobs_per_query=J, n_docs=eng.n_docs)
    s1, r1, need = SegsortEngine.finalize_handoff(
        eng.retrieve_tile_handoff_async(torch.from_numpy(ids),
                                        torch.from_numpy(qv), J, topk=K))
    np.testing.assert_array_equal(s0.numpy(), s1)
    np.testing.assert_array_equal(r0.numpy(), r1)
    np.testing.assert_array_equal(need, eng.job_need(ids, qv))


def test_handoff_end_to_end_exact(stack):
    idx, _, server, ref_srv = stack
    rng = np.random.default_rng(2)
    frontend = QueryEncoderFrontend(server, fake_encode_handoff(),
                                    fake_tokenize, widths=(4, 8), t_sparse=T)
    assert frontend.handoff
    assert frontend.warmup(_texts(rng, 4), passes=1)["jobs_bucket"] >= 1
    with server:
        frontend.start()
        try:
            _check_texts(frontend, idx, ref_srv, _texts(rng, 6))
        finally:
            frontend.stop()
    st = frontend.stats()
    assert st["n_handoff_tiles"] >= 1 and st["n_fallback_queries"] == 0


def test_a_cpu_encoder_captures_no_tile_graph(stack):
    """On a CPU device ``warmup()`` captures no tile graph, every served
    tile counts under ``eager_tiles``, and each text's result is that of
    its eager tile's reps through the server."""
    idx, _, server, _ = stack
    cfg = ModelConfig(vocab_size=V, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=1e4)
    model = LlamaBiSparse(random_params(cfg, 5, "cpu"), cfg)
    encode = make_encode_fn_handoff(model, T)
    frontend = QueryEncoderFrontend(server, encode, fake_tokenize,
                                    widths=(4, 8), t_sparse=T)
    rng = np.random.default_rng(9)
    frontend.warmup(_texts(rng, 4), passes=2)
    assert len(model.tile_graphs) == 0
    texts = _texts(rng, 12)
    with server:
        frontend.start()
        try:
            got = [f.result(timeout=60)
                   for f in [frontend.submit_text(t) for t in texts]]
        finally:
            frontend.stop()
        for text, (ids, scores) in zip(texts, got):
            terms, vals = encode(*fake_tokenize([text]))
            keep = vals[0] > 0
            want = server.search((terms[0][keep].numpy(),
                                  vals[0][keep].numpy()))
            assert ids
            tie_equal_topk(*want, ids, scores, rtol=1e-5)
    st = frontend.stats()
    assert st["graph_tiles"] == 0
    assert st["eager_tiles"] == st["n_encode_batches"] >= 2
    assert len(model.tile_graphs) == 0


def test_handoff_over_bucket_falls_back(stack):
    """jobs_bucket=1 truncates every query's job table: the need column
    re-routes each through server.submit and results stay exact."""
    idx, _, server, ref_srv = stack
    rng = np.random.default_rng(3)
    frontend = QueryEncoderFrontend(server, fake_encode_handoff(),
                                    fake_tokenize, widths=(4, 8), t_sparse=T,
                                    jobs_bucket=1)
    texts = _texts(rng, 5)
    with server:
        frontend.start()
        try:
            _check_texts(frontend, idx, ref_srv, texts)
        finally:
            frontend.stop()
    assert frontend.stats()["n_fallback_queries"] == len(texts)


def test_size_bucket_exact_rounding(stack):
    _, _, server, _ = stack
    fe = QueryEncoderFrontend(server, fake_encode_handoff(), fake_tokenize,
                              widths=(4, 8), t_sparse=T, bucket_headroom=1.0)
    assert fe._size_bucket(640) == 640
    assert fe._size_bucket(641) == 704
    assert fe._size_bucket(1) == 64
    fe2 = QueryEncoderFrontend(server, fake_encode_handoff(), fake_tokenize,
                               widths=(4, 8), t_sparse=T,
                               bucket_headroom=1.15)
    assert fe2._size_bucket(560) == 704


def test_resolver_survives_resolve_failure(stack):
    idx, _, server, _ = stack
    rng = np.random.default_rng(4)
    frontend = QueryEncoderFrontend(server, fake_encode_handoff(),
                                    fake_tokenize, widths=(4, 8), t_sparse=T)
    frontend.warmup(_texts(rng, 4), passes=1)
    real = frontend._resolve_batch
    state = {"n": 0}

    def boom(*a, **kw):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("injected resolve failure")
        return real(*a, **kw)

    frontend._resolve_batch = boom
    with server:
        frontend.start()
        try:
            with pytest.raises(RuntimeError, match="injected"):
                frontend.submit_text(_texts(rng, 1)[0]).result(timeout=10)
            text = _texts(rng, 1)[0]
            ids, _ = frontend.search_text(text)
            assert set(ids) >= set(_oracle(idx, text)[0])
        finally:
            frontend.stop()


def test_handoff_requires_segsort_engine():
    class HostOnly:
        def job_need(self, q_terms, q_vals):
            return np.zeros(len(q_terms), np.int64)

    backend = SparseTileBackend(HostOnly(), None, N_DOCS, width=8, topk=K)
    with pytest.raises(ValueError, match="handoff"):
        QueryEncoderFrontend(RetrievalServer(backend), fake_encode_handoff(),
                             fake_tokenize, widths=(4, 8), t_sparse=T)


def test_submit_matches_reference_server(stack):
    """Pre-encoded requests through RetrievalServer.submit, concurrently
    (tiles form and pipeline), against the JAX server; an over-cap query is
    rejected at submit when no hot lane is configured."""
    idx, _, server, ref_srv = stack
    rng = np.random.default_rng(5)
    reps = [_reps(t) for t in _texts(rng, 20)]
    with server, ref_srv:
        futs = [server.submit(r) for r in reps]
        for r, f in zip(reps, futs):
            ids, scores = f.result(timeout=30)
            tie_equal_topk(*ref_srv.search(r), ids, scores, rtol=1e-5)
        capped = RetrievalServer(SparseTileBackend(
            server.backend.engine, idx.doc_ids, N_DOCS, width=8, topk=K,
            max_need_jobs=0))
        with capped, pytest.raises(ValueError, match="hot_lane"):
            capped.submit(reps[0])
    assert server.stats()["n_requests"] >= 20


def test_pipelines_drain_in_order():
    out = []
    depth2_pipeline(range(7), lambda i: i * 10, out.append, depth=3)
    assert out == [0, 10, 20, 30, 40, 50, 60]
    log = []
    staged_pipeline(range(5), lambda i: ("d", i),
                    lambda p: log.append(("a", p[1])) or ("a", p[1]),
                    lambda p: log.append(("r", p[1])))
    assert [x for x in log if x[0] == "r"] == [("r", i) for i in range(5)]
    assert log.index(("a", 4)) < log.index(("r", 4))


def test_hf_tokenize_fn_matches_reference(tmp_path):
    """The length ladder picks the same rung and the same left-padded ids
    and mask as the JAX package's tokenize fn."""
    from helpers import make_tiny_tokenizer

    tok = make_tiny_tokenizer(str(tmp_path))
    mine = make_hf_tokenize_fn(tok, max_length=16, lengths=(4, 8))
    theirs = ref_frontend.make_hf_tokenize_fn(tok, max_length=16,
                                              lengths=(4, 8))
    assert mine.lengths == theirs.lengths == (4, 8, 16)
    for texts in (["w1 w2", "w3"], ["w1 w2 w3 w4 w5 w6"], ["w9 " * 20]):
        for a, b in zip(mine(texts), theirs(texts)):
            np.testing.assert_array_equal(a, b)


def test_text_slice_matches_jax_stack(tiny_config):
    """Text → bidirectional Llama → sparse_pool → on-device top-T →
    segsort handoff → server, port vs JAX on the same weights (handoff
    path), and the port's host path against its handoff path."""
    cfg = dataclasses.replace(tiny_config, vocab_size=V)
    params = ref_llama.init_params(cfg, jax.random.PRNGKey(7))
    tri = _triples(np.random.default_rng(12))
    ref_idx = RefIndex.from_triples(*tri)
    ref_eng = RefEngine(ref_idx, topk=K, query_terms_budget=T,
                        min_budget=256, fetch="dma")
    ref_srv = ref_server.RetrievalServer(ref_server.SparseTileBackend(
        ref_eng, ref_idx.doc_ids, N_DOCS, width=8, t_budget=T, topk=K))
    ref_fe = ref_frontend.QueryEncoderFrontend(
        ref_srv, ref_frontend.make_encode_fn_handoff(
            ref_encoder.LlamaBiSparse(params, cfg), T),
        fake_tokenize, widths=(8,), t_sparse=T)

    pcfg = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)
                          if f.name not in ("dtype", "param_dtype")})
    model = LlamaBiSparse(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pcfg, "cpu"), pcfg)
    idx = SparseIndex.from_triples(*tri)
    eng = SegsortEngine(idx, topk=K, query_terms_budget=T, device="cpu")
    server = RetrievalServer(SparseTileBackend(eng, idx.doc_ids, N_DOCS,
                                               width=8, t_budget=T, topk=K))
    fe = QueryEncoderFrontend(server, make_encode_fn_handoff(model, T),
                              fake_tokenize, widths=(8,), t_sparse=T)
    fe_host = QueryEncoderFrontend(server, make_encode_fn(model, T),
                                   fake_tokenize, widths=(8,), t_sparse=T)
    texts = _texts(np.random.default_rng(8), 8, t=6)
    ref_fe.warmup(texts[:2], passes=1)
    fe.warmup(texts[:2], passes=1)
    with ref_srv, server:
        ref_fe.start()
        fe.start()
        fe_host.start()
        try:
            ref_f = [ref_fe.submit_text(t) for t in texts]
            got_f = [fe.submit_text(t) for t in texts]
            host_f = [fe_host.submit_text(t) for t in texts]
            for a, b, c in zip(ref_f, got_f, host_f):
                ids, scores = b.result(timeout=60)
                assert ids and np.isfinite(scores).all()
                tie_equal_topk(*a.result(timeout=60), ids, scores, rtol=1e-4)
                tie_equal_topk(*c.result(timeout=60), ids, scores, rtol=1e-5)
        finally:
            ref_fe.stop()
            fe.stop()
            fe_host.stop()


def test_random_params_are_seeded():
    cfg = ModelConfig(vocab_size=V, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1)
    a, b = random_params(cfg, 3, "cpu"), random_params(cfg, 3, "cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert a.lm_head is None and (a.layers[0].input_norm == 1).all()
    assert 0.015 < float(a.embed_tokens.weight.std()) < 0.025


def _queue_then_start(server, reqs):
    """Queue every request before the worker exists, so the pipeline
    holds two tiles at once (the advance step runs only then)."""
    server._started = True
    futs = [server.submit(r) for r in reqs]
    server._started = False
    server.start()
    return futs


def test_server_over_blockmax_engine_returns_engine_results():
    """Pre-encoded requests through RetrievalServer over the two-pass
    block-max engine: the broker advances each tile to its second pass
    while the next tile's first runs, and returns what the engine returns
    for the same queries."""
    from test_torch_blockmax import TB, make_clustered, make_queries

    from scaling_retriever_tpu_torch.ops.blockmax import BlockMaxSegsortEngine

    idx = SparseIndex.from_triples(*make_clustered())
    eng = BlockMaxSegsortEngine(idx, topk=K, query_terms_budget=TB,
                                cover=1.5, gate=0.99, device="cpu")
    qt, qv = make_queries(16, seed=3)
    reqs = [(qt[i][qv[i] > 0], qv[i][qv[i] > 0]) for i in range(16)]
    backend = SparseTileBackend(eng, idx.doc_ids, idx.nb_docs(), width=4,
                                t_budget=TB, topk=K)
    advanced = []
    real = eng.continue_async
    eng.continue_async = lambda p: advanced.append(p[0]) or real(p)
    server = RetrievalServer(backend, max_wait_ms=0.5)
    futs = _queue_then_start(server, reqs)
    try:
        got = [f.result(timeout=60) for f in futs]
    finally:
        server.stop()
    assert "bmx" in advanced and eng.stats()["pruned_tiles"] >= 4
    del eng.continue_async
    for s in range(0, 16, 4):
        scores, rows = eng.finalize(eng.retrieve_tile_async(
            None, K, sparsified=backend.pack(reqs[s:s + 4])))
        for i in range(4):
            ids, sc = got[s + i]
            tie_equal_topk([idx.doc_ids[r] for r in rows[i]], scores[i],
                           ids, sc, rtol=1e-6)


def test_broker_survives_advance_failure(stack):
    """A two-pass backend whose advance raises fails only its own batch;
    the worker goes on serving (tests/test_serving.py's scenario)."""
    idx, eng, _, _ = stack
    backend = SparseTileBackend(eng, idx.doc_ids, idx.nb_docs(), width=1,
                                t_budget=T, topk=K)
    calls = {"n": 0}

    def advance(payload):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("pass-2 pruning exploded")
        return payload

    backend.advance = advance
    texts = _texts(np.random.default_rng(9), 4)
    server = RetrievalServer(backend, max_wait_ms=0.5)
    server.warmup([_reps(texts[0])], passes=1)
    futs = _queue_then_start(server, [_reps(t) for t in texts])
    try:
        outcomes = []
        for f in futs:
            try:
                outcomes.append(("ok", f.result(timeout=10)))
            except RuntimeError as e:
                outcomes.append(("err", str(e)))
        errs = [o for o in outcomes if o[0] == "err"]
        assert len(errs) == 1 and "pass-2" in errs[0][1]
        for (kind, res), text in zip(outcomes, texts):
            if kind == "ok":
                tie_equal_topk(*_oracle(idx, text), *res, rtol=1e-5)
    finally:
        server.stop()
    calls["n"] = 5
    with RetrievalServer(backend, max_wait_ms=0.5) as s2:
        ids, scores = s2.search(_reps(texts[0]))
        tie_equal_topk(*_oracle(idx, texts[0]), ids, scores, rtol=1e-5)
