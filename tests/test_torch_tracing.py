"""The port's spans and counters (``utils/profiling.py``) and the
benchmark's readers of them, on the CPU at tiny sizes: what a span keeps
with and without a profiler session, the clock its records share with the
profiler's events, the text frontend's request records, the engine's slot
and certificate counts against hand counts, the Trainer's phases, and
each reader on hand-built records."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from retrieval_bench import run
from retrieval_bench.trace import Summary
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
from scaling_retriever_tpu_torch.models.lora import (LoraConfig,
                                                     init_lora_params)
from scaling_retriever_tpu_torch.models.weights import random_params
from scaling_retriever_tpu_torch.ops import segsort_scoring
from scaling_retriever_tpu_torch.ops.segsort_scoring import (SegsortEngine,
                                                             bucket_jobs)
from scaling_retriever_tpu_torch.serving.server import (LATENCY_WINDOW,
                                                        RetrievalServer,
                                                        SparseTileBackend)
from scaling_retriever_tpu_torch.serving.text_frontend import \
    QueryEncoderFrontend
from scaling_retriever_tpu_torch.training.trainer import (
    LLM2RetrieverTrainingArgs, Trainer)
from scaling_retriever_tpu_torch.utils import profiling
from scaling_retriever_tpu_torch.utils.profiling import profile_span

torch.set_num_threads(1)

V, N_DOCS, T, K = 96, 60, 8, 10


@pytest.fixture(autouse=True)
def clean_buffer():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def session():
    """A profiler session as the benchmark opens it: every thread."""
    every = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=every)


def names(recs):
    return [r[0] for r in recs]


# -- the span core ----------------------------------------------------------


def test_a_span_without_a_session_records_nothing_and_aggregates():
    profiling.reset_timings()
    assert not profiling.tracing()
    for _ in range(3):
        with profile_span("t.off", rows=4) as sp:
            pass
    assert sp.seconds >= 0.0
    assert profiling.spans() == [] and profiling.dropped() == 0
    agg = profiling.timings()["t.off"]
    assert agg["count"] == 3
    assert agg["max_sec"] <= agg["total_sec"]
    assert abs(agg["mean_sec"] * 3 - agg["total_sec"]) < 1e-12
    profiling.record("t.rec", 0, 1, id=1)
    assert profiling.spans() == []


def test_spans_on_a_thread_started_before_the_session_are_recorded():
    go, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        go.wait(10)
        with profile_span("t.outer", side="worker"):
            with profile_span("t.inner"):
                torch.ones(64).sum()
        seen["tid"] = threading.get_native_id()
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    with session() as prof:
        assert profiling.tracing()
        with profile_span("t.main"):
            torch.ones(64).sum()
        go.set()
        assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    recs = {r[0]: r for r in profiling.spans()}
    assert set(recs) == {"t.main", "t.outer", "t.inner"}
    assert recs["t.inner"][4] == "t.outer" and recs["t.outer"][4] is None
    assert recs["t.outer"][3] == recs["t.inner"][3] == seen["tid"]
    assert recs["t.main"][3] == threading.get_native_id()
    assert recs["t.outer"][5] == {"side": "worker"}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in recs}
    assert set(events) == set(recs)
    for name, (_, a, b, *_) in recs.items():
        e = events[name]
        assert abs(a - e.start_ns()) < 1_000_000, name
        assert abs(b - (e.start_ns() + e.duration_ns())) < 1_000_000, name


def test_the_aggregate_loses_no_update_under_contention():
    profiling.reset_timings()
    n_threads, n = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profile_span("t.race"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.timings()["t.race"]["count"] == n_threads * n


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with session():
        for i in range(5):
            with profile_span("t.full", i=i):
                pass
    assert [r[5]["i"] for r in profiling.spans()] == [0, 1, 2]
    assert profiling.dropped() == 2
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.dropped() == 0


# -- the serving path -------------------------------------------------------


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
    """Terms are the token ids, weights a fixed function of the id."""
    def dispatch(ids, mask):
        vals = (_val_of(ids) * mask).astype(np.float32)
        return torch.from_numpy(ids.copy()), torch.from_numpy(vals)

    dispatch.dispatch = dispatch
    dispatch.handoff = True
    return dispatch


def _texts(rng, n, t=5):
    return [" ".join(f"t{x}" for x in rng.choice(V, size=t, replace=False))
            for _ in range(n)]


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(11)
    rows, cols, vals = [], [], []
    for d in range(N_DOCS):
        nnz = int(rng.integers(3, 9))
        rows += [d] * nnz
        cols += rng.choice(V, size=nnz, replace=False).tolist()
        vals += rng.uniform(0.1, 3.0, size=nnz).tolist()
    return SparseIndex.from_triples(
        np.array(rows), np.array(cols), np.array(vals, np.float32),
        [f"d{d}" for d in range(N_DOCS)], V)


def _engine(index):
    return SegsortEngine(index, topk=K, query_terms_budget=T, device="cpu")


def _server(engine, index):
    return RetrievalServer(SparseTileBackend(
        engine, index.doc_ids, index.nb_docs(), widths=(4, 8), t_budget=T,
        topk=K), max_wait_ms=2.0)


def test_one_request_record_per_answered_text(index):
    rng = np.random.default_rng(3)
    server = _server(_engine(index), index)
    fe = QueryEncoderFrontend(server, fake_encode_handoff(), fake_tokenize,
                              widths=(4, 8), t_sparse=T, max_wait_ms=5.0)
    fe.warmup(_texts(rng, 4), passes=1)
    texts = _texts(rng, 11)
    with server, fe:
        fe.start()
        with session():
            futs = [fe.submit_text(t) for t in texts]
            for f in futs:
                f.result(timeout=30)
    recs = profiling.spans()
    reqs = [r for r in recs if r[0] == "frontend.request"]
    tiles = {r[5]["tile"]: r for r in recs if r[0] == "frontend.dispatch"}
    assert sorted(r[5]["id"] for r in reqs) == list(range(1, 12))
    for _, submit, result, _, _, a in reqs:
        assert submit <= a["dispatch_ns"] <= result
        assert not a["rerouted"]
        assert a["dispatch_ns"] == tiles[a["tile"]][1]
    assert sum(t[5]["rows"] for t in tiles.values()) == len(texts)
    assert all(t[5]["width"] >= t[5]["rows"] and t[5]["rung"] == T
               for t in tiles.values())
    by_tile = {}
    for r in reqs:
        by_tile.setdefault(r[5]["tile"], []).append(r)
    assert any(len(v) > 1 for v in by_tile.values())
    pending = [r for r in recs if r[0] == "frontend.pending"]
    assert {r[5]["tile"] for r in pending} == set(tiles)
    for r in recs:
        if r[0] in ("frontend.tokenize", "encoder.top_t"):
            assert r[4] == "frontend.dispatch"
        if r[0] in ("engine.certify", "engine.copy_out"):
            assert r[4] == "engine.read"
    assert server.latencies_s.maxlen == LATENCY_WINDOW
    assert fe.encode_latencies_s.maxlen == LATENCY_WINDOW


@pytest.mark.parametrize("path", ["handoff", "host"])
def test_slot_counts_equal_a_hand_count_on_a_padded_tile(index, path):
    eng = _engine(index)
    rng = np.random.default_rng(5)
    ids, mask = fake_tokenize(_texts(rng, 3))
    ids = np.concatenate([ids, ids[-1:]])          # the frontend's padding
    mask = np.concatenate([mask, mask[-1:]])
    vals = (_val_of(ids) * mask).astype(np.float32)
    need = eng.job_need(ids, vals)
    if path == "handoff":
        jobs = int(need.max()) - 1                 # one row over the bucket
        with session():
            eng.finalize_handoff(eng.retrieve_tile_handoff_async(
                torch.from_numpy(ids), torch.from_numpy(vals), jobs,
                topk=K, n_real=3))
        real = int(np.minimum(need[:3], jobs).sum())
    else:
        vals[3] = 0.0                              # the server's pad row
        jobs = bucket_jobs(int(need.max()))
        with session():
            eng.finalize(eng.retrieve_tile_async(None, K,
                                                 sparsified=(ids, vals)))
        real = int(need[:3].sum())
    assert eng.stats() == {"tiles": 1, "cert_fallback_tiles": 0,
                           "jobs_real": real, "jobs_slab": 4 * jobs}
    (copy,) = [r for r in profiling.spans() if r[0] == "engine.copy_out"]
    assert copy[5] == {"rows": 4, "jobs": jobs, "jobs_real": real,
                       "jobs_slab": 4 * jobs, "cert_fallback": False}


def test_a_failed_certificate_is_counted_and_answered_in_full(index,
                                                             monkeypatch):
    eng = _engine(index)
    q = np.zeros((4, V), np.float32)
    q[np.arange(4)[:, None], np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9],
                                       [1, 5, 9]])] = 1.5
    want = eng.retrieve_tile(q)
    assert eng.stats()["cert_fallback_tiles"] == 0

    def never(bv, v, m, k):
        return torch.zeros(bv.shape[0], dtype=torch.bool, device=bv.device)

    monkeypatch.setattr(segsort_scoring, "_blocked_certificate", never)
    with session():
        got = eng.retrieve_tile(q)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert eng.stats()["tiles"] == 2
    assert eng.stats()["cert_fallback_tiles"] == 1
    recs = profiling.spans()
    assert "engine.fallback" in names(recs)
    assert [r[5]["cert_fallback"] for r in recs
            if r[0] == "engine.copy_out"] == [True]


def test_the_server_reports_the_engine_counts(index):
    server = _server(_engine(index), index)
    rng = np.random.default_rng(7)
    with server:
        for text in _texts(rng, 3):
            terms = np.array([int(w[1:]) for w in text.split()], np.int32)
            server.search((terms, _val_of(terms)))
    eng = server.stats()["engine"]
    assert eng["tiles"] == 3 and eng["jobs_slab"] >= eng["jobs_real"] > 0


# -- the trainer ------------------------------------------------------------


def test_a_train_step_yields_its_phases_in_order(tmp_path):
    cfg = ModelConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64)
    lc = LoraConfig(r=4, lora_alpha=8)
    lora = init_lora_params(cfg, lc, torch.Generator().manual_seed(2),
                            device="cpu")
    enc = LlamaBiSparse(random_params(cfg, 1, "cpu"), cfg, lora, lc)
    args = LLM2RetrieverTrainingArgs(
        output_dir=str(tmp_path), max_steps=4, lora=True, lora_r=4,
        lora_alpha=8, task_names=("rank", "query_reg", "doc_reg"),
        task_weights=(1.0, 0.01, 0.008))
    trainer = Trainer(enc, args, train_loader=[])
    g = torch.Generator().manual_seed(3)

    def ids(n, s):
        return torch.randint(4, 128, (n, s), generator=g, dtype=torch.int32)

    q, c = ids(2, 6), ids(6, 8)
    batch = {"tokenized_queries": {"input_ids": q,
                                   "attention_mask": torch.ones_like(q)},
             "tokenized_contexts": {"input_ids": c,
                                    "attention_mask": torch.ones_like(c)},
             "target_labels": torch.arange(2, dtype=torch.int32)}
    with session():
        out = trainer._train_step(batch, 1)
    assert np.isfinite(out["loss"])
    recs = sorted(profiling.spans(), key=lambda r: r[1])
    phases = [n for n in names(recs) if n.startswith("train.")]
    assert phases == ["train.forward", "train.backward", "train.reduce",
                      "train.optimizer", "train.read"]
    stages = {r[0]: r[4] for r in recs if r[0].startswith("encoder.")}
    assert stages == {"encoder.layers": "train.forward",
                      "encoder.head": "train.forward",
                      "encoder.pool": "train.forward"}


# -- the readers ------------------------------------------------------------

W0, W1 = 1_000_000, 2_000_000          # a 1 ms window
MS = 1_000_000


def _recs():
    recs = [
        ("encoder.layers", W0, W0 + 300_000, 1, "frontend.dispatch", {}),
        ("encoder.head", W0 + 250_000, W0 + 350_000, 1, None, {}),
        ("engine.read", W0 + 500_000, W0 + 800_000, 2, None, {}),
        ("engine.copy_out", W0 + 650_000, W0 + 750_000, 2, "engine.read",
         {"jobs_real": 30, "jobs_slab": 64}),
        ("engine.copy_out", W0 + 760_000, W0 + 790_000, 2, "engine.read",
         {"jobs_real": 10, "jobs_slab": 64}),
        ("train.forward", W0, W0 + 150_000, 3, None, {}),
        ("train.backward", W0 + 150_000, W0 + 650_000, 3, None, {}),
        ("train.optimizer", W0 + 650_000, W1, 3, None, {}),
        # outside the window: never read
        ("engine.copy_out", 0, 10, 2, None, {"jobs_real": 0,
                                             "jobs_slab": 999}),
    ]
    # four text tiles in the window, two of them replayed as a graph; one
    # tile's graph record lies on another thread, one tile starts before
    # the window
    for a, b, graph in ((10_000, 100_000, 1), (110_000, 200_000, 1),
                        (210_000, 300_000, None), (310_000, 340_000, 5)):
        recs.append(("frontend.dispatch", W0 + a, W0 + b, 1, None,
                     {"tile": a}))
        if graph is not None:
            recs.append(("encoder.graph", W0 + a + 5_000, W0 + b - 5_000,
                         graph, "frontend.dispatch", {"width": 8}))
    recs.append(("frontend.dispatch", W0 - 10_000, W0 + 5_000, 1, None, {}))
    for i in range(100):
        start = W0 + i
        recs.append(("frontend.request", start, start + 200 * MS, 4, None,
                     {"id": i, "tile": i // 10, "dispatch_ns":
                      start + (i + 1) * MS, "rerouted": False}))
    return recs


def _rec():
    device = [(W0 + 100_000, W0 + 200_000, "k", 1),
              (W0 + 600_000, W0 + 700_000, "k", 2)]
    return {"trace": Summary((W0, W1), device, [], {})}


def _reader(name):
    path = os.path.join(run.ROOT, "retrieval_bench", "metrics",
                        f"{name}.py")
    return run.load_file(path, f"reader_{name.replace('.', '_')}")


EXPECTED = {
    # the union [0, 350) of encoder.* less the busy [100, 200)
    "encoder.idle.text": 25.0,
    # [500, 800) less the busy [600, 700)
    "engine.idle.stream": 20.0,
    # [0, 650) less the busy 100 + 50
    "trainer.dispatch_idle.train": 50.0,
    "engine.slot_fill.text": 100.0 * 40 / 128,
    "engine.slot_fill.stream": 100.0 * 40 / 128,
    "frontend.queue_wait.text": float(np.percentile(np.arange(1, 101), 99)),
    # two of the four tiles wholly inside the window
    "encoder.graph_share.text": 50.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_on_hand_built_records(name, monkeypatch):
    monkeypatch.setattr(profiling, "_records", _recs())
    reader = _reader(name)
    assert reader.read(_rec()) == pytest.approx(EXPECTED[name])
    assert reader.read({"trace": None}) is None
    monkeypatch.setattr(profiling, "_dropped", 1)
    assert reader.read(_rec()) is None
    monkeypatch.setattr(profiling, "_dropped", 0)
    monkeypatch.setattr(profiling, "_records", [])
    assert reader.read(_rec()) is None


def test_the_graph_share_reads_every_replayed_tile(monkeypatch):
    """100% where every tile of the window holds an ``encoder.graph``
    record; None where the port keeps none (a port without the graphs)."""
    tiles = [("frontend.dispatch", W0 + a, W0 + a + 50_000, 7, None, {})
             for a in range(0, 900_000, 100_000)]
    graphs = [("encoder.graph", r[1] + 1_000, r[2] - 1_000, 7,
               "frontend.dispatch", {}) for r in tiles]
    reader = _reader("encoder.graph_share.text")
    monkeypatch.setattr(profiling, "_records", tiles + graphs)
    assert reader.read(_rec()) == 100.0
    monkeypatch.setattr(profiling, "_records", tiles)
    assert reader.read(_rec()) is None
