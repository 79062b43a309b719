"""The port's offline driver (scaling_retriever_tpu_torch/index/sparse_retrieval.py)
against the JAX package's on ``test_retrieval_drivers``' fake encoder,
whose reps are multiples of 0.5: run.json is equal per engine, and so are
the tile schedules, hot-query routing and the q_stats.json keys. topk
covers every doc, so no tie at a k boundary can change a run. A tiny HF
Llama, carried across with ``params_from_jax``, gives tie-equal runs at
rtol 1e-4."""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_tiny_llama_dir  # noqa: E402
from test_retrieval_drivers import V, FakeSparseEncoder, _batches  # noqa: E402

from scaling_retriever_tpu.index.indexer import SparseIndexer  # noqa: E402
from scaling_retriever_tpu.index import sparse_retrieval as ref  # noqa: E402
from scaling_retriever_tpu_torch.index import sparse_retrieval as port  # noqa: E402
from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine  # noqa: E402
from scaling_retriever_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk  # noqa: E402

torch.set_num_threads(1)

N_DOCS = 100
TOPK = 1000
Q_STATS_KEYS = {"L0_q", "warmup_s", "warmup_tiles", "steady_s", "steady_qps",
                "hot_queries", "setup_s", "encode_s", "retrieval_s",
                "retrieval_qps", "spans"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = FakeSparseEncoder()
    root = tmp_path_factory.mktemp("torch_sr")
    index_dir = str(root / "index")
    SparseIndexer(model, index_dir, dim_voc=V).index(
        _batches(N_DOCS, 16, 12, "d", seed=0))
    q_batches = _batches(23, 4, 5, "q", seed=1)
    return model, index_dir, q_batches, root


def _run(mod, model, index_dir, out_dir, q_batches, fetch=None, **kw):
    """``fetch`` swaps in a segsort engine with that posting fetch (the
    driver itself always takes "auto": gather on the CPU)."""
    sr = mod.SparseRetrieval(model, index_dir, out_dir=str(out_dir),
                             topk=TOPK, query_tile=8, **kw)
    if fetch is not None:
        sr._seg = SegsortEngine(sr.index, topk=TOPK, device="cpu",
                                fetch=fetch)
    run, stats = sr.retrieve(q_batches)
    with open(os.path.join(str(out_dir), "run.json")) as f:
        assert json.load(f) == run
    return sr, run, stats


# (engine, index_val_dtype, the segsort engine's fetch: "auto" is the
# driver's own, gather on the CPU; "dma" swaps in the DMA-fetch engine)
ENGINES = [("segsort", "f32", "dma"), ("segsort", "f32", "gather"),
           ("segsort", "bf16", "auto"), ("segsort", "q8", "auto"),
           ("xla", "f32", "auto"), ("maxscore", "f32", "auto"),
           ("bmx", "f32", "auto")]


@pytest.mark.parametrize("engine,vd,fetch", ENGINES,
                         ids=[f"{e}-{v}-{f}" for e, v, f in ENGINES])
def test_run_json_equals_reference(setup, tmp_path, engine, vd, fetch):
    model, index_dir, q_batches, _ = setup
    kw = dict(engine=engine, index_val_dtype=vd)
    _, want, s_ref = _run(ref, model, index_dir, tmp_path / "ref", q_batches,
                          **kw)
    sr, got, s_port = _run(port, model, index_dir, tmp_path / "port",
                           q_batches, device="cpu",
                           fetch="dma" if fetch == "dma" else None, **kw)
    assert len(want) == 23
    assert got == want
    assert set(s_port) == set(s_ref)
    assert s_port["L0_q"] == s_ref["L0_q"]
    if engine != "xla":
        assert set(s_port) == (Q_STATS_KEYS if engine != "maxscore"
                               else Q_STATS_KEYS - {"warmup_s",
                                                    "warmup_tiles",
                                                    "steady_s", "steady_qps",
                                                    "hot_queries"})
    if engine == "segsort":
        assert sr._seg.fetch == ("gather" if fetch == "gather" else "dma")


def test_pack_tiles_hot_routing_and_batch_forms(setup, tmp_path):
    """DMA schedules equal the reference's (job_slots cut to 256 so widths
    halve), hot routing sends the same queries to the doc-major scan with
    equal runs, and dense ``rep`` / sparse ``q_terms`` batches give the
    token batches' run."""
    model, index_dir, q_batches, _ = setup
    mine = port.SparseRetrieval(model, index_dir, topk=TOPK, query_tile=8,
                                engine="segsort", index_val_dtype="bf16",
                                device="cpu")
    theirs = ref.SparseRetrieval(model, index_dir, topk=TOPK, query_tile=8,
                                 engine="segsort", index_val_dtype="bf16")
    reps = np.concatenate([model.encode(b["input_ids"], b["attention_mask"])
                           for b in q_batches])
    qt, qv = theirs._seg.sparsify_queries(reps)
    order = np.argsort(-qv.sum(1), kind="stable")
    widths = set()
    for slots in (32768, 2048, 1024, 64):
        mine.job_slots = theirs.job_slots = slots
        sched = mine._pack_tiles(order, qt, qv, 64)
        assert sched == theirs._pack_tiles(order, qt, qv, 64)
        widths |= {w for _, _, w, _ in sched}
    assert widths == {64, 32, 16}

    lens = np.diff(theirs.index.offsets)
    cost = (lens[qt] * (qv > 0)).sum(1)
    hot = int(np.median(cost))
    runs = {}
    for name, mod, kw in (("ref", ref, {}), ("port", port, {"device": "cpu"})):
        sr = mod.SparseRetrieval(model, index_dir, topk=TOPK, query_tile=8,
                                 engine="segsort", hot_postings=hot, **kw)
        runs[name] = sr.retrieve(q_batches)
        assert sr.hot_queries == int((cost > hot).sum()) > 0
    assert runs["port"][0] == runs["ref"][0]
    assert runs["port"][1]["hot_queries"] == runs["ref"][1]["hot_queries"]
    assert set(runs["port"][1]) == Q_STATS_KEYS

    sr = port.SparseRetrieval(model, index_dir, topk=TOPK, query_tile=8,
                              engine="segsort", device="cpu")
    rep_batches = [{"rep": reps[i:i + 5], "ids": [f"q{j}" for j in
                                                   range(i, min(i + 5, 23))]}
                   for i in range(0, 23, 5)]
    sparse_batches = [{"q_terms": qt[i:i + 5], "q_vals": qv[i:i + 5],
                       "ids": [f"q{j}" for j in range(i, min(i + 5, 23))]}
                      for i in range(0, 23, 5)]
    for batches in (q_batches, rep_batches, sparse_batches):
        assert sr.retrieve(batches)[0] == runs["ref"][0]
    with pytest.raises(ValueError, match="mixed"):
        sr.retrieve([rep_batches[0], sparse_batches[1]])


def test_write_run_false_and_engine_choice(setup, tmp_path):
    model, index_dir, q_batches, _ = setup
    sr = port.SparseRetrieval(model, index_dir, out_dir=str(tmp_path),
                              topk=TOPK, engine="auto", device="cpu")
    assert sr.engine == "xla"
    run, stats = sr.retrieve(q_batches, return_run=False, write_run=False)
    assert run == {} and not (tmp_path / "run.json").exists()
    with open(tmp_path / "q_stats.json") as f:
        assert json.load(f)["retrieval_qps"] == stats["retrieval_qps"]
    for engine, backend in (("auto", "cpu"), ("auto", "cuda"),
                            ("maxscore", "cpu")):
        want = ref.resolve_engine(engine, "cpu" if backend == "cpu" else "tpu")
        assert port.resolve_engine(engine, backend) == want
    assert port.resolve_engine("auto") == "segsort"
    # engine "cpp" (the host C++ engine) gives the segsort engine's run,
    # tie-equal at rtol 0 (the reps are multiples of 0.5: exact sums)
    runs = {}
    for engine in ("cpp", "segsort"):
        runs[engine], st = port.SparseRetrieval(
            model, index_dir, topk=10, engine=engine,
            device="cpu").retrieve(q_batches)
    assert st["L0_q"] > 0 and len(runs["cpp"]) == len(runs["segsort"]) == 23
    for qid, want in runs["segsort"].items():
        w = sorted(want.items(), key=lambda kv: -kv[1])
        g = sorted(runs["cpp"][qid].items(), key=lambda kv: -kv[1])
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=0.0)
    # a mesh of four CPU entries: the sharded segsort engine, the same run
    mesh = make_mesh(devices=["cpu"] * 4)
    sr = port.SparseRetrieval(model, index_dir, topk=10, engine="segsort",
                              mesh=mesh)
    assert len(sr._seg.shards) == 4 and sr.device == torch.device("cpu")
    run_mesh, _ = sr.retrieve(q_batches)
    for qid, want in runs["segsort"].items():
        w = sorted(want.items(), key=lambda kv: -kv[1])
        g = sorted(run_mesh[qid].items(), key=lambda kv: -kv[1])
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=0.0)


@pytest.mark.parametrize("engine", ["auto", "segsort", "xla", "maxscore",
                                    "bmx"])
def test_default_device_is_cuda_without_fallback(setup, engine):
    """Built with the default device, every engine asks for CUDA: on a
    machine without it, construction raises rather than running on the
    CPU."""
    model, index_dir, _, _ = setup
    if torch.cuda.is_available():
        sr = port.SparseRetrieval(model, index_dir, engine=engine)
        assert sr.device.type == "cuda"
        assert sr.engine == ("segsort" if engine == "auto" else engine)
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        port.SparseRetrieval(model, index_dir, engine=engine)


def _port_config(ref_cfg):
    from scaling_retriever_tpu_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)
          if f.name in fields and f.name not in ("dtype", "param_dtype")}
    return ModelConfig(**kw)


def test_tiny_llama_runs_are_tie_equal(tmp_path_factory):
    """Token batches through the JAX LlamaBiSparse and through the port's
    (weights carried across) over one index: tie-equal runs, rtol 1e-4."""
    from scaling_retriever_tpu.index.inverted_index import SparseIndex
    from scaling_retriever_tpu.models.encoder import LlamaBiSparse as RefEnc
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
    from scaling_retriever_tpu_torch.models.weights import params_from_jax

    root = tmp_path_factory.mktemp("tiny_llama")
    ref_model = RefEnc.load(make_tiny_llama_dir(str(root / "m")))
    cfg = _port_config(ref_model.config)
    tree = jax.tree_util.tree_map(np.asarray, ref_model.params)
    model = LlamaBiSparse(params_from_jax(tree, cfg, "cpu"), cfg)
    rng = np.random.default_rng(7)
    vocab = cfg.vocab_size
    n = 60
    rows = np.repeat(np.arange(n), 20)
    cols = np.concatenate([rng.choice(vocab, 20, replace=False)
                           for _ in range(n)])
    vals = rng.uniform(0.1, 2.0, len(rows)).astype(np.float32)
    SparseIndex.from_triples(rows, cols, vals, [f"d{i}" for i in range(n)],
                             vocab).save(str(root / "idx"))
    batches = []
    for s in range(0, 6, 3):
        ids = rng.integers(4, vocab, (3, 9)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[0, :4] = 0
        ids[mask == 0] = 0
        batches.append({"input_ids": ids, "attention_mask": mask,
                        "ids": [f"q{s + i}" for i in range(3)]})
    kw = dict(topk=15, engine="segsort", query_tile=4)
    want, _ = ref.SparseRetrieval(ref_model, str(root / "idx"),
                                  **kw).retrieve(batches)
    got, _ = port.SparseRetrieval(model, str(root / "idx"), device="cpu",
                                  **kw).retrieve(batches)
    assert got.keys() == want.keys() and len(got) == 6
    for qid in want:
        w = sorted(want[qid].items(), key=lambda kv: -kv[1])
        g = sorted(got[qid].items(), key=lambda kv: -kv[1])
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=1e-4)
