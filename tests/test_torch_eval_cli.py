"""The port's eval CLI (scaling_retriever_tpu_torch/evaluation/eval_sparse.py)
against the JAX package's on one index and one query stream, both written
by the reference's CLI (``indexing``, ``encode_queries``) from a tiny HF
Llama: ``retrieval`` (``--device cpu``, sparse and dense reps, ``--passes
2``), ``evaluate_msmarco`` and ``evaluate_beir``, and ``beir_results``.
The index holds the encoder's real-valued impacts, so the two packages
may round a sum differently: runs are compared tie-equal at rtol 1e-6
(same queries, same doc ids above the boundary); perf.json is compared
exactly on one shared run."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_msmarco_style_data, make_tiny_llama_dir  # noqa: E402

from scaling_retriever_tpu.evaluation import beir_results as ref_beir  # noqa: E402
from scaling_retriever_tpu.evaluation import eval_sparse as ref  # noqa: E402
from scaling_retriever_tpu_torch.evaluation import beir_results  # noqa: E402
from scaling_retriever_tpu_torch.evaluation import eval_sparse as port  # noqa: E402
from scaling_retriever_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    model_dir = make_tiny_llama_dir(str(root / "model"))
    corpus, queries, qrel = make_msmarco_style_data(str(root / "data"))
    index_dir = str(root / "index")
    ref.main(["--task_name", "indexing", "--model_name_or_path", model_dir,
              "--corpus_path", corpus, "--index_dir", index_dir,
              "--eval_batch_size", "16", "--doc_max_length", "24",
              "--data_source", "msmarco"])
    reps = {}
    for fmt in ("sparse", "dense"):
        reps[fmt] = str(root / f"reps_{fmt}.npz")
        ref.main(["--task_name", "encode_queries", "--model_name_or_path",
                  model_dir, "--query_path", queries, "--query_reps_path",
                  reps[fmt], "--reps_format", fmt, "--eval_batch_size", "8",
                  "--query_max_length", "16", "--data_source", "msmarco",
                  "--out_dir", str(root)])
    return str(root), index_dir, reps, qrel


def _load(out_dir, name):
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


def _same_run(got, want):
    assert got.keys() == want.keys() and len(got) == 8
    for qid in want:
        w = sorted(want[qid].items(), key=lambda kv: -kv[1])
        g = sorted(got[qid].items(), key=lambda kv: -kv[1])
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=1e-6)


@pytest.mark.parametrize("fmt,engine", [("sparse", "segsort"),
                                        ("dense", "auto")])
def test_retrieval_matches_reference(setup, fmt, engine):
    root, index_dir, reps, qrel = setup
    outs = {}
    for name, mod, extra in (("ref", ref, []),
                             ("port", port, ["--device", "cpu"])):
        outs[name] = os.path.join(root, f"{name}_{fmt}_{engine}")
        mod.main(["--task_name", "retrieval", "--query_reps_path", reps[fmt],
                  "--index_dir", index_dir, "--out_dir", outs[name],
                  "--top_k", "10", "--eval_batch_size", "3",
                  "--engine", engine, "--passes", "2", "--query_tile", "8"]
                 + extra)
    _same_run(_load(outs["port"], "run.json"), _load(outs["ref"], "run.json"))
    qs_ref, qs = (_load(outs[n], "q_stats.json") for n in ("ref", "port"))
    assert set(qs) == set(qs_ref)
    strip = [{k: v for k, v in p.items()
              if k in ("pass", "warmup_tiles")} for p in qs["passes"]]
    assert strip == [{k: v for k, v in p.items()
                      if k in ("pass", "warmup_tiles")}
                     for p in qs_ref["passes"]]
    assert [set(p) for p in qs["passes"]] == [set(p)
                                              for p in qs_ref["passes"]]
    # one pass writes the same run as two
    single = os.path.join(root, f"port_single_{fmt}_{engine}")
    port.main(["--task_name", "retrieval", "--query_reps_path", reps[fmt],
               "--index_dir", index_dir, "--out_dir", single, "--top_k", "10",
               "--engine", engine, "--device", "cpu", "--query_tile", "8"])
    assert _load(single, "run.json") == _load(outs["port"], "run.json")

    # evaluate_msmarco on the reference's run: the same perf.json
    for name, mod in (("ref", ref), ("port", port)):
        mod.main(["--task_name", "evaluate_msmarco", "--eval_qrel_path",
                  qrel, "--eval_run_path",
                  os.path.join(outs["ref"], "run.json"),
                  "--eval_metric", "['mrr_10','recall','ndcg_cut']",
                  "--out_dir", os.path.join(root, f"eval_{name}_{fmt}")])
    assert _load(os.path.join(root, f"eval_port_{fmt}"), "perf.json") == \
        _load(os.path.join(root, f"eval_ref_{fmt}"), "perf.json")


def test_beir_tasks_match_reference(setup, tmp_path):
    root, *_ = setup
    ds_dir = tmp_path / "beir" / "toy"
    (ds_dir / "qrels").mkdir(parents=True)
    rng = np.random.default_rng(0)
    with open(ds_dir / "corpus.jsonl", "w") as f:
        for d in range(20):
            f.write(json.dumps({"_id": f"d{d}", "title": f"t{d}",
                                "text": f"w{d}"}) + "\n")
    with open(ds_dir / "queries.jsonl", "w") as f:
        for q in range(5):
            f.write(json.dumps({"_id": f"q{q}", "text": f"w{q}"}) + "\n")
    with open(ds_dir / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for q in range(4):
            f.write(f"q{q}\td{q}\t1\nq{q}\td{q + 5}\t2\n")
    run = {f"q{q}": {f"d{d}": float(rng.integers(0, 6)) / 2
                     for d in rng.choice(20, 12, replace=False)}
           for q in range(5)}
    run["q1"]["q1"] = 5.0
    common = ["--is_beir", "--beir_dataset", "toy", "--beir_dataset_dir",
              str(tmp_path / "beir")]
    for name, mod in (("ref", ref), ("port", port)):
        out = tmp_path / name / "toy"
        out.mkdir(parents=True)
        (out / "run.json").write_text(json.dumps(run))
        mod.main(["--task_name", "evaluate_beir", "--out_dir", str(out)]
                 + common)
    assert _load(str(tmp_path / "port" / "toy"), "perf.json") == \
        _load(str(tmp_path / "ref" / "toy"), "perf.json")
    # beir_results over a suite where one dataset has no perf.json
    (tmp_path / "port" / "nfcorpus").mkdir()
    (tmp_path / "port" / "nfcorpus" / "perf.json").write_text(
        json.dumps({"NDCG@10": 0.25, "Recall@100": 0.5, "R_cap@100": 0.75}))
    args = ["--beir_eval_dir", str(tmp_path / "port"), "--datasets", "toy",
            "nfcorpus", "scifact"]
    assert beir_results.main(args) == ref_beir.main(args)
    with pytest.raises(FileNotFoundError):
        port.main(["--task_name", "evaluate_beir", "--out_dir",
                   str(tmp_path), "--is_beir", "--beir_dataset", "nope",
                   "--beir_dataset_dir", str(tmp_path / "beir")])


@pytest.mark.parametrize("fmt,engine", [("sparse", "segsort"),
                                        ("dense", "auto")])
def test_use_mesh_matches_reference(setup, monkeypatch, fmt, engine):
    """--use_mesh over eight devices: the JAX package's virtual CPU devices,
    and ``["cpu"] * 8`` in the port (``local_devices`` monkeypatched): the
    sharded engine (segsort) or the doc-sharded scan (auto = xla on the
    CPU), the same runs as the reference's and as the one-device path."""
    root, index_dir, reps, _ = setup
    monkeypatch.setattr(mesh_lib, "local_devices",
                        lambda device: [torch.device("cpu")] * 8)
    made = []
    real_make = mesh_lib.make_mesh
    monkeypatch.setattr(mesh_lib, "make_mesh",
                        lambda **kw: made.append(real_make(**kw)) or made[-1])
    outs = {}
    for name, mod, extra in (("ref", ref, []),
                             ("port", port, ["--device", "cpu"]),
                             ("one", port, ["--device", "cpu"])):
        outs[name] = os.path.join(root, f"mesh_{name}_{fmt}_{engine}")
        mod.main(["--task_name", "retrieval", "--query_reps_path", reps[fmt],
                  "--index_dir", index_dir, "--out_dir", outs[name],
                  "--top_k", "10", "--engine", engine, "--query_tile", "8"]
                 + extra + (["--use_mesh"] if name != "one" else []))
    assert len(made) == 1 and made[0].size == 8
    _same_run(_load(outs["port"], "run.json"), _load(outs["ref"], "run.json"))
    _same_run(_load(outs["port"], "run.json"), _load(outs["one"], "run.json"))


def test_unported_tasks_raise(setup, tmp_path):
    """--use_mesh on one device runs the one-device path (as the reference
    does on one chip) into the same run.json; the text tasks look for their
    checkpoint on disk and fetch nothing."""
    root, index_dir, reps, _ = setup
    for name, extra in (("mesh", ["--use_mesh"]), ("plain", [])):
        port.main(["--task_name", "retrieval", "--index_dir", index_dir,
                   "--out_dir", str(tmp_path / name), "--query_reps_path",
                   reps["sparse"], "--device", "cpu"] + extra)
    assert _load(str(tmp_path / "mesh"), "run.json") == \
        _load(str(tmp_path / "plain"), "run.json")
    missing = str(tmp_path / "no_model")
    for argv in (
            ["--task_name", "indexing", "--index_dir", str(tmp_path),
             "--corpus_path", "c.tsv"],
            ["--task_name", "encode_queries", "--query_path", "q.tsv"],
            ["--task_name", "retrieval", "--index_dir", index_dir,
             "--out_dir", str(tmp_path), "--query_path", "q.tsv"]):
        with pytest.raises(OSError):
            port.main(argv + ["--model_name_or_path", missing,
                              "--device", "cpu"])
    assert port.build_parser().parse_args(
        ["--task_name", "retrieval"]).device == "cuda"
