"""The port's CLIs from a checkpoint on disk against the JAX package's
(CPU, a tiny HF Llama with its tokenizer, ``make_msmarco_style_data``):
``eval_sparse`` indexing → encode_queries → retrieval (from the reps file
and from query text) → evaluate_msmarco, ``eval_dense`` write_doc_embeds →
retrieval → evaluate_msmarco, and the server CLI answering a text query.
The indexing step runs as ``python -m`` in a subprocess; the others go
through each CLI's ``main(argv)``. Index values and query reps are held
to the encoders' tolerance (rtol 1e-4, atol 1e-5; the frameworks sum the
matmuls in different orders), the index's structure and doc ids exactly,
runs tie-equal at rtol 1e-4 (dense: atol 2e-4, from its bf16 store), and
perf.json exactly."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_msmarco_style_data, make_tiny_llama_dir  # noqa: E402

from scaling_retriever_tpu.evaluation import eval_dense as ref_dense  # noqa: E402
from scaling_retriever_tpu.evaluation import eval_sparse as ref_sparse  # noqa: E402
from scaling_retriever_tpu_torch.evaluation import eval_dense, eval_sparse  # noqa: E402
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex  # noqa: E402
from scaling_retriever_tpu_torch.serving import server as srv  # noqa: E402
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("text_cli")
    model_dir = make_tiny_llama_dir(str(root / "model"))
    corpus, queries, qrel = make_msmarco_style_data(str(root / "data"))
    return root, model_dir, corpus, queries, qrel


def _load(path):
    with open(path) as f:
        return json.load(f)


def _same_run(got, want, atol=1e-6):
    assert got.keys() == want.keys() and len(got) == 8
    for qid in want:
        w = sorted(want[qid].items(), key=lambda kv: -kv[1])
        g = sorted(got[qid].items(), key=lambda kv: -kv[1])
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=1e-4,
                       atol=atol)


def test_sparse_cli_chain_matches_reference(data):
    root, model_dir, corpus, queries, qrel = data
    common = ["--model_name_or_path", model_dir, "--data_source", "msmarco",
              "--eval_batch_size", "16", "--doc_max_length", "24",
              "--query_max_length", "16"]
    out = {}
    for name in ("ref", "port"):
        d = root / name
        index_argv = ["--task_name", "indexing", "--corpus_path", corpus,
                      "--index_dir", str(d / "index"),
                      "--index_sparsify_t", "64"] + common
        if name == "ref":
            ref_sparse.main(index_argv)
            mod, dev = ref_sparse, []
        else:
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            proc = subprocess.run(
                [sys.executable, "-m",
                 "scaling_retriever_tpu_torch.evaluation.eval_sparse"]
                + index_argv + ["--device", "cpu"], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-3000:]
            mod, dev = eval_sparse, ["--device", "cpu"]
        reps = str(d / "reps.npz")
        mod.main(["--task_name", "encode_queries", "--query_path", queries,
                  "--query_reps_path", reps, "--out_dir", str(d)]
                 + common + dev)
        for src, extra in (("reps", ["--query_reps_path", reps]),
                           ("text", ["--query_path", queries])):
            mod.main(["--task_name", "retrieval", "--index_dir",
                      str(d / "index"), "--out_dir", str(d / src),
                      "--top_k", "20"] + extra + common + dev)
            mod.main(["--task_name", "evaluate_msmarco", "--eval_qrel_path",
                      qrel, "--eval_run_path", str(d / src / "run.json"),
                      "--out_dir", str(d / src), "--eval_metric",
                      "['mrr_10', 'recall']"])
        out[name] = d
    p_idx = SparseIndex.load(str(out["port"] / "index"))
    r_idx = SparseIndex.load(str(out["ref"] / "index"))
    np.testing.assert_array_equal(p_idx.offsets, r_idx.offsets)
    np.testing.assert_array_equal(p_idx.doc_rows, r_idx.doc_rows)
    np.testing.assert_allclose(p_idx.values, r_idx.values, rtol=1e-4,
                               atol=1e-5)
    assert p_idx.doc_ids == r_idx.doc_ids and p_idx.nb_docs() == 50
    pr, rr = (np.load(str(out[n] / "reps.npz"), allow_pickle=True)
              for n in ("port", "ref"))
    assert pr["ids"].tolist() == rr["ids"].tolist()
    np.testing.assert_allclose(pr["q_vals"], rr["q_vals"], rtol=1e-4,
                               atol=1e-5)
    for src in ("reps", "text"):
        _same_run(_load(out["port"] / src / "run.json"),
                  _load(out["ref"] / src / "run.json"))
        assert (_load(out["port"] / src / "perf.json")
                == _load(out["ref"] / src / "perf.json"))
    # the same encoder reads the same queries both ways
    _same_run(_load(out["port"] / "text" / "run.json"),
              _load(out["port"] / "reps" / "run.json"))
    assert _load(out["port"] / "text" / "perf.json")["mrr_10"]["mrr_10"] > 0


def test_dense_cli_chain_matches_reference(data):
    root, model_dir, corpus, queries, qrel = data
    common = ["--model_name_or_path", model_dir, "--data_source", "msmarco",
              "--eval_batch_size", "16", "--doc_max_length", "24",
              "--query_max_length", "16"]
    for name, mod, dev in (("ref", ref_dense, []),
                           ("port", eval_dense, ["--device", "cpu"])):
        d = root / f"dense_{name}"
        mod.main(["--task_name", "write_doc_embeds", "--corpus_path", corpus,
                  "--doc_embed_dir", str(d / "emb")] + common + dev)
        mod.main(["--task_name", "retrieval", "--query_path", queries,
                  "--doc_embed_dir", str(d / "emb"), "--out_dir",
                  str(d / "out"), "--top_k", "20"] + common + dev)
        mod.main(["--task_name", "evaluate_msmarco", "--eval_qrel_path", qrel,
                  "--eval_run_path", str(d / "out" / "run.json"),
                  "--out_dir", str(d / "out")])
    p, r = root / "dense_port", root / "dense_ref"
    np.testing.assert_allclose(np.load(p / "emb" / "embs_0_0.npy"),
                               np.load(r / "emb" / "embs_0_0.npy"),
                               rtol=1e-4, atol=1e-6)
    # both flat indexes store bf16 docs: an embedding element that the
    # encoders' 1e-6 noise rounds to the neighbouring bf16 value moves a
    # unit-norm score by up to ~2^-8 * |q_i d_i| (< 2e-4 at width 64)
    _same_run(_load(p / "out" / "run.json"), _load(r / "out" / "run.json"),
              atol=2e-4)
    assert (_load(p / "out" / "perf.json") == _load(r / "out" / "perf.json"))


class _Httpd:
    """What the server CLI uses of what ``serve_http`` returns; its
    ``serve_forever`` runs ``fn`` inside the started server."""

    server_address = ("127.0.0.1", 5124)

    def __init__(self, fn):
        self.fn = fn

    def serve_forever(self):
        self.fn()

    def server_close(self):
        pass


def test_server_cli_answers_text_from_checkpoint(data, monkeypatch):
    """``--model_name_or_path``: a text query through the encoder frontend
    equals the brute-force top-k of the same encoder's top-64 reps over
    the index."""
    root, model_dir, corpus, queries, _ = data
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse

    index_dir = str(root / "srv_index")
    eval_sparse.main(["--task_name", "indexing", "--model_name_or_path",
                      model_dir, "--corpus_path", corpus, "--index_dir",
                      index_dir, "--data_source", "msmarco",
                      "--doc_max_length", "24", "--device", "cpu"])
    text = "w150 w151 w42"
    captured = {}

    def fake_serve(server, host, port, block=True, frontend=None):
        def run():
            captured["res"] = frontend.search_text(text, 10)
        return _Httpd(run)

    monkeypatch.setattr(srv, "serve_http", fake_serve)
    srv.main(["--index_dir", index_dir, "--model_name_or_path", model_dir,
              "--topk", "10", "--width", "4", "--encode_widths", "4",
              "--query_max_length", "16", "--device", "cpu"])
    ids, scores = captured["res"]
    model = LlamaBiSparse.load(model_dir, device="cpu")
    from transformers import AutoTokenizer
    enc = AutoTokenizer.from_pretrained(model_dir)([text], return_tensors="np")
    # the frontend keeps each query's top --t_sparse (64) terms
    q_v, q_t = torch.topk(model.encode(enc["input_ids"],
                                       enc["attention_mask"]), 64)
    q_t, q_v = q_t.numpy(), q_v.clamp_min(0).numpy()
    idx = SparseIndex.load(index_dir)
    dense = np.zeros((idx.nb_docs(), idx.dim), np.float32)
    for t in range(idx.dim):
        r, v = idx.posting(t)
        dense[r, t] = v
    s = dense[:, q_t[0]] @ q_v[0]
    order = np.argsort(-s, kind="stable")[:10]
    tie_equal_topk(ids, scores, [idx.doc_ids[i] for i in order], s[order],
                   rtol=1e-5, atol=1e-6)
    with pytest.raises(SystemExit):
        srv.main(["--dense_index_dir", index_dir, "--model_name_or_path",
                  model_dir, "--device", "cpu"])
