"""The port's dense evaluation path (store_embs, eval_dense's retrieval,
evaluate_msmarco and evaluate_beir) against the JAX package's on one tiny
MSMARCO-style corpus and a toy BEIR set.

The JAX CLI loads its encoder and tokenizer from a checkpoint; here both
are swapped for the same objects the port's task bodies take as arguments.
A fake encoder with dyadic positive outputs makes every score exact in
bf16 and f32, so the embedding artifacts are byte-equal and run.json and
perf.json are equal (top_k covers the corpus: no tie at a k boundary); a
tiny LlamaBiDense (weights carried across) gives tie-equal runs, rtol
1e-4.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_msmarco_style_data  # noqa: E402

from scaling_retriever_tpu.evaluation import eval_dense as ref  # noqa: E402
from scaling_retriever_tpu.index import indexer as ref_indexer  # noqa: E402
from scaling_retriever_tpu_torch.data.loader import DataLoader  # noqa: E402
from scaling_retriever_tpu_torch.data.prefetch import PrefetchLoader  # noqa: E402
from scaling_retriever_tpu_torch.evaluation import eval_dense as port  # noqa: E402
from scaling_retriever_tpu_torch.index import indexer as port_indexer  # noqa: E402
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk  # noqa: E402

torch.set_num_threads(1)

H = 16


class WordTokenizer:
    """Texts of "w<id>" words → ids, left-padded (the Hugging Face call
    protocol the collators use)."""

    def __call__(self, texts, truncation=True, max_length=None,
                 padding="longest", pad_to_multiple_of=None,
                 return_attention_mask=True):
        toks = [[int(w[1:]) % 256 for w in t.split()][:max_length]
                for t in texts]
        n = (max_length if padding == "max_length"
             else max(len(t) for t in toks))
        if pad_to_multiple_of:
            n = -(-n // pad_to_multiple_of) * pad_to_multiple_of
        ids = np.zeros((len(texts), n), np.int32)
        mask = np.zeros((len(texts), n), np.int32)
        for i, t in enumerate(toks):
            ids[i, n - len(t):] = t
            mask[i, n - len(t):] = 1
        return {"input_ids": ids, "attention_mask": mask}


class FakeDenseEncoder:
    """Positive dyadic vectors from the token ids (exact in bf16)."""

    hidden_size = H

    def encode(self, input_ids, attention_mask):
        ids = np.asarray(input_ids)
        mask = np.asarray(attention_mask)
        out = np.zeros((len(ids), H), np.float32)
        for j in range(ids.shape[1]):
            out[np.arange(len(ids)), ids[:, j] % H] += mask[:, j] / 8.0
        return out + 1.0 / 16


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense_eval")
    corpus, queries, qrel = make_msmarco_style_data(str(root / "data"))
    return root, corpus, queries, qrel


def _args(mod, task, **kw):
    argv = ["--task_name", task]
    for k, v in kw.items():
        argv += [f"--{k}"] + ([] if v is True else [str(v)])
    return mod.build_parser().parse_args(argv)


def _ref_with(monkeypatch, model, tok):
    monkeypatch.setattr(ref, "_load_model", lambda args: model)
    monkeypatch.setattr(ref, "_tokenizer", lambda args: tok)


@pytest.mark.parametrize("use_fp16", [False, True])
def test_store_embs_artifacts_byte_equal(tmp_path, use_fp16):
    """Three chunks (chunk_size 2 batches of 8) of the same batches: every
    file's bytes are the reference's; PrefetchLoader keeps the order."""
    from scaling_retriever_tpu_torch.data.collators import \
        LlamaDenseCollectionCollator

    texts = [(f"d{i}", " ".join(f"w{(i * 7 + j) % 200}" for j in range(5)))
             for i in range(40)]
    loader = DataLoader(texts, 8, LlamaDenseCollectionCollator(
        WordTokenizer(), 12))
    model = FakeDenseEncoder()
    a, b = tmp_path / "ref", tmp_path / "port"
    ref_indexer.store_embs(model, loader, 0, str(a), chunk_size=16,
                           use_fp16=use_fp16, world_size=1)
    port_indexer.store_embs(model, PrefetchLoader(loader, depth=2), 0,
                            str(b), chunk_size=16, use_fp16=use_fp16,
                            world_size=1)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 7
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert port_indexer.obtain_doc_vec_dir_files(str(b)) == tuple(
        [str(b / f"{p}_0_{c}.npy") for c in range(3)] for p in ("embs", "ids"))


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_write_embeds_retrieval_and_evaluate_match_reference(
        data, tmp_path, monkeypatch, quantize):
    root, corpus, queries, qrel = data
    model, tok = FakeDenseEncoder(), WordTokenizer()
    _ref_with(monkeypatch, model, tok)
    runs, perfs = {}, {}
    for name, mod in (("ref", ref), ("port", port)):
        emb = tmp_path / name / "embeds"
        out = tmp_path / name / "out"
        common = dict(data_source="msmarco", eval_batch_size=8)
        wargs = _args(mod, "write_doc_embeds", corpus_path=corpus,
                      doc_embed_dir=emb, doc_max_length=24, **common)
        rargs = _args(mod, "retrieval", query_path=queries,
                      doc_embed_dir=emb, out_dir=out, query_max_length=16,
                      top_k=100, **common,
                      **({"quantize": quantize} if quantize else {}))
        if mod is ref:
            mod.write_doc_embeds(wargs)
            mod.dense_retrieval(rargs)
        else:
            rargs.device = "cpu"
            mod.write_doc_embeds(wargs, model=model, tokenizer=tok)
            mod.dense_retrieval(rargs, model=model, tokenizer=tok)
        with open(out / "run.json") as f:
            runs[name] = json.load(f)
        mod.main(["--task_name", "evaluate_msmarco", "--eval_qrel_path",
                  qrel, "--eval_run_path", str(out / "run.json"),
                  "--eval_metric", "['mrr_10','recall']", "--out_dir",
                  str(out)])
        with open(out / "perf.json") as f:
            perfs[name] = json.load(f)
    for f in sorted(os.listdir(tmp_path / "ref" / "embeds")):
        assert ((tmp_path / "ref" / "embeds" / f).read_bytes()
                == (tmp_path / "port" / "embeds" / f).read_bytes()), f
    assert len(runs["port"]) == 8
    assert all(len(v) == 50 for v in runs["port"].values())
    assert runs["port"] == runs["ref"]
    assert perfs["port"] == perfs["ref"]


def test_tiny_llama_dense_runs_tie_equal(data, tmp_path, monkeypatch,
                                         tiny_config):
    """The JAX LlamaBiDense and the port's (weights carried across) through
    the whole retrieval body: tie-equal runs at rtol 1e-4."""
    import dataclasses

    from scaling_retriever_tpu.models import llama as ref_llama
    from scaling_retriever_tpu.models.encoder import LlamaBiDense as RefDense
    from scaling_retriever_tpu_torch.models.config import ModelConfig
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiDense
    from scaling_retriever_tpu_torch.models.weights import params_from_jax

    root, corpus, queries, _ = data
    params = ref_llama.init_params(tiny_config, jax.random.PRNGKey(5))
    ref_model = RefDense(params, tiny_config)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pcfg = ModelConfig(**{f.name: getattr(tiny_config, f.name)
                          for f in dataclasses.fields(tiny_config)
                          if f.name in fields
                          and f.name not in ("dtype", "param_dtype")})
    model = LlamaBiDense(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pcfg, "cpu"), pcfg)
    tok = WordTokenizer()
    _ref_with(monkeypatch, ref_model, tok)
    runs = {}
    for name, mod, m in (("ref", ref, None), ("port", port, model)):
        emb, out = tmp_path / name / "embeds", tmp_path / name / "out"
        common = dict(data_source="msmarco", eval_batch_size=8)
        wargs = _args(mod, "write_doc_embeds", corpus_path=corpus,
                      doc_embed_dir=emb, doc_max_length=24, **common)
        rargs = _args(mod, "retrieval", query_path=queries,
                      doc_embed_dir=emb, out_dir=out, query_max_length=16,
                      top_k=10, **common)
        if m is None:
            mod.write_doc_embeds(wargs)
            mod.dense_retrieval(rargs)
        else:
            rargs.device = "cpu"
            mod.write_doc_embeds(wargs, model=m, tokenizer=tok)
            mod.dense_retrieval(rargs, model=m, tokenizer=tok)
        with open(out / "run.json") as f:
            runs[name] = json.load(f)
    assert runs["port"].keys() == runs["ref"].keys() and len(runs["ref"]) == 8
    for qid, want in runs["ref"].items():
        w = sorted(want.items(), key=lambda kv: -kv[1])
        g = sorted(runs["port"][qid].items(), key=lambda kv: -kv[1])
        assert all(abs(s) <= 1.01 for _, s in g)
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=1e-4,
                       atol=1e-6)


def test_beir_tasks_match_reference(tmp_path, monkeypatch):
    ds = tmp_path / "beir" / "toy"
    (ds / "qrels").mkdir(parents=True)
    with open(ds / "corpus.jsonl", "w") as f:
        for d in range(20):
            f.write(json.dumps({"_id": f"d{d}", "title": f"w{150 + d % 5}",
                                "text": f"w{10 + d} w{20 + d}"}) + "\n")
    with open(ds / "queries.jsonl", "w") as f:
        for q in range(4):
            f.write(json.dumps({"_id": f"q{q}", "text": f"w{150 + q}"})
                    + "\n")
    with open(ds / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for q in range(4):
            f.write(f"q{q}\td{q}\t1\n")
    model, tok = FakeDenseEncoder(), WordTokenizer()
    _ref_with(monkeypatch, model, tok)
    perfs = {}
    for name, mod in (("ref", ref), ("port", port)):
        emb, out = tmp_path / name / "emb", tmp_path / name / "out"
        common = dict(is_beir=True, beir_dataset="toy",
                      beir_dataset_dir=tmp_path / "beir", eval_batch_size=4)
        wargs = _args(mod, "write_doc_embeds", doc_embed_dir=emb,
                      doc_max_length=16, **common)
        rargs = _args(mod, "retrieval", doc_embed_dir=emb, out_dir=out,
                      top_k=20, **common)
        if mod is ref:
            mod.write_doc_embeds(wargs)
            mod.dense_retrieval(rargs)
        else:
            rargs.device = "cpu"
            mod.write_doc_embeds(wargs, model=model, tokenizer=tok)
            mod.dense_retrieval(rargs, model=model, tokenizer=tok)
        mod.main(["--task_name", "evaluate_beir", "--out_dir", str(out),
                  "--is_beir", "--beir_dataset", "toy",
                  "--beir_dataset_dir", str(tmp_path / "beir")])
        with open(out / "perf.json") as f:
            perfs[name] = json.load(f)
    assert set(perfs["port"]) == {"NDCG@10", "Recall@100", "R_cap@100"}
    assert perfs["port"] == perfs["ref"]


@pytest.mark.parametrize("n_dev", [8, 3])
def test_use_mesh_matches_reference(data, tmp_path, monkeypatch, n_dev):
    """--use_mesh over the JAX package's eight virtual CPU devices and over
    ``["cpu"] * n_dev`` in the port (``local_devices`` monkeypatched):
    MeshDenseRetriever in bf16 on both sides, equal runs (the fake
    encoder's dyadic vectors are exact in bf16; top_k covers the corpus, so
    no tie at a k boundary can change a run), and equal to the one-device
    retriever's run; its rows land on their shards from the files."""
    from scaling_retriever_tpu_torch.parallel import mesh as mesh_lib

    root, corpus, queries, _ = data
    model, tok = FakeDenseEncoder(), WordTokenizer()
    _ref_with(monkeypatch, model, tok)
    monkeypatch.setattr(mesh_lib, "local_devices",
                        lambda device: [torch.device("cpu")] * n_dev)
    emb = tmp_path / "embeds"
    common = dict(data_source="msmarco", eval_batch_size=8)
    port.write_doc_embeds(_args(port, "write_doc_embeds", corpus_path=corpus,
                                doc_embed_dir=emb, doc_max_length=24,
                                **common), model=model, tokenizer=tok)
    runs = {}
    for name, mod, mesh in (("ref", ref, True), ("port", port, True),
                            ("one", port, False)):
        out = tmp_path / name
        rargs = _args(mod, "retrieval", query_path=queries,
                      doc_embed_dir=emb, out_dir=out, query_max_length=16,
                      top_k=100, **common, **({"use_mesh": True}
                                              if mesh else {}))
        if mod is ref:
            mod.dense_retrieval(rargs)
        else:
            rargs.device = "cpu"
            mod.dense_retrieval(rargs, model=model, tokenizer=tok)
        with open(out / "run.json") as f:
            runs[name] = json.load(f)
    assert len(runs["port"]) == 8
    assert runs["port"] == runs["ref"] == runs["one"]
    # the placement: n rows split into equal chunk-aligned ranges
    r = port.MeshDenseRetriever(H, mesh_lib.make_mesh(devices=["cpu"] * 3),
                                chunk=16)
    r.index_encoded_data(str(emb))
    shards, row_ids = r._place()
    n = len(r.ids)
    assert n == 50 and [len(c) for c in shards] == [2, 2, 2]
    vecs = np.concatenate([np.load(f) for f in
                           port.obtain_doc_vec_dir_files(str(emb))[0]])
    got = torch.cat([torch.cat(c) for c in shards]).float().numpy()
    np.testing.assert_array_equal(got[:n], vecs)
    assert not got[n:].any()
    ids = torch.cat(row_ids)
    assert ids[:n].tolist() == list(range(n)) and (ids[n:] == -1).all()


def test_unported_paths_raise_naming_their_items(data, tmp_path):
    """The text tasks look for their checkpoint on disk and fetch nothing,
    --use_mesh included; MeshDenseRetriever builds over a mesh of repeated
    entries."""
    root, corpus, queries, _ = data
    with pytest.raises(OSError):
        port.main(["--task_name", "write_doc_embeds", "--corpus_path",
                   corpus, "--doc_embed_dir", str(tmp_path / "e"),
                   "--model_name_or_path", str(tmp_path / "m"),
                   "--device", "cpu"])
    with pytest.raises(OSError):
        port.main(["--task_name", "retrieval", "--query_path", queries,
                   "--doc_embed_dir", str(tmp_path / "e"), "--out_dir",
                   str(tmp_path / "o"), "--model_name_or_path",
                   str(tmp_path / "m"), "--device", "cpu"])
    with pytest.raises(OSError):
        port.main(["--task_name", "retrieval", "--query_path", queries,
                   "--doc_embed_dir", str(tmp_path / "e"), "--out_dir",
                   str(tmp_path / "o"), "--model_name_or_path",
                   str(tmp_path / "m"), "--use_mesh", "--device", "cpu"])
    from scaling_retriever_tpu_torch.parallel.mesh import make_mesh

    r = port.MeshDenseRetriever(16, make_mesh(devices=["cpu"] * 2))
    assert r.ids == [] and r.dtype == torch.bfloat16 and r.chunk == 8192
    assert port.build_parser().parse_args(
        ["--task_name", "retrieval"]).device == "cuda"
