"""The port's reranker CLI against the JAX package's (CPU, tiny widths):
the three bi-encoder types (splade, dense_encoder, hybrid_retriever) from
a peft adapter, pairs from a run.json and from a JSONL file sharded over
two ranks, and the cross-encoder, with and without a peft adapter, on a
tiny local HF classifier. Each output run holds exactly its input pairs.

Bi-encoder scores: rtol 1e-4, atol 1e-5 (the frameworks' matmul sum
orders differ). The cross-encoder is host torch in both packages: its
scores are equal."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import (make_msmarco_style_data,  # noqa: E402
                     make_tiny_llama_dir, make_tiny_tokenizer)

from scaling_retriever_tpu.evaluation import \
    eval_reranker as ref_reranker  # noqa: E402
from scaling_retriever_tpu_torch.evaluation import eval_reranker  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _write_config_base(adapter_dir, base_dir):
    path = os.path.join(adapter_dir, "adapter_config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["base_model_name_or_path"] = base_dir
    with open(path, "w") as f:
        json.dump(cfg, f)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(model dir, adapter dir, corpus, queries, run.json of 4 x 5
    pairs)."""
    from peft import LoraConfig, get_peft_model
    from transformers import AutoTokenizer, LlamaForCausalLM

    root = tmp_path_factory.mktemp("rr")
    model_dir = make_tiny_llama_dir(str(root / "model"))
    corpus, queries, _ = make_msmarco_style_data(str(root / "data"),
                                                 n_docs=20, n_queries=4)
    adapter_dir = str(root / "adapter")
    lm = get_peft_model(LlamaForCausalLM.from_pretrained(model_dir),
                        LoraConfig(r=4, lora_alpha=8,
                                   target_modules=["q_proj", "v_proj"]))
    torch.manual_seed(1)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if "lora_B" in name:
                p.normal_(0, 0.05)
    lm.save_pretrained(adapter_dir)
    _write_config_base(adapter_dir, model_dir)
    AutoTokenizer.from_pretrained(model_dir).save_pretrained(adapter_dir)
    run_path = str(root / "first_run.json")
    with open(run_path, "w") as f:
        json.dump({f"q{q}": {f"doc{d}": 1.0 for d in range(q, q + 5)}
                   for q in range(4)}, f)
    return model_dir, adapter_dir, corpus, queries, run_path


def _argv(setup, out, rerank_type, *extra):
    _, adapter_dir, corpus, queries, _ = setup
    return ["--query_path", queries, "--corpus_path", corpus,
            "--output_dir", out, "--rerank_type", rerank_type,
            "--peft_model_name", adapter_dir, "--query_max_length", "16",
            "--doc_max_length", "24", "--eval_batch_size", "8",
            "--data_source", "msmarco", *extra]


def _same_scores(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for q in want:
        assert got[q].keys() == want[q].keys(), q
        np.testing.assert_allclose([got[q][d] for d in want[q]],
                                   list(want[q].values()), rtol=rtol,
                                   atol=atol, err_msg=q)


@pytest.mark.parametrize("rerank_type",
                         ["splade", "dense_encoder", "hybrid_retriever"])
def test_bi_encoder_rerank_matches_reference(setup, tmp_path, rerank_type):
    run_path = setup[4]
    got = eval_reranker.main(_argv(setup, str(tmp_path / "port"),
                                   rerank_type, "--run_path", run_path,
                                   "--device", "cpu"))
    want = ref_reranker.main(_argv(setup, str(tmp_path / "ref"), rerank_type,
                                   "--run_path", run_path))
    _same_scores(got, want)
    with open(run_path) as f:
        pairs = {(q, d) for q, docs in json.load(f).items() for d in docs}
    assert {(q, d) for q, docs in got.items() for d in docs} == pairs
    with open(tmp_path / "port" / "run.json") as f:
        assert json.load(f) == got
    if rerank_type == "splade":
        assert all(s >= 0 for docs in got.values() for s in docs.values())


def test_jsonl_pairs_and_sharding(setup, tmp_path):
    jsonl = tmp_path / "pairs.jsonl"
    with open(jsonl, "w") as f:
        for q in range(4):
            f.write(json.dumps({"qid": f"q{q}", "docids": [
                f"doc{d}" for d in range(2 * q, 2 * q + 4)]}) + "\n")
    merged, merged_ref = {}, {}
    for rank in range(2):
        extra = ("--jsonl_path", str(jsonl), "--rank", str(rank),
                 "--world_size", "2", "--eval_batch_size", "4")
        out = str(tmp_path / "port")
        got = eval_reranker.main(_argv(setup, out, "dense_encoder", *extra,
                                       "--device", "cpu"))
        want = ref_reranker.main(_argv(setup, str(tmp_path / "ref"),
                                       "dense_encoder", *extra))
        _same_scores(got, want)
        with open(os.path.join(out, f"run_{rank}.json")) as f:
            assert json.load(f) == got
        for d, run in ((merged, got), (merged_ref, want)):
            for q, docs in run.items():
                d.setdefault(q, {}).update(docs)
    assert {(q, d) for q, docs in merged.items() for d in docs} == {
        (f"q{q}", f"doc{d}") for q in range(4)
        for d in range(2 * q, 2 * q + 4)}
    _same_scores(merged, merged_ref)
    assert not os.path.exists(tmp_path / "port" / "run.json")


def test_bi_encoder_body_takes_model_and_tokenizer(setup, tmp_path):
    """The body the card drives: a model and a tokenizer passed in, the
    same run as the CLI's."""
    from scaling_retriever_tpu_torch.index.hybrid import LlamaBiHybrid
    from scaling_retriever_tpu_torch.models.encoder import load_tokenizer

    _, adapter_dir, _, _, run_path = setup
    args = eval_reranker.build_parser().parse_args(_argv(
        setup, str(tmp_path), "hybrid_retriever", "--run_path", run_path,
        "--device", "cpu"))
    model = LlamaBiHybrid.load_from_lora(adapter_dir, device="cpu")
    got = eval_reranker.bi_encoder_rerank(
        args, eval_reranker.load_pairs(args), model=model,
        tokenizer=load_tokenizer(adapter_dir))
    assert got == eval_reranker.main(_argv(
        setup, str(tmp_path / "cli"), "hybrid_retriever", "--run_path",
        run_path, "--device", "cpu"))


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    """(base dir, adapter dir): a tiny BERT classifier with one label and
    its tokenizer, and a peft adapter on it whose config names it."""
    from peft import LoraConfig, get_peft_model
    from transformers import BertConfig, BertForSequenceClassification

    root = tmp_path_factory.mktemp("cls")
    base_dir, adapter_dir = str(root / "base"), str(root / "adapter")
    torch.manual_seed(0)
    model = BertForSequenceClassification(BertConfig(
        vocab_size=256, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, num_labels=1,
        max_position_embeddings=512)).eval()
    model.save_pretrained(base_dir)
    make_tiny_tokenizer(base_dir, padding_side="right")
    lm = get_peft_model(model, LoraConfig(r=4, lora_alpha=8,
                                          target_modules=["query", "value"]))
    torch.manual_seed(2)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if "lora_B" in name:
                p.normal_(0, 0.1)
    lm.save_pretrained(adapter_dir)
    _write_config_base(adapter_dir, base_dir)
    return base_dir, adapter_dir


@pytest.mark.parametrize("with_adapter", [False, True])
def test_cross_encoder_matches_reference(setup, classifier, tmp_path,
                                         with_adapter):
    base_dir, adapter_dir = classifier
    _, _, corpus, queries, run_path = setup
    model_args = (["--peft_model_name", adapter_dir] if with_adapter
                  else ["--model_name_or_path", base_dir])
    argv = ["--run_path", run_path, "--query_path", queries,
            "--corpus_path", corpus, "--rerank_type", "cross_encoder",
            "--max_length", "32", "--eval_batch_size", "6", *model_args]
    got = eval_reranker.main(["--output_dir", str(tmp_path / "port"),
                              "--device", "cpu", *argv])
    want = ref_reranker.main(["--output_dir", str(tmp_path / "ref"), *argv])
    assert got == want and len(got) == 4
    assert all(len(v) == 5 for v in got.values())


def test_cuda_default_raises_without_a_card(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs")
    with pytest.raises((RuntimeError, AssertionError)):
        eval_reranker.main(_argv(setup, str(tmp_path), "splade",
                                 "--run_path", setup[4]))
