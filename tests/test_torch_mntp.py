"""The port's MNTP against the JAX package's: the collator's masks for one
seed (default and all_mask modes, variable rows padded), ``group_texts``,
the shifted loss with its gradient, and ``MNTPModel.loss_forward`` through
the model (rtol 1e-4, a gradient's atol 1e-5 of its largest entry, as
the encoder's training losses in test_torch_trainer.py); then
the CLI on tiny local corpora: grouped and line-by-line rows, eval, the
Mistral family, a local ``save_to_disk`` dataset and a ``configs/mntp``
file."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.models import llama as ref_llama
from scaling_retriever_tpu.models.lora import LoraConfig as RefLoraConfig
from scaling_retriever_tpu.models.lora import init_lora_params
from scaling_retriever_tpu.training import mntp as ref_mntp
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.lora import LoraConfig
from scaling_retriever_tpu_torch.models.weights import (lora_from_jax,
                                                        params_from_jax)
from scaling_retriever_tpu_torch.training import mntp

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_tiny_llama_dir, make_tiny_tokenizer  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("full_masking", [False, True])
def test_collator_masks_match_reference(full_masking):
    rng = np.random.default_rng(1)
    rows = [rng.integers(5, 250, size=n).tolist() for n in (5, 11, 16, 30)]
    kw = dict(mask_token_id=3, vocab_size=256, mlm_probability=0.4,
              full_masking=full_masking, special_token_ids=[7, 9], seed=2,
              pad_token_id=0)
    got_c, want_c = mntp.MNTPCollator(**kw), ref_mntp.MNTPCollator(**kw)
    for _ in range(3):     # the generator's state carries across batches
        got, want = got_c(rows), want_c(rows)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["input_ids"].shape == (4, 32)
    assert (got["labels"][got["attention_mask"] == 0] == mntp.IGNORE).all()


def test_group_texts_matches_reference():
    lists = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10]]
    for n in (1, 3, 4, 20):
        np.testing.assert_array_equal(mntp.group_texts(lists, n),
                                      ref_mntp.group_texts(lists, n))


def test_shift_loss_and_gradient_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 10, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 10)).astype(np.int32)
    labels[rng.random((3, 10)) < 0.6] = mntp.IGNORE
    (want, want_acc), wg = jax.value_and_grad(
        lambda x: ref_mntp.mntp_shift_loss(x, jnp.asarray(labels)),
        has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got, acc = mntp.mntp_shift_loss(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert float(acc) == float(want_acc)
    np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                               atol=1e-7)


def test_model_loss_forward_matches_reference(tiny_config):
    cfg = tiny_config
    params = ref_llama.init_params(cfg, jax.random.PRNGKey(4))
    lora = init_lora_params(cfg, RefLoraConfig(r=4, lora_alpha=8),
                            jax.random.PRNGKey(5))
    lora = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(6),
                                               x.shape), lora)
    coll = mntp.MNTPCollator(3, cfg.vocab_size, 0.3, seed=0)
    batch = coll([list(range(10, 26)), list(range(40, 52))])
    ref = ref_mntp.MNTPModel(params, cfg, lora, RefLoraConfig(r=4,
                                                              lora_alpha=8))

    def total(lo):
        out = ref.loss_forward(params, lo, jax.tree_util.tree_map(
            jnp.asarray, batch))
        return out["rank"], out

    (_, want), wg = jax.jit(jax.value_and_grad(total, has_aux=True))(lora)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pcfg = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if f.name in fields and f.name not in
                          ("dtype", "param_dtype", "remat")})
    port = mntp.MNTPModel(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg,
                        "cpu"), pcfg,
        lora_from_jax(jax.tree_util.tree_map(np.asarray, lora), "cpu",
                      trainable=True), LoraConfig(r=4, lora_alpha=8))
    got = port.loss_forward(port.params, port.lora, batch)
    np.testing.assert_allclose(float(got["rank"].detach()),
                               float(want["rank"]), rtol=1e-4)
    assert float(got["accuracy"]) == float(want["accuracy"])
    a = port.lora["layers"]["mlp"]["wd"]["a"]
    (g,) = torch.autograd.grad(got["rank"], a)
    w = np.asarray(wg["layers"]["mlp"]["wd"]["a"])
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                               atol=1e-5 * np.abs(w).max())


def _corpus(path, n=40, words=30, tsv=True, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for d in range(n):
            k = words if tsv else int(rng.integers(8, 28))
            text = " ".join(f"w{rng.integers(10, 150)}" for _ in range(k))
            f.write(f"doc{d}\t{text}\n" if tsv else text + "\n")
        if not tsv:
            f.write("\n")                  # empty lines are dropped
    return str(path)


def _logs(out):
    with open(os.path.join(out, "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_llama_dir(str(tmp_path_factory.mktemp("mntp_model")))


def test_mntp_cli_grouped(model_dir, tmp_path):
    out = str(tmp_path / "out")
    trainer = mntp.main([
        "--model_name_or_path", model_dir, "--train_file",
        _corpus(tmp_path / "corpus.tsv"), "--output_dir", out,
        "--max_seq_length", "32", "--stop_after_n_steps", "4",
        "--per_device_train_batch_size", "4", "--logging_steps", "1",
        "--lora_r", "4", "--mask_token_type", "eos", "--device", "cpu"])
    assert trainer.step == 4
    with open(os.path.join(out, "adapter_config.json")) as f:
        cfg = json.load(f)
    assert cfg["lora_alpha"] == 8                     # 2 * r by default
    assert cfg["auto_mapping"]["base_model_class"] == "LlamaBiForMNTP"
    assert all("accuracy" in e and np.isfinite(e["loss"])
               for e in _logs(out))


def test_mntp_cli_line_by_line_and_eval(model_dir, tmp_path):
    out = str(tmp_path / "lbl")
    trainer = mntp.main([
        "--model_name_or_path", model_dir, "--train_file",
        _corpus(tmp_path / "corpus.txt", n=60, tsv=False), "--output_dir",
        out, "--max_seq_length", "32", "--line_by_line",
        "--stop_after_n_steps", "3", "--per_device_train_batch_size", "4",
        "--logging_steps", "1", "--eval_steps", "2", "--do_eval",
        "--validation_split_percentage", "10", "--lora_r", "4",
        "--mask_token_type", "eos", "--data_collator_type", "all_mask",
        "--device", "cpu"])
    assert trainer.step == 3
    with open(os.path.join(out, "eval_results.json")) as f:
        results = json.load(f)
    assert np.isfinite(results["eval_loss"])
    assert 0.0 <= results["eval_accuracy"] <= 1.0
    assert any("eval_loss" in e for e in _logs(out))


def test_mntp_cli_mistral(tmp_path):
    from transformers import MistralConfig, MistralForCausalLM

    model_dir = str(tmp_path / "mistral")
    torch.manual_seed(0)
    MistralForCausalLM(MistralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        sliding_window=4096)).save_pretrained(model_dir)
    make_tiny_tokenizer(model_dir)
    out = str(tmp_path / "out")
    trainer = mntp.main([
        "--model_name_or_path", model_dir, "--train_file",
        _corpus(tmp_path / "corpus.tsv", n=30), "--output_dir", out,
        "--max_seq_length", "32", "--stop_after_n_steps", "2",
        "--per_device_train_batch_size", "4", "--logging_steps", "1",
        "--lora_r", "4", "--mask_token_type", "eos", "--device", "cpu"])
    assert trainer.step == 2
    with open(os.path.join(out, "adapter_config.json")) as f:
        assert json.load(f)["auto_mapping"]["base_model_class"] == \
            "MistralBiForMNTP"


def test_mntp_cli_local_dataset_and_config_json(model_dir, tmp_path):
    """A ``save_to_disk`` directory through ``--dataset_name``, with the
    1B recipe's ``configs/mntp`` file (its paths, widths and step counts
    overridden on the command line; bf16 and the mask settings kept)."""
    import datasets as hfd

    rng = np.random.default_rng(3)
    texts = [" ".join(f"w{rng.integers(10, 150)}" for _ in range(20))
             for _ in range(50)]
    ds_dir = str(tmp_path / "wikidir")
    hfd.DatasetDict({
        "train": hfd.Dataset.from_dict({"text": texts[:40]}),
        "validation": hfd.Dataset.from_dict({"text": texts[40:] + ["", " "]}),
    }).save_to_disk(ds_dir)
    assert mntp.load_hf_dataset_texts(ds_dir, split="validation") == \
        texts[40:]
    out = str(tmp_path / "out")
    trainer = mntp.main([
        "--config_json", os.path.join(ROOT, "configs/mntp/"
                                      "llama3_1b_msmarco.json"),
        "--model_name_or_path", model_dir, "--dataset_name", ds_dir,
        "--output_dir", out,
        "--max_seq_length", "32", "--stop_after_n_steps", "2",
        "--per_device_train_batch_size", "4", "--eval_steps", "1",
        "--logging_steps", "1", "--device", "cpu"])
    assert trainer.step == 2
    assert trainer.encoder.params.final_norm.dtype == torch.bfloat16
    assert trainer.encoder.lora_config.r == 16
    with open(os.path.join(out, "eval_results.json")) as f:
        assert np.isfinite(json.load(f)["eval_loss"])
