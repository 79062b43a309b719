"""Checkpoint I/O of the torch port against the JAX package and the
``safetensors``/``transformers`` packages (CPU, tiny widths).

A checkpoint written by ``transformers`` (single file, sharded, bf16,
untied; Llama, Qwen2 and Mistral), by the JAX package's
``save_pretrained`` or by the port's loads in the other packages, and the
port's sparse reps equal the JAX package's at rtol 1e-4, atol 1e-5 (the
two frameworks sum the matmuls in different orders). Parameters copied
without arithmetic are compared bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save_file

from scaling_retriever_tpu.models import config as ref_config
from scaling_retriever_tpu.models import hf_loader as ref_loader
from scaling_retriever_tpu.models.encoder import (LlamaBiSparse as RefLlama,
                                                  MistralBiSparse as RefMistral,
                                                  Qwen2BiSparse as RefQwen2)
from scaling_retriever_tpu_torch.models import hf_loader, safetensors_io
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.encoder import (LlamaBiSparse,
                                                        MistralBiSparse,
                                                        Qwen2BiSparse)
from scaling_retriever_tpu_torch.models.mistral import mistral_config
from scaling_retriever_tpu_torch.models.qwen2 import qwen2_config

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)


def make_hf_dir(path, family="llama", tie=True, dtype=torch.float32,
                max_shard_size=None, seed=0):
    """A tiny random ``transformers`` checkpoint of ``family``."""
    from transformers import (LlamaConfig, LlamaForCausalLM, MistralConfig,
                              MistralForCausalLM, Qwen2Config,
                              Qwen2ForCausalLM)

    cfg_cls, model_cls = {
        "llama": (LlamaConfig, LlamaForCausalLM),
        "qwen2": (Qwen2Config, Qwen2ForCausalLM),
        "mistral": (MistralConfig, MistralForCausalLM)}[family]
    torch.manual_seed(seed)
    model = model_cls(cfg_cls(**TINY, tie_word_embeddings=tie))
    if family == "qwen2":       # nonzero q/k/v biases, so they are checked
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in ("q_proj", "k_proj", "v_proj"):
                    getattr(layer.self_attn, proj).bias.normal_(0, 0.1)
    model = model.to(dtype)
    kw = {} if max_shard_size is None else {"max_shard_size": max_shard_size}
    model.save_pretrained(str(path), **kw)
    return str(path)


def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 256, (3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :4] = 0
    return ids, mask


def assert_same_reps(port_model, ref_model):
    ids, mask = batch()
    want = np.asarray(ref_model.encode(ids, mask))
    got = port_model.encode(ids, mask).numpy()
    assert got.shape == want.shape and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family,tie,dtype,shard", [
    ("llama", True, torch.float32, None),
    ("llama", False, torch.float32, "40KB"),
    ("llama", False, torch.bfloat16, None),
    ("qwen2", False, torch.float32, None),
    ("mistral", True, torch.float32, "40KB"),
])
def test_transformers_checkpoint_loads_as_in_reference(tmp_path, family, tie,
                                                       dtype, shard):
    d = make_hf_dir(tmp_path / "ckpt", family, tie, dtype, shard)
    if shard:
        assert os.path.exists(os.path.join(d, "model.safetensors.index.json"))
    port_cls, ref_cls = {"llama": (LlamaBiSparse, RefLlama),
                         "qwen2": (Qwen2BiSparse, RefQwen2),
                         "mistral": (MistralBiSparse, RefMistral)}[family]
    port = port_cls.load(d, device="cpu")
    # the reference takes config.json's "dtype" string as its activation
    # dtype, and its layer scan refuses "bfloat16" over f32 parameters
    ref = ref_cls.load(d, dtype=jax.numpy.float32)
    assert port.config.dtype == torch.float32
    assert port.config.attention_qkv_bias == (family == "qwen2")
    assert (port.params.lm_head is None) == tie
    assert_same_reps(port, ref)
    # every shard reads as safetensors reads it, and lands unchanged
    # (bf16 files are widened exactly)
    ours = hf_loader.load_hf_tensors(d)
    for path in hf_loader._shard_files(d):
        with safe_open(path, "pt") as f:
            for k in f.keys():
                assert torch.equal(ours[k], f.get_tensor(k)), k
    for i, layer in enumerate(port.params.layers):
        assert torch.equal(layer.wk.weight, ours[
            f"model.layers.{i}.self_attn.k_proj.weight"].float())


def test_port_checkpoint_loads_in_safetensors_and_reference(tmp_path):
    src = make_hf_dir(tmp_path / "src", "qwen2", tie=False)
    port = Qwen2BiSparse.load(src, device="cpu")
    out = str(tmp_path / "out")
    port.save_pretrained(out)
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    ref_cfg = ref_config.ModelConfig.from_pretrained(src)
    assert cfg == ref_cfg.to_hf_config()
    with safe_open(os.path.join(out, "model.safetensors"), "pt") as f:
        names = set(f.keys())
        assert f.get_tensor("lm_head.weight").equal(
            port.params.lm_head.weight)
        assert f.get_tensor("model.layers.1.self_attn.v_proj.bias").equal(
            port.params.layers[1].wv.bias)
    params, _ = ref_loader.load_pretrained(src)
    ref_out = str(tmp_path / "ref_out")
    ref_loader.save_pretrained(params, ref_cfg, ref_out)
    with safe_open(os.path.join(ref_out, "model.safetensors"), "np") as f:
        assert names == set(f.keys())
        for k in names:
            np.testing.assert_array_equal(
                safetensors_io.load_file(os.path.join(
                    out, "model.safetensors"))[k].numpy(), f.get_tensor(k))
    # the port's file through the reference's loader
    assert_same_reps(Qwen2BiSparse.load(out, device="cpu"),
                     RefQwen2.load(out))


def test_reference_checkpoint_loads_in_port(tmp_path, tiny_config):
    """JAX ``save_pretrained`` (an untied head) → the port: every weight
    equal to the JAX tree's, transposed back to [out, in]."""
    from scaling_retriever_tpu.models import llama as ref_llama

    params = ref_llama.init_params(tiny_config, jax.random.PRNGKey(3))
    d = str(tmp_path / "ref")
    ref_loader.save_pretrained(params, tiny_config, d)
    model, cfg = hf_loader.load_pretrained(d, device="cpu")
    assert not cfg.tie_word_embeddings
    np.testing.assert_array_equal(model.lm_head.weight.numpy(),
                                  np.asarray(params["lm_head"]).T)
    np.testing.assert_array_equal(
        model.layers[1].wd.weight.numpy(),
        np.asarray(params["layers"]["mlp"]["wd"][1]).T)
    np.testing.assert_array_equal(model.final_norm.numpy(),
                                  np.asarray(params["final_norm"]))
    assert_same_reps(LlamaBiSparse(model, cfg), RefLlama(params, tiny_config))


def test_untied_head_falls_back_to_embeddings(tmp_path):
    d = make_hf_dir(tmp_path / "c", "llama", tie=True)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg["tie_word_embeddings"] = False
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    port = LlamaBiSparse.load(d, device="cpu")
    assert torch.equal(port.params.lm_head.weight,
                       port.params.embed_tokens.weight)
    assert_same_reps(port, RefLlama.load(d))


def test_missing_tensor_raises_and_default_device_is_cuda(tmp_path):
    d = make_hf_dir(tmp_path / "c", "llama")
    tensors = safetensors_io.load_file(os.path.join(d, "model.safetensors"))
    del tensors["model.layers.1.mlp.up_proj.weight"]
    safetensors_io.save_file(tensors, os.path.join(d, "model.safetensors"))
    with pytest.raises(ValueError, match="lacks 1 tensors"):
        hf_loader.load_pretrained(d, device="cpu")
    if not torch.cuda.is_available():
        # no silent CPU fallback: the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            hf_loader.load_pretrained(d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_format_both_ways(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    ts = {"b.x": (torch.randn(3, 5, generator=g) * 100).to(dtype),
          "a": (torch.randn(7, generator=g) * 100).to(dtype),
          "s": torch.tensor(2, dtype=dtype), "e": torch.zeros(0, 4,
                                                             dtype=dtype)}
    theirs = str(tmp_path / "theirs.safetensors")
    st_save_file(ts, theirs, metadata={"format": "pt"})
    got = safetensors_io.load_file(theirs)
    assert got.keys() == ts.keys()
    for k in ts:
        assert got[k].dtype == dtype and torch.equal(got[k], ts[k]), k
    ours = str(tmp_path / "ours.safetensors")
    safetensors_io.save_file(ts, ours)
    with open(ours, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0
    with safe_open(ours, "pt") as f:
        assert f.metadata() == {"format": "pt"}
        for k in ts:
            assert torch.equal(f.get_tensor(k), ts[k]), k


def test_qwen2_rule_and_hf_config_match_reference():
    """The Qwen2 bias rule (absent from the port's config before), and
    ``to_hf_config`` field for field, architecture label included."""
    for mt in ("llama", "qwen2", "mistral"):
        hf = dict(TINY, model_type=mt, rope_theta=1e4, dtype="float32")
        ref = ref_config.ModelConfig.from_hf_config(hf)
        port = ModelConfig.from_hf_config(hf)
        assert port.attention_qkv_bias == ref.attention_qkv_bias == (
            mt == "qwen2")
        assert port.dtype == torch.float32
        assert ModelConfig.from_hf_config(
            dict(hf, dtype="bfloat16")).dtype == torch.float32
        assert port.to_hf_config() == ref.to_hf_config()
    assert qwen2_config(dict(TINY)).attention_qkv_bias
    assert not mistral_config(dict(TINY)).attention_qkv_bias
    assert ModelConfig.from_hf_config(
        dict(model_type="mistral")).to_hf_config()["architectures"] == [
            "Qwen2ForCausalLM"]
