"""The torch port's encoder classes loaded from disk, against the JAX
package (CPU, tiny widths): ``load`` with and without a merged adapter,
``load_from_lora``, ``build``, ``save_pretrained``, ``rerank_forward``,
offline hub-id resolution, the model registry, the text frontend's
loader, and ``merge_and_unload`` leaving its source object encoding as the
merged model. Reps at rtol 1e-4, atol 1e-5 (the frameworks' matmul sum
orders differ)."""

import json
import os
import types

import numpy as np
import pytest
import torch
from peft import LoraConfig as PeftLoraConfig
from peft import get_peft_model
from transformers import LlamaConfig, LlamaForCausalLM

from scaling_retriever_tpu.models import encoder as ref_encoder
from scaling_retriever_tpu_torch.models import encoder
from scaling_retriever_tpu_torch.models.encoder import (LlamaBiDense,
                                                        LlamaBiSparse,
                                                        Qwen2BiDense)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TARGETS = ["q_proj", "v_proj", "o_proj", "k_proj", "down_proj", "up_proj",
           "gate_proj"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(base dir, adapter dir): a tiny untied Llama, and a peft adapter
    with random B whose config names the base; each with a tokenizer."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from helpers import make_tiny_tokenizer

    root = tmp_path_factory.mktemp("enc")
    base_dir, adapter_dir = str(root / "base"), str(root / "adapter")
    torch.manual_seed(0)
    base = LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False))
    base.save_pretrained(base_dir)
    make_tiny_tokenizer(base_dir)
    model = get_peft_model(base, PeftLoraConfig(
        r=4, lora_alpha=8, lora_dropout=0.0, target_modules=TARGETS))
    torch.manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lora_B" in name:
                p.normal_(0, 0.05)
    model.save_pretrained(adapter_dir)
    make_tiny_tokenizer(adapter_dir)
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["base_model_name_or_path"] = base_dir
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return base_dir, adapter_dir


def _batch():
    rng = np.random.default_rng(2)
    ids = rng.integers(4, 256, (3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, :5] = 0
    return ids, mask


def _same(port_model, ref_model):
    ids, mask = _batch()
    np.testing.assert_allclose(port_model.encode(ids, mask).numpy(),
                               np.asarray(ref_model.encode(ids, mask)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("merge", [True, False])
def test_load_with_adapter_matches_reference(ckpt, merge):
    base_dir, adapter_dir = ckpt
    port = LlamaBiSparse.load(base_dir, lora_name_or_path=adapter_dir,
                              merge_peft=merge, device="cpu")
    ref = ref_encoder.LlamaBiSparse.load(base_dir,
                                         lora_name_or_path=adapter_dir,
                                         merge_peft=merge)
    assert (port.lora is None) == merge and port.T == ref.T == 1.0
    _same(port, ref)
    dense = LlamaBiDense.load_from_lora(adapter_dir, device="cpu", T=0.05)
    assert dense.T == 0.05 and dense.lora is None
    _same(dense, ref_encoder.LlamaBiDense.load_from_lora(adapter_dir))


def test_merge_and_unload_leaves_source_as_merged(ckpt):
    """The merge folds the adapter into the shared weights in place: the
    source object drops its adapter too, and encodes as the merged model
    (it applied the delta twice before)."""
    base_dir, adapter_dir = ckpt
    src = LlamaBiSparse.load(base_dir, lora_name_or_path=adapter_dir,
                             merge_peft=False, device="cpu")
    ids, mask = _batch()
    before = src.encode(ids, mask).numpy()
    merged = src.merge_and_unload()
    assert src.lora is None and src.lora_config is None
    np.testing.assert_allclose(merged.encode(ids, mask).numpy(), before,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(src.encode(ids, mask).numpy(), before,
                               rtol=RTOL, atol=ATOL)
    assert merged.merge_and_unload() is merged


def test_build_save_and_rerank(ckpt, tmp_path):
    base_dir, _ = ckpt
    args = types.SimpleNamespace(lora=True, lora_r=4, lora_alpha=8, T=0.02)
    built = LlamaBiDense.build(base_dir, args, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    assert built.T == 0.02 and built.lora_config.base_model_class == \
        "LlamaBiModel"
    plain = LlamaBiDense.load(base_dir, device="cpu")
    ids, mask = _batch()
    # B = 0: the fresh adapter leaves the function unchanged
    np.testing.assert_array_equal(built.encode(ids, mask).numpy(),
                                  plain.encode(ids, mask).numpy())
    built.save_pretrained(str(tmp_path / "adapter"))
    assert os.path.exists(tmp_path / "adapter" / "adapter_model.safetensors")
    plain.save_pretrained(str(tmp_path / "full"))
    _same(LlamaBiDense.load(str(tmp_path / "full"), device="cpu"),
          ref_encoder.LlamaBiDense.load(base_dir))
    tq = {"input_ids": ids, "attention_mask": mask}
    td = {"input_ids": ids[::-1].copy(), "attention_mask": mask[::-1].copy()}
    ref = ref_encoder.LlamaBiSparse.load(base_dir)
    port = LlamaBiSparse.load(base_dir, device="cpu")
    np.testing.assert_allclose(port.rerank_forward(tq, td).numpy(),
                               np.asarray(ref.rerank_forward(tq, td)),
                               rtol=RTOL, atol=1e-4)
    # the training halves: the whole module saved as a checkpoint, and the
    # sparse nce losses of one batch
    port.save_trained(port.params, str(tmp_path / "t"), use_lora=False)
    _same(LlamaBiSparse.load(str(tmp_path / "t"), device="cpu"),
          ref_encoder.LlamaBiSparse.load(base_dir))
    out = port.loss_forward(port.params, None, {
        "tokenized_queries": tq, "tokenized_contexts": td,
        "target_labels": np.arange(len(ids), dtype=np.int32)})
    assert set(out) == {"rank", "query_reg", "doc_reg"}
    assert all(torch.isfinite(v) for v in out.values())


def test_resolve_model_dir_offline(ckpt, tmp_path, monkeypatch):
    base_dir, _ = ckpt
    monkeypatch.delenv("SRT_MODEL_DIR_MAP", raising=False)
    monkeypatch.delenv("SRT_MODEL_CACHE", raising=False)
    with pytest.raises(FileNotFoundError, match="SRT_MODEL_DIR_MAP"):
        encoder._resolve_model_dir("org/model")
    monkeypatch.setenv("SRT_MODEL_DIR_MAP", json.dumps({"org/model":
                                                        base_dir}))
    assert encoder._resolve_model_dir("org/model") == base_dir
    monkeypatch.delenv("SRT_MODEL_DIR_MAP")
    (tmp_path / "org--other").mkdir()
    monkeypatch.setenv("SRT_MODEL_CACHE", str(tmp_path))
    assert encoder._resolve_model_dir("org/other") == str(
        tmp_path / "org--other")
    assert encoder._resolve_model_dir(base_dir) == base_dir


def test_registry_matches_reference():
    # both registries register T5 on its first lookup
    t5_keys = [("t5", "sparse", "nce"), ("t5", "sparse", "margin_mse")]
    for key in t5_keys:
        encoder.MODEL_REGISTRY[key]
        ref_encoder.MODEL_REGISTRY[key]
    want = dict(ref_encoder.MODEL_REGISTRY)
    assert set(encoder.MODEL_REGISTRY) == set(want)
    assert set(t5_keys) <= set(want)
    for key, cls in want.items():
        port = encoder.MODEL_REGISTRY[key]
        assert port.__name__ == cls.__name__
        assert (port.MODEL_TYPE, port.POOLING, port.LOSS_TYPE,
                port.BASE_MODEL_CLASS) == (cls.MODEL_TYPE, cls.POOLING,
                                           cls.LOSS_TYPE,
                                           cls.BASE_MODEL_CLASS)
    for key in (("t5", "sparse", "kldiv"), ("t5", "dense", "nce"),
                ("gpt2", "sparse", "nce")):
        with pytest.raises(KeyError):
            encoder.MODEL_REGISTRY[key]


def test_frontend_loader_and_dispatch(ckpt, tmp_path):
    from scaling_retriever_tpu.serving.text_frontend import \
        load_sparse_encoder as ref_load
    from scaling_retriever_tpu_torch.serving.text_frontend import \
        load_sparse_encoder

    base_dir, adapter_dir = ckpt
    model, tok = load_sparse_encoder(adapter_dir, device="cpu")
    ref_model, _ = ref_load(adapter_dir)
    assert type(model).__name__ == type(ref_model).__name__
    _same(model, ref_model)
    assert tok("w3 w4")["input_ids"]
    model, _ = load_sparse_encoder(base_dir, adapter_dir, device="cpu")
    _same(model, ref_model)
    # model_type picks the family
    q = tmp_path / "qwen"
    q.mkdir()
    (q / "config.json").write_text(json.dumps({"model_type": "qwen2"}))
    assert encoder.encoder_class(str(q), "dense") is Qwen2BiDense
    assert encoder.encoder_class(adapter_dir, "sparse") is LlamaBiSparse
