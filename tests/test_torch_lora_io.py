"""LoRA adapter I/O of the torch port against the JAX package and ``peft``
(CPU, tiny widths): adapters written by ``peft`` (safetensors and
``.bin``) load in the port as in the JAX package, the port's adapters load
in the JAX package and in ``peft``, ``rewrite_mntp_to_bimodel`` and its
CLI write what the JAX package's do, and ``init_lora_params`` follows
peft's init. Factors are copied without arithmetic, so they are compared
bit for bit; merged weights at rtol 1e-5 (the f32 delta's sum order)."""

import json
import os

import numpy as np
import pytest
import torch
from peft import LoraConfig as PeftLoraConfig
from peft import PeftModel, get_peft_model
from transformers import LlamaConfig, LlamaForCausalLM

from scaling_retriever_tpu.models import config as ref_config
from scaling_retriever_tpu.models import lora as ref_lora
from scaling_retriever_tpu_torch.models import lora, safetensors_io
from scaling_retriever_tpu_torch.models.config import ModelConfig

torch.set_num_threads(1)

TARGETS = ["q_proj", "v_proj", "o_proj", "k_proj", "down_proj", "up_proj",
           "gate_proj"]
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture(scope="module")
def peft_dirs(tmp_path_factory):
    """A tiny Llama base, and peft adapters over it with random B, saved
    as safetensors and as ``.bin``."""
    root = tmp_path_factory.mktemp("lora")
    torch.manual_seed(0)
    base = LlamaForCausalLM(LlamaConfig(**TINY, tie_word_embeddings=False))
    base.save_pretrained(root / "base")
    model = get_peft_model(base, PeftLoraConfig(
        r=4, lora_alpha=8, lora_dropout=0.0, target_modules=TARGETS))
    torch.manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lora_B" in name:
                p.normal_(0, 0.05)
    model.save_pretrained(root / "st")
    model.save_pretrained(root / "bin", safe_serialization=False)
    assert os.path.exists(root / "bin" / "adapter_model.bin")
    return str(root)


def _cfgs():
    return ModelConfig(**TINY), ref_config.ModelConfig(**TINY)


def _assert_same_tree(port_tree, ref_tree):
    assert port_tree["layers"].keys() == ref_tree["layers"].keys()
    for g, mods in ref_tree["layers"].items():
        assert port_tree["layers"][g].keys() == mods.keys()
        for name, fac in mods.items():
            for ab in ("a", "b"):
                np.testing.assert_array_equal(
                    port_tree["layers"][g][name][ab].numpy(),
                    np.asarray(fac[ab]), err_msg=f"{g}.{name}.{ab}")


@pytest.mark.parametrize("fmt", ["st", "bin"])
def test_peft_adapter_loads_as_in_reference(peft_dirs, fmt):
    pcfg, rcfg = _cfgs()
    d = os.path.join(peft_dirs, fmt)
    got, got_cfg = lora.load_adapter(d, pcfg, device="cpu")
    want, want_cfg = ref_lora.load_adapter(d, rcfg)
    _assert_same_tree(got, want)
    assert got["layers"]["attn"]["wq"]["a"].shape == (2, 64, 4)
    assert got["layers"]["mlp"]["wd"]["b"].shape == (2, 4, 64)
    assert (got_cfg.r, got_cfg.lora_alpha, set(got_cfg.target_modules)) == (
        want_cfg.r, want_cfg.lora_alpha, set(want_cfg.target_modules))
    assert got_cfg.scaling == want_cfg.scaling == 2.0


def test_port_adapter_loads_in_reference_and_peft(peft_dirs, tmp_path):
    pcfg, rcfg = _cfgs()
    tree, _ = lora.load_adapter(os.path.join(peft_dirs, "st"), pcfg,
                                device="cpu")
    lcfg = lora.LoraConfig(r=4, lora_alpha=8, target_modules=tuple(TARGETS),
                           base_model_name_or_path=os.path.join(peft_dirs,
                                                                "base"))
    out = str(tmp_path / "port")
    lora.save_adapter(tree, lcfg, out)
    ref_tree, ref_cfg = ref_lora.load_adapter(out, rcfg)
    _assert_same_tree(tree, ref_tree)
    assert ref_cfg.base_model_name_or_path == lcfg.base_model_name_or_path
    # the JAX package writes the same tensors under the same names
    ref_out = str(tmp_path / "ref")
    ref_lora.save_adapter(ref_tree, ref_lora.LoraConfig(
        r=4, lora_alpha=8, target_modules=tuple(TARGETS)), ref_out)
    ours = safetensors_io.load_file(os.path.join(out, lora.ADAPTER_FILE))
    theirs = safetensors_io.load_file(os.path.join(ref_out,
                                                   lora.ADAPTER_FILE))
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    # peft attaches it to the base and merges as the port merges
    base = LlamaForCausalLM.from_pretrained(os.path.join(peft_dirs, "base"))
    merged = PeftModel.from_pretrained(base, out).merge_and_unload()
    from scaling_retriever_tpu_torch.models.hf_loader import load_pretrained
    model, _ = load_pretrained(os.path.join(peft_dirs, "base"),
                               device="cpu")
    lora.merge_lora(model, tree, lcfg)
    for i in range(2):
        np.testing.assert_allclose(
            model.layers[i].wg.weight.numpy(),
            merged.model.layers[i].mlp.gate_proj.weight.detach().numpy(),
            rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            model.layers[i].wk.weight.numpy(),
            merged.model.layers[i].self_attn.k_proj.weight.detach().numpy(),
            rtol=1e-5, atol=1e-7)


def test_adapter_config_fields_match_reference(tmp_path):
    kw = dict(r=8, lora_alpha=16, lora_dropout=0.1,
              target_modules=("q_proj", "v_proj"),
              base_model_name_or_path="base", base_model_class="Qwen2BiModel")
    port = lora.LoraConfig(**kw).to_adapter_config()
    ref = ref_lora.LoraConfig(**kw).to_adapter_config()
    assert port.keys() == ref.keys()
    assert port["auto_mapping"]["parent_library"].startswith(
        "scaling_retriever_tpu_torch")
    port["auto_mapping"] = ref["auto_mapping"] = None
    assert port == ref
    (tmp_path / "adapter_config.json").write_text(json.dumps(
        lora.LoraConfig(**kw).to_adapter_config()))
    assert lora.LoraConfig.from_adapter_dir(str(tmp_path)) == \
        lora.LoraConfig(**kw)


def test_rewrite_mntp_to_bimodel_and_cli_match_reference(peft_dirs,
                                                         tmp_path):
    pcfg, rcfg = _cfgs()
    tree, _ = lora.load_adapter(os.path.join(peft_dirs, "st"), pcfg,
                                device="cpu")
    mntp = str(tmp_path / "mntp")
    lora.save_adapter(tree, lora.LoraConfig(r=4, lora_alpha=8), mntp)
    port_out, ref_out = str(tmp_path / "p"), str(tmp_path / "r")
    lora._rewrite_cli(["--input_dir", mntp, "--output_dir", port_out])
    ref_lora.rewrite_mntp_to_bimodel(mntp, ref_out, "llama")
    ours = safetensors_io.load_file(os.path.join(port_out, lora.ADAPTER_FILE))
    theirs = safetensors_io.load_file(os.path.join(ref_out, lora.ADAPTER_FILE))
    assert ours.keys() == theirs.keys()
    assert all(k.startswith("base_model.model.layers.") for k in ours)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    with open(os.path.join(port_out, lora.ADAPTER_CONFIG)) as f:
        got = json.load(f)
    with open(os.path.join(ref_out, lora.ADAPTER_CONFIG)) as f:
        want = json.load(f)
    assert got == want
    assert got["auto_mapping"]["base_model_class"] == "LlamaBiModel"
    # both layouts load to the same factors
    _assert_same_tree(lora.load_adapter(port_out, pcfg, device="cpu")[0],
                      ref_lora.load_adapter(mntp, rcfg)[0])


def test_init_lora_params_follows_peft_init():
    cfg = ModelConfig(**TINY)
    lcfg = lora.LoraConfig(r=4, lora_alpha=8)
    tree = lora.init_lora_params(cfg, lcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    fan_in = {"wq": 64, "wk": 64, "wv": 64, "wo": 64, "wg": 64, "wu": 64,
              "wd": 128}
    fan_out = {"wq": 64, "wk": 32, "wv": 32, "wo": 64, "wg": 128, "wu": 128,
               "wd": 64}
    names = {n for g in tree["layers"].values() for n in g}
    assert names == set(fan_in)
    for group in tree["layers"].values():
        for name, fac in group.items():
            assert fac["a"].shape == (2, fan_in[name], 4)
            assert fac["b"].shape == (2, 4, fan_out[name])
            assert not fac["b"].any()
            bound = 1.0 / np.sqrt(fan_in[name])
            assert fac["a"].abs().max() <= bound
            assert fac["a"].abs().max() > 0.8 * bound
    again = lora.init_lora_params(cfg, lcfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    assert torch.equal(again["layers"]["attn"]["wq"]["a"],
                       tree["layers"]["attn"]["wq"]["a"])
    with pytest.raises(NotImplementedError):
        lora.init_lora_params(cfg, lora.LoraConfig(target_modules=("x",)),
                              torch.Generator(), device="cpu")
