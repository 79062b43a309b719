"""The port's T5 family against the JAX package's (CPU, float32, tiny
widths): the stack's logits for v1.0 (relu, tied) and v1.1 (gated-gelu,
untied) against JAX and the HF oracle, the relative-position bucket
bit-equal over every relative position in [-512, 512], ``T5Sparse``'s
reps, the weights and LoRA trees carried across, HF checkpoints and peft
adapter files across packages both ways, the merge, and three optimizer
steps of the Trainer against the JAX package's with dropout 0.

Tolerances: port against JAX, logits and reps rtol 1e-5, atol 2e-5 (the
frameworks' matmul sum orders differ, ~1e-6 relative; the decoder's
softmaxes amplify it a little); against HF 3e-4, as the JAX package's own
test; adapters loaded from the same file bit-equal; a merge against the
unmerged forward 2e-4 (the merged weights round once more in float32);
the Trainer's losses and factors rtol 1e-4, atol 1e-6, as
``tests/test_torch_trainer.py`` sets them."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from peft import LoraConfig as PeftLoraConfig
from peft import get_peft_model
from transformers import T5Config as HFT5Config
from transformers import T5ForConditionalGeneration as HFT5

from scaling_retriever_tpu.models import t5 as ref_t5
from scaling_retriever_tpu.models import t5_encoder as ref_t5e
from scaling_retriever_tpu.models.lora import LoraConfig as RefLoraConfig
from scaling_retriever_tpu.training import trainer as ref_trainer
from scaling_retriever_tpu_torch.models import encoder, t5
from scaling_retriever_tpu_torch.models.lora import LoraConfig
from scaling_retriever_tpu_torch.models.t5_encoder import (
    T5Sparse, T5SparseForMarginMSE)
from scaling_retriever_tpu_torch.models.weights import (lora_from_jax,
                                                        params_from_jax)
from scaling_retriever_tpu_torch.training.trainer import (
    LLM2RetrieverTrainingArgs, Trainer, tree_leaves)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 2e-5
HF_TOL = 3e-4
TINY = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4,
            relative_attention_num_buckets=8,
            relative_attention_max_distance=20)


def _hf(ffp="relu", tie=True, seed=0):
    torch.manual_seed(seed)
    return HFT5(HFT5Config(**TINY, feed_forward_proj=ffp,
                           tie_word_embeddings=tie, dropout_rate=0.0)).eval()


def _batch(seed, b=2, s=9, pad_from=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    mask[0, pad_from:] = 0          # right padding (T5's side)
    return ids, mask


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_logits(model, ids, mask, lora=None, scale=0.0):
    with torch.no_grad():
        return model.forward_logits(torch.tensor(ids), torch.tensor(mask),
                                    torch.tensor(ids), torch.tensor(mask),
                                    lora, scale).numpy()


@pytest.mark.parametrize("ffp,tie", [("relu", True), ("gated-gelu", False)])
def test_t5_logits_parity(ffp, tie):
    hf = _hf(ffp, tie)
    kw = dict(**TINY, feed_forward_proj=ffp, tie_word_embeddings=tie)
    sd = hf.state_dict()
    ref_params = ref_t5.params_from_hf_tensors(
        {k: jnp.asarray(v.numpy()) for k, v in sd.items()},
        ref_t5.T5Config(**kw))
    port = t5.params_from_hf_tensors(sd, t5.T5Config(**kw), device="cpu")
    ids, mask = _batch(0)
    want = np.asarray(ref_t5.forward_logits(
        ref_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ids),
        jnp.asarray(mask), ref_t5.T5Config(**kw)))
    got = _port_logits(port, ids, mask)
    with torch.no_grad():
        oracle = hf(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(mask),
                    decoder_input_ids=torch.tensor(ids),
                    decoder_attention_mask=torch.tensor(mask)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    m = mask.astype(bool)
    np.testing.assert_allclose(got[m], oracle[m], rtol=HF_TOL, atol=HF_TOL)
    # the JAX tree carried across gives the same module
    carried = params_from_jax(_np(ref_params), t5.T5Config(**kw), "cpu")
    np.testing.assert_array_equal(_port_logits(carried, ids, mask), got)


@pytest.mark.parametrize("buckets,dist", [(8, 20), (32, 128)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_bit_equal(buckets, dist, bidirectional):
    rp = np.arange(-512, 513, dtype=np.int32)
    want = np.asarray(ref_t5.relative_position_bucket(
        jnp.asarray(rp), bidirectional, buckets, dist))
    got = t5.relative_position_bucket(torch.from_numpy(rp), bidirectional,
                                      buckets, dist).numpy()
    np.testing.assert_array_equal(got, want)
    # and the bias table built from them
    emb = np.random.default_rng(1).standard_normal((buckets, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        t5.position_bias(torch.from_numpy(emb), 7, 11, bidirectional,
                         buckets, dist).numpy(),
        np.asarray(ref_t5.position_bias(jnp.asarray(emb), 7, 11,
                                        bidirectional, buckets, dist)))


@pytest.fixture(scope="module")
def t5_dirs(tmp_path_factory):
    """(base dir, peft adapter dir) of a tiny v1.1-style T5 (gated, tied,
    as the JAX package's adapter test), the adapter's B random and its
    config naming the base."""
    root = tmp_path_factory.mktemp("t5")
    base_dir, adapter_dir = str(root / "base"), str(root / "adapter")
    model = _hf("gated-gelu", True)
    model.save_pretrained(base_dir)
    lora_model = get_peft_model(model, PeftLoraConfig(
        r=4, lora_alpha=8, lora_dropout=0.0,
        target_modules=list(t5.T5_TARGET_MODULES)))
    torch.manual_seed(5)
    with torch.no_grad():
        for name, p in lora_model.named_parameters():
            if "lora_B" in name:
                p.copy_(0.2 * torch.randn_like(p))
    lora_model.save_pretrained(adapter_dir)
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["base_model_name_or_path"] = base_dir
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return base_dir, adapter_dir


def _reps(model, seed=4):
    ids, mask = _batch(seed, s=7, pad_from=5)
    return np.asarray(model.encode(ids, mask))


def test_t5_sparse_encode_matches_reference(t5_dirs):
    base_dir, _ = t5_dirs
    port = T5Sparse.load(base_dir, device="cpu")
    ref = ref_t5e.T5Sparse.load(base_dir)
    got = _reps(port)
    assert got.shape == (2, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, _reps(ref), rtol=RTOL, atol=ATOL)
    # d_model < 2048: no scale; the per-token log then max, by hand
    ids, mask = _batch(4, s=7, pad_from=5)
    logits = _port_logits(port.params, ids, mask)
    want = (np.log1p(np.maximum(logits, 0)) * mask[:, :, None]).max(1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_peft_adapter_loads_as_reference(t5_dirs):
    base_dir, adapter_dir = t5_dirs
    cfg = t5.T5Config.from_pretrained(base_dir)
    port_lora, lc = t5.load_adapter(adapter_dir, cfg, device="cpu")
    ref_lora, ref_lc = ref_t5.load_adapter(adapter_dir,
                                           ref_t5.T5Config.from_pretrained(
                                               base_dir))
    assert lc.r == ref_lc.r and lc.scaling == ref_lc.scaling
    want = dict(tree_leaves(_np(ref_lora)))
    got = tree_leaves(port_lora)
    assert {p for p, _ in got} == set(want)
    for path, t in got:
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
    # merged and unmerged, and through load_from_lora
    ref = _reps(ref_t5e.T5Sparse.load(base_dir, lora_name_or_path=adapter_dir,
                                      merge_peft=False))
    for model in (T5Sparse.load(base_dir, lora_name_or_path=adapter_dir,
                                merge_peft=False, device="cpu"),
                  T5Sparse.load(base_dir, lora_name_or_path=adapter_dir,
                                device="cpu"),
                  T5Sparse.load_from_lora(adapter_dir, device="cpu")):
        np.testing.assert_allclose(_reps(model), ref, rtol=2e-4, atol=2e-4)


def test_adapter_files_cross_packages(t5_dirs, tmp_path):
    """The port's adapter loads in the JAX package and peft, and the JAX
    package's in the port, factor for factor."""
    base_dir, _ = t5_dirs
    cfg = t5.T5Config.from_pretrained(base_dir)
    ref_cfg = ref_t5.T5Config.from_pretrained(base_dir)
    lora = ref_t5.init_lora_params(ref_cfg, 4, jax.random.PRNGKey(0))
    lora = _np(jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                              x.shape), lora))
    lc = dict(r=4, lora_alpha=8, target_modules=t5.T5_TARGET_MODULES,
              base_model_name_or_path=base_dir,
              base_model_class="T5ForConditionalGeneration")
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    t5.save_adapter(lora_from_jax(lora, "cpu"), LoraConfig(**lc), port_dir)
    ref_t5.save_adapter(jax.tree_util.tree_map(jnp.asarray, lora),
                        RefLoraConfig(**lc), ref_dir)
    want = dict(tree_leaves(lora))
    for loaded in (ref_t5.load_adapter(port_dir, ref_cfg)[0],
                   t5.load_adapter(ref_dir, cfg, device="cpu")[0]):
        got = tree_leaves(loaded)
        assert {p for p, _ in got} == set(want)
        for path, t in got:
            np.testing.assert_array_equal(np.asarray(t), want[path],
                                          err_msg=path)
    # peft attaches the port's artifact to the base model
    from peft import PeftModel

    peft_model = PeftModel.from_pretrained(HFT5.from_pretrained(base_dir),
                                           port_dir)
    # one lora_A and one lora_B per layer of each (a, b) pair: L = 2
    assert sum("lora_" in n for n, _ in peft_model.named_parameters()) == \
        2 * len(want)


def test_lora_apply_merge_and_unload(t5_dirs):
    """build's fresh LoRA (B = 0) is a no-op; with live B the unmerged
    forward equals the merged weights, which differ from the base, and the
    merge's source object encodes as the merged model."""
    base_dir, _ = t5_dirs
    args = types.SimpleNamespace(lora=True, lora_r=4, lora_alpha=8,
                                 lora_dropout=0.0)
    enc = T5Sparse.build(base_dir, args, device="cpu")
    base = _reps(T5Sparse.load(base_dir, device="cpu"))
    np.testing.assert_array_equal(_reps(enc), base)
    g = torch.Generator().manual_seed(3)
    for side in enc.lora.values():
        for fac in side["layers"].values():
            fac["b"] += 0.05 * torch.randn(fac["b"].shape, generator=g)
    unmerged = _reps(enc)
    merged = enc.merge_and_unload()
    np.testing.assert_allclose(_reps(merged), unmerged, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(_reps(enc), _reps(merged))
    assert enc.lora is None and np.abs(unmerged - base).max() > 1e-4


def test_checkpoint_written_by_port_loads_everywhere(tmp_path):
    """save_pretrained's checkpoint (untied v1.1) loads in transformers,
    the JAX package and the port, with the same logits."""
    src = _hf("gated-gelu", False, seed=2)
    cfg = t5.T5Config(**TINY, feed_forward_proj="gated-gelu",
                      tie_word_embeddings=False)
    port = t5.params_from_hf_tensors(src.state_dict(), cfg, device="cpu")
    out = str(tmp_path / "ckpt")
    t5.save_pretrained(port, cfg, out)
    ids, mask = _batch(6)
    want = _port_logits(port, ids, mask)
    back, back_cfg = t5.load_pretrained(out, device="cpu")
    assert back_cfg == cfg
    np.testing.assert_array_equal(_port_logits(back, ids, mask), want)
    ref_params, ref_cfg = ref_t5.load_pretrained(out)
    np.testing.assert_allclose(np.asarray(ref_t5.forward_logits(
        ref_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ids),
        jnp.asarray(mask), ref_cfg)), want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        oracle = HFT5.from_pretrained(out).eval()(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
            decoder_input_ids=torch.tensor(ids),
            decoder_attention_mask=torch.tensor(mask)).logits.numpy()
    m = mask.astype(bool)
    np.testing.assert_allclose(want[m], oracle[m], rtol=HF_TOL, atol=HF_TOL)


def test_registry_and_loss_variants():
    assert encoder.MODEL_REGISTRY[("t5", "sparse", "nce")] is T5Sparse
    assert (encoder.MODEL_REGISTRY[("t5", "sparse", "margin_mse")]
            is T5SparseForMarginMSE)
    for cls, ref in ((T5Sparse, ref_t5e.T5Sparse),
                     (T5SparseForMarginMSE, ref_t5e.T5SparseForMarginMSE)):
        assert (cls.MODEL_TYPE, cls.POOLING, cls.LOSS_TYPE,
                cls.BASE_MODEL_CLASS) == (ref.MODEL_TYPE, ref.POOLING,
                                          ref.LOSS_TYPE,
                                          ref.BASE_MODEL_CLASS)
    with pytest.raises(KeyError):
        encoder.MODEL_REGISTRY[("t5", "sparse", "kldiv")]


class _ListLoader(list):
    def set_epoch(self, e):
        pass


def test_three_trainer_steps_match_reference(t5_dirs, tmp_path):
    """Three optimizer steps (gas 2, warmup, decay, clipping) of each
    package's Trainer over the same NCE batches from the same factors."""
    base_dir, _ = t5_dirs
    ref_cfg = ref_t5.T5Config.from_pretrained(base_dir)
    ref_params, _ = ref_t5.load_pretrained(base_dir)
    lora = _np(jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                               x.shape),
        ref_t5.init_lora_params(ref_cfg, 4, jax.random.PRNGKey(2))))
    lc = dict(r=4, lora_alpha=8, lora_dropout=0.0,
              target_modules=t5.T5_TARGET_MODULES)
    rng = np.random.default_rng(0)

    def tok(n, s=8):
        ids = rng.integers(2, 128, (n, s)).astype(np.int32)
        mask = np.ones((n, s), np.int32)
        for i in range(n):
            mask[i, s - int(rng.integers(0, 3)):] = 0
        return {"input_ids": ids * mask, "attention_mask": mask}

    batches = [{"tokenized_queries": tok(2), "tokenized_contexts": tok(6),
                "target_labels": np.arange(2, dtype=np.int32)}
               for _ in range(6)]
    kw = dict(max_steps=3, logging_steps=1, learning_rate=3e-3,
              warmup_steps=1, weight_decay=0.01, max_grad_norm=0.05,
              gradient_accumulation_steps=2, lora_dropout=0.0, reg_T=4,
              lora_r=4, lora_alpha=8,
              task_names=("rank", "query_reg", "doc_reg"),
              task_weights=(1.0, 0.5, 0.4))
    ref = ref_t5e.T5Sparse(ref_params, ref_cfg,
                           jax.tree_util.tree_map(jnp.asarray, lora),
                           RefLoraConfig(**lc))
    ref_tr = ref_trainer.Trainer(ref, ref_trainer.LLM2RetrieverTrainingArgs(
        output_dir=str(tmp_path / "ref"), **kw), _ListLoader(batches))
    ref_tr.train()
    port = T5Sparse(t5.load_pretrained(base_dir, device="cpu")[0],
                    t5.T5Config.from_pretrained(base_dir),
                    lora_from_jax(lora, "cpu", trainable=True),
                    LoraConfig(**lc))
    tr = Trainer(port, LLM2RetrieverTrainingArgs(
        output_dir=str(tmp_path / "port"), **kw), _ListLoader(batches))
    tr.train()

    def logs(d):
        with open(os.path.join(str(tmp_path / d), "trainer_log.jsonl")) as f:
            return [json.loads(line) for line in f]

    got, want = logs("port"), logs("ref")
    assert [e["step"] for e in got] == [e["step"] for e in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k != "elapsed_sec":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                           err_msg=k)
    want_leaves = dict(tree_leaves(_np(ref_tr.trainable)))
    start = dict(tree_leaves(lora))
    for path, t in tree_leaves(tr.trainable):
        np.testing.assert_allclose(t.detach().numpy(), want_leaves[path],
                                   rtol=1e-4, atol=1e-6, err_msg=path)
    assert max(np.abs(t.detach().numpy() - start[p]).max()
               for p, t in tree_leaves(tr.trainable)) > 1e-4
    # the trained adapter is the peft T5 layout, and it reloads
    tr.save_model(str(tmp_path / "adapter"))
    reloaded, _ = t5.load_adapter(str(tmp_path / "adapter"), port.config,
                                  device="cpu")
    for (p, a), (_, b) in zip(tree_leaves(reloaded),
                              tree_leaves(tr.trainable)):
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy(),
                                      err_msg=p)


def test_cuda_default_raises_without_a_card(t5_dirs, tmp_path):
    """T5Sparse and train_sparse --model_type t5 default to the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs")
    from scaling_retriever_tpu_torch.training import train_sparse

    base_dir, adapter_dir = t5_dirs
    with pytest.raises((RuntimeError, AssertionError)):
        T5Sparse.load(base_dir)
    with pytest.raises((RuntimeError, AssertionError)):
        T5Sparse.load_from_lora(adapter_dir)
    corpus = tmp_path / "c.tsv"
    corpus.write_text("d0\tw1 w2\n")
    train = tmp_path / "t.jsonl"
    train.write_text(json.dumps({"question": "w1", "pos_pid": "d0",
                                 "neg_pids": ["d0"]}) + "\n")
    with pytest.raises((RuntimeError, AssertionError)):
        train_sparse.build_training(
            ["--model_name_or_path", base_dir, "--model_type", "t5",
             "--corpus_path", str(corpus), "--train_path", str(train),
             "--output_dir", str(tmp_path / "o"), "--data_source",
             "msmarco"], "sparse", tokenizer=lambda *a, **k: None)
