"""The port's training drivers (benches/train.py, benches/mntp.py) against
bench_train.py and bench_mntp.py on the CPU: the published widths and
remat choices, the batches' rng draws, the model FLOPs against a hand
count, and, at tiny widths in float32 (patched ``MODELS``), the first two
steps' losses against the JAX ``Trainer`` the benches set up, from the
same weights and LoRA factors (carried by ``params_from_jax`` and
``lora_from_jax``) on the same batch; then each driver's rehearsal.

Tolerance: losses rtol 1e-4, atol 1e-6, test_torch_trainer.py's (the
frameworks sum the matmuls in other orders, ~1e-6 relative, and the
softmax and the pooling max amplify it)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_mntp  # noqa: E402
import bench_train  # noqa: E402
from scaling_retriever_tpu.models import llama as ref_llama  # noqa: E402
from scaling_retriever_tpu.models.config import (  # noqa: E402
    ModelConfig as RefModelConfig)
from scaling_retriever_tpu.models.encoder import (  # noqa: E402
    LlamaBiSparse as RefLlamaBiSparse)
from scaling_retriever_tpu.models.lora import (  # noqa: E402
    LoraConfig as RefLoraConfig)
from scaling_retriever_tpu.models.lora import init_lora_params  # noqa: E402
from scaling_retriever_tpu.training import trainer as ref_trainer  # noqa: E402
from scaling_retriever_tpu.training.mntp import (  # noqa: E402
    MNTPModel as RefMNTPModel)
from scaling_retriever_tpu_torch.benches import (  # noqa: E402
    common, mntp, train)
from scaling_retriever_tpu_torch.models.encoder import (  # noqa: E402
    LlamaBiSparse)
from scaling_retriever_tpu_torch.models.lora import LoraConfig  # noqa: E402
from scaling_retriever_tpu_torch.models.weights import (  # noqa: E402
    lora_from_jax, params_from_jax)
from scaling_retriever_tpu_torch.training.mntp import MNTPModel  # noqa: E402
from scaling_retriever_tpu_torch.training.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, tie_word_embeddings=True)
# bench_train.py:118-124 and bench_mntp.py:67-73, as they write them
REF_ROPE = dict(rope_theta=500000.0, max_position_embeddings=131072,
                rope_scaling={"rope_type": "llama3", "factor": 32.0,
                              "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                              "original_max_position_embeddings": 8192})


def test_models_and_remat_equal_bench_train():
    assert train.MODELS == bench_train.MODELS
    assert set(train.REMAT) == set(bench_train.REMAT)
    for name, value in bench_train.REMAT.items():
        assert train.REMAT[name] == value, name
    cfg = train.model_config("8b", "attn")
    assert cfg.rope_scaling == REF_ROPE["rope_scaling"]
    assert (cfg.rope_theta, cfg.max_position_embeddings) == (500000.0,
                                                             131072)
    assert cfg.dtype == cfg.param_dtype == torch.bfloat16
    assert cfg.remat == bench_train.REMAT["attn"]
    assert not cfg.tie_word_embeddings and cfg.q_dim == 4096


def _ref_train_batch(seed, vocab, bz):
    """bench_train.py:146-158's draws (numpy, before the device)."""
    rng = np.random.default_rng(seed)
    n_ctx = bz * (1 + bench_train.N_NEGS)
    return (rng.integers(4, vocab, (bz, bench_train.Q_LEN)),
            rng.integers(4, vocab, (n_ctx, bench_train.D_LEN)))


def _ref_mntp_batch(seed, vocab, bz, seq):
    """bench_mntp.py:93-103's draws."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (bz, seq)).astype(np.int32)
    picked = rng.random((bz, seq)) < bench_mntp.MLM_P
    labels = np.where(picked, ids, -100).astype(np.int32)
    masked_ids = np.where(picked & (rng.random((bz, seq)) < 0.8), 95, ids)
    return masked_ids, labels


def test_batches_equal_bench_draws():
    b = train.make_batch(0, 128_256, 8)
    q, c = _ref_train_batch(0, 128_256, 8)
    np.testing.assert_array_equal(b["tokenized_queries"]["input_ids"], q)
    np.testing.assert_array_equal(b["tokenized_contexts"]["input_ids"], c)
    assert b["tokenized_contexts"]["input_ids"].shape == (136, 128)
    assert (b["tokenized_queries"]["attention_mask"] == 1).all()
    np.testing.assert_array_equal(b["target_labels"], np.arange(8))
    assert (mntp.SEQ, mntp.MLM_P) == (bench_mntp.SEQ, bench_mntp.MLM_P)
    m = mntp.make_batch(0, 128_256, 8)
    ids, labels = _ref_mntp_batch(0, 128_256, 8, 512)
    np.testing.assert_array_equal(m["input_ids"], ids)
    np.testing.assert_array_equal(m["labels"], labels)
    assert 0.15 < (labels != -100).mean() < 0.25


def test_model_flops_hand_count():
    """1B widths, one group of 8 rows x 64 tokens: per token and layer
    2 * (q 2048*2048 + k, v 2 * 2048*512 + o 2048*2048 + mlp 3 * 2048*8192
    + attention 2 * 64 * 2048) FLOPs forward, as many again backward to
    the activations (the base is frozen), once more under full remat; the
    head 2 * 128,256 * 2048 a token, forward and backward."""
    cfg = train.model_config("1b", "full")
    tokens = 8 * 64
    per_layer = 2 * (2048 * 2048 + 2 * 2048 * 512 + 2048 * 2048
                     + 3 * 2048 * 8192 + 2 * 64 * 2048)
    head = 2 * 128_256 * 2048
    for remat, passes in ((False, 2), (True, 3)):
        want = tokens * (16 * per_layer * passes + head * 2)
        assert common.model_flops(cfg, [(8, 64)], True, remat) == want
    assert common.model_flops(cfg, [(8, 64)], False, False) == \
        tokens * 16 * per_layer * 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["train", "mntp"])
def test_first_steps_equal_jax_trainer(monkeypatch, tmp_path, kind):
    """Two steps of each package's Trainer as the benches set it up (LoRA r
    16, alpha 32, dropout 0; B zero, so step 1's update moves B only), at
    tiny widths in float32 under full remat: both losses equal."""
    monkeypatch.setitem(bench_train.MODELS, "1b", TINY)
    monkeypatch.setitem(train.MODELS, "1b", TINY)
    ref_cfg = RefModelConfig(**REF_ROPE, dtype=jnp.float32,
                             param_dtype=jnp.float32,
                             remat=bench_train.REMAT["full"],
                             **bench_train.MODELS["1b"])
    cfg = train.model_config("1b", "full", torch.float32)
    params = ref_llama.init_params(ref_cfg, jax.random.PRNGKey(0))
    ref_lc = RefLoraConfig(r=16, lora_alpha=32, lora_dropout=0.0,
                           base_model_name_or_path="llama-random")
    lora = init_lora_params(ref_cfg, ref_lc, jax.random.PRNGKey(1),
                            dtype=jnp.float32)
    lc = LoraConfig(r=16, lora_alpha=32, lora_dropout=0.0)
    port_params = params_from_jax(_np(params), cfg, "cpu")
    port_lora = lora_from_jax(_np(lora), "cpu", trainable=True)
    if kind == "train":
        tasks, weights = ("rank", "query_reg", "doc_reg"), (1.0, 0.01, 0.008)
        ref_enc = RefLlamaBiSparse(params, ref_cfg, lora, ref_lc)
        enc = LlamaBiSparse(port_params, cfg, port_lora, lc)
        batch = train.make_batch(0, TINY["vocab_size"], 2)
    else:
        tasks, weights = ("rank",), (1.0,)
        ref_enc = RefMNTPModel(params, ref_cfg, lora, ref_lc)
        enc = MNTPModel(port_params, cfg, port_lora, lc)
        monkeypatch.setattr(mntp, "SEQ", 64)
        batch = mntp.make_batch(0, TINY["vocab_size"], 2)
    args = ref_trainer.LLM2RetrieverTrainingArgs(
        output_dir=str(tmp_path / "ref"), max_steps=bench_train.STEPS,
        logging_steps=10 ** 9, lora=True, lora_r=16, lora_alpha=32,
        lora_dropout=0.0, task_names=tasks, task_weights=weights, bf16=True)
    ref = ref_trainer.Trainer(ref_enc, args, train_loader=[])
    ours = Trainer(enc, train.training_args(str(tmp_path / "port"), tasks,
                                            weights), train_loader=[])
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tr, opt = ref.trainable, ref.opt_state
    for step in (1, 2):
        tr, opt, metrics = ref._jit_step(tr, opt, jb,
                                         jnp.asarray(step, jnp.int32))
        got = ours._train_step(train.to_device(batch, "cpu"), step)
        ours.step += 1
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                                   rtol=RTOL, atol=ATOL, err_msg=str(step))


@pytest.mark.parametrize("mod", [train, mntp],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_training_driver_rehearsal(monkeypatch, capsys, mod):
    monkeypatch.setitem(train.MODELS, "1b", TINY)
    for name, v in (("WARM", 1), ("STEPS", 2), ("Q_LEN", 8), ("D_LEN", 16)):
        monkeypatch.setattr(train, name, v)
    monkeypatch.setattr(mntp, "SEQ", 32)
    rc = mod.main(["--device", "cpu", "--bz", "2", "--breakdown"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True and line["card"] == "cpu"
    assert line["metric"] in ("train_step_ms_llama1b_lora_nce",
                              "mntp_step_ms_llama1b_lora")
    assert line["value"] > 0 and 0 < line["mfu"] < 1
    assert line["peak_gb"] is None          # not measured on the CPU
    arm = line["arms"]["full"]
    assert arm["flops_per_step"] == line["flops_per_step"] > 0
    assert set(line["stages"]) == {"fwd_ms", "grad_ms", "step_ms",
                                   "optimizer_ms"}
    assert np.isfinite([arm["loss_first"], arm["loss_last"]]).all()
