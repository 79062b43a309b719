"""train_sparse and train_dense on tiny files with ``--device cpu``, one
from the command line; every loss type's dataset and collator through
the CLI; the adapter the port trains loads in the JAX package and encodes
as the port's model does (rtol 1e-4, atol 1e-5, as
test_torch_encoder_load.py); a JAX-trained adapter resumes training in
the port; ``--no_lora`` writes a checkpoint the JAX package loads;
``--model_type t5`` trains T5Sparse into a peft T5 adapter that the JAX
package loads and encodes with as the port does, and refuses what the
reference refuses for T5."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scaling_retriever_tpu.models import encoder as ref_encoder
from scaling_retriever_tpu.training import train_sparse as ref_train_sparse
from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
from scaling_retriever_tpu_torch.training import train_dense, train_sparse
from scaling_retriever_tpu_torch.training.trainer import Trainer, tree_leaves

sys.path.insert(0, os.path.dirname(__file__))
from helpers import (make_msmarco_style_data, make_tiny_llama_dir,  # noqa: E402
                     make_tiny_t5_dir)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    model_dir = make_tiny_llama_dir(os.path.join(root, "model"))
    corpus, queries, _ = make_msmarco_style_data(os.path.join(root, "d"),
                                                 n_docs=30, n_queries=8)
    with open(corpus) as f:
        pids = [line.split("\t")[0] for line in f]
    with open(queries) as f:
        qs = [line.rstrip("\n").split("\t")[1] for line in f]
    rng = np.random.default_rng(0)
    train = {}
    for kind in ("nce", "kldiv", "margin_mse"):
        train[kind] = os.path.join(root, f"{kind}.jsonl")
        with open(train[kind], "w") as f:
            for i, q in enumerate(qs):
                negs = pids[8:16]
                if kind == "margin_mse":
                    ex = {"query": q, "docids": [f"doc{i}"] + negs,
                          "scores": rng.standard_normal(9).tolist()}
                else:
                    ex = {"question": q, "pos_pid": f"doc{i}",
                          "neg_pids": negs}
                    if kind == "kldiv":
                        ex["pos_score"] = float(rng.standard_normal())
                        ex["neg_scores"] = rng.standard_normal(8).tolist()
                f.write(json.dumps(ex) + "\n")
    return model_dir, corpus, train


def _argv(files, out, loss="nce", *extra):
    model_dir, corpus, train = files
    return ["--model_name_or_path", model_dir, "--corpus_path", corpus,
            "--train_path", train["kldiv" if "kldiv" in loss else loss],
            "--output_dir", str(out), "--loss_type", loss, "--max_steps",
            "3", "--logging_steps", "1", "--per_device_train_batch_size",
            "2", "--n_negs", "2", "--query_max_length", "16",
            "--doc_max_length", "16", "--lora_r", "4", "--lora_alpha", "8",
            "--data_source", "msmarco", "--learning_rate", "5e-3",
            "--device", "cpu", *extra]


def _ids():
    rng = np.random.default_rng(4)
    ids = rng.integers(4, 200, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, :4] = 0
    return ids * mask, mask


def test_train_sparse_from_the_command_line(files, tmp_path):
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "scaling_retriever_tpu_torch.training."
         "train_sparse", *_argv(files, out, "nce", "--fixed_length")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out / "trainer_log.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert [e["step"] for e in logs] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) for e in logs)
    # the adapter loads in the JAX package and encodes as the port does
    ref = ref_encoder.LlamaBiSparse.load_from_lora(str(out))
    port = LlamaBiSparse.load_from_lora(str(out), device="cpu")
    ids, mask = _ids()
    np.testing.assert_allclose(port.encode(ids, mask).numpy(),
                               np.asarray(ref.encode(ids, mask)),
                               rtol=RTOL, atol=ATOL)
    base = LlamaBiSparse.load(files[0], device="cpu")
    assert (port.encode(ids, mask) - base.encode(ids, mask)).abs().max() \
        > 1e-4


@pytest.mark.parametrize("loss", ["margin_mse", "kldiv", "nce_kldiv"])
def test_each_loss_trains_through_the_cli(files, tmp_path, loss):
    tr = train_sparse.main(_argv(files, tmp_path, loss, "--remat", "full"))
    assert tr.step == 3 and tr.encoder.config.remat is True
    with open(tmp_path / "trainer_log.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert all(np.isfinite(e["loss"]) for e in logs)
    assert "query_reg" in logs[-1]
    if loss == "nce_kldiv":
        assert {"nce", "kldiv"} <= set(logs[-1])


def test_train_dense_cli(files, tmp_path):
    tr = train_dense.main(_argv(files, tmp_path, "nce", "--T", "0.05"))
    assert tr.step == 3 and tr.encoder.POOLING == "dense"
    assert tr.encoder.T == 0.05
    with open(tmp_path / "adapter_config.json") as f:
        assert json.load(f)["auto_mapping"]["base_model_class"] == \
            "LlamaBiModel"
    with open(tmp_path / "trainer_log.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert set(logs[-1]) == {"step", "elapsed_sec", "loss", "grad_norm",
                             "rank"}


def test_no_lora_checkpoint_loads_in_jax(files, tmp_path):
    train_sparse.main(_argv(files, tmp_path, "nce", "--no_lora",
                            "--learning_rate", "1e-3"))
    assert os.path.exists(tmp_path / "model.safetensors")
    ref = ref_encoder.LlamaBiSparse.load(str(tmp_path))
    port = LlamaBiSparse.load(str(tmp_path), device="cpu")
    ids, mask = _ids()
    np.testing.assert_allclose(port.encode(ids, mask).numpy(),
                               np.asarray(ref.encode(ids, mask)),
                               rtol=RTOL, atol=ATOL)


def test_jax_adapter_resumes_training_in_the_port(files, tmp_path):
    jax_out = tmp_path / "jax"
    ref_train_sparse.main(_argv(files, jax_out)[:-2] + ["--fixed_length"])
    port = LlamaBiSparse.load(files[0], lora_name_or_path=str(jax_out),
                              is_trainable=True, device="cpu")
    assert port.lora is not None
    from scaling_retriever_tpu.models.lora import load_adapter
    ref_lora, _ = load_adapter(str(jax_out), port.config)
    start = dict(tree_leaves(ref_lora))
    for path, t in tree_leaves(port.lora):
        assert t.requires_grad
        np.testing.assert_array_equal(t.detach().numpy(),
                                      np.asarray(start[path]))
    trainer, _ = train_sparse.build_training(
        _argv(files, tmp_path / "port"), "sparse")
    resumed = Trainer(port, trainer.args, trainer.train_loader)
    resumed.train()
    assert resumed.step == 3
    moved = max(float((t.detach() - torch.from_numpy(
        np.array(start[p]))).abs().max())
        for p, t in tree_leaves(port.lora))
    assert moved > 1e-4
    resumed.save_model(str(tmp_path / "again"))
    assert os.path.exists(tmp_path / "again" / "adapter_model.safetensors")


def test_t5_raises_not_ported(files, tmp_path):
    """``--model_type t5``: nce trains T5Sparse through the Trainer and
    saves a peft T5 adapter; the JAX package's T5Sparse loads it and
    encodes as the port's does (rtol 1e-4, atol 1e-5). kldiv and
    ``--remat`` are refused, as in the reference."""
    from scaling_retriever_tpu.models.t5_encoder import T5Sparse as RefT5
    from scaling_retriever_tpu_torch.models.t5_encoder import T5Sparse

    t5_dir = make_tiny_t5_dir(str(tmp_path / "t5"))
    argv = _argv(files, tmp_path / "out", "nce", "--model_type", "t5")
    argv[argv.index("--model_name_or_path") + 1] = t5_dir
    trainer = train_sparse.main(argv)
    assert isinstance(trainer.encoder, T5Sparse) and trainer.step == 3
    with open(tmp_path / "out" / "adapter_config.json") as f:
        cfg = json.load(f)
    assert cfg["auto_mapping"]["base_model_class"] == \
        "T5ForConditionalGeneration"
    assert set(cfg["target_modules"]) == {"q", "k", "v", "o", "wi_0",
                                          "wi_1", "wo"}
    port = T5Sparse.load_from_lora(str(tmp_path / "out"), device="cpu")
    ref = RefT5.load_from_lora(str(tmp_path / "out"))
    ids, mask = _ids()
    mask = mask[:, ::-1].copy()          # T5 pads on the right
    np.testing.assert_allclose(port.encode(ids, mask).numpy(),
                               np.asarray(ref.encode(ids, mask)),
                               rtol=RTOL, atol=ATOL)
    for extra in (("--loss_type", "kldiv"), ("--remat", "full")):
        with pytest.raises(SystemExit):
            train_sparse.build_training(argv + list(extra), "sparse")
