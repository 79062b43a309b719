"""The training CLIs under ``torch.distributed.run`` (the reference's
launcher; ``--standalone`` rendezvous on a free local port, gloo, 2
ranks, ``--device cpu``) against the same CLI in one process."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scaling_retriever_tpu_torch.models.lora import load_adapter
from scaling_retriever_tpu_torch.training.trainer import tree_leaves
from test_torch_distributed import ATOL, ROOT, RTOL, logs

torch.set_num_threads(1)


@pytest.mark.parametrize("cli", ["train_sparse", "mntp"])
def test_cli_under_torchrun_matches_one_process(cli, tmp_path):
    """``train_sparse`` (2 queries a rank) and ``mntp`` (its loader batch,
    4 rows, split over the ranks; with its evaluation, which runs on every
    rank) under ``torch.distributed.run --nproc_per_node 2`` (gloo,
    ``--device cpu``) write an adapter and losses equal to the
    one-process CLI's."""
    sys.path.insert(0, os.path.dirname(__file__))
    from helpers import make_msmarco_style_data, make_tiny_llama_dir

    from scaling_retriever_tpu_torch.models.config import \
        ModelConfig as PortConfig
    from scaling_retriever_tpu_torch.training import mntp, train_sparse

    model_dir = make_tiny_llama_dir(str(tmp_path / "model"))
    corpus, queries, _ = make_msmarco_style_data(str(tmp_path / "d"),
                                                 n_docs=30, n_queries=8)
    with open(queries) as f:
        qs = [line.rstrip("\n").split("\t")[1] for line in f]
    train_path = str(tmp_path / "train.jsonl")
    with open(train_path, "w") as f:
        for i, q in enumerate(qs):
            f.write(json.dumps({"question": q, "pos_pid": f"doc{i}",
                                "neg_pids": [f"doc{j}" for j in
                                             range(8, 16)]}) + "\n")

    def argv(out, ranks):
        common = ["--model_name_or_path", model_dir, "--output_dir", out,
                  "--lora_r", "4", "--logging_steps", "1",
                  "--learning_rate", "1e-3", "--device", "cpu"]
        if cli == "mntp":
            return common + [
                "--train_file", corpus, "--max_seq_length", "16",
                "--stop_after_n_steps", "2", "--per_device_train_batch_size",
                "4", "--mask_token_type", "eos", "--do_eval",
                "--validation_split_percentage", "10"]
        return common + [
            "--corpus_path", corpus, "--train_path", train_path,
            "--data_source", "msmarco", "--max_steps", "2",
            "--per_device_train_batch_size", str(4 // ranks),
            "--query_max_length", "8", "--doc_max_length", "16",
            "--lora_alpha", "8"]

    one = str(tmp_path / "one")
    (mntp if cli == "mntp" else train_sparse).main(argv(one, 1))
    two = str(tmp_path / "two")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [ROOT, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         f"scaling_retriever_tpu_torch.training.{cli}", *argv(two, 2)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    cfg = PortConfig.from_pretrained(model_dir)
    a, _ = load_adapter(one, cfg, device="cpu")
    b, _ = load_adapter(two, cfg, device="cpu")
    for (pa, ta), (pb, tb) in zip(tree_leaves(a), tree_leaves(b)):
        assert pa == pb
        np.testing.assert_allclose(tb.numpy(), ta.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=pa)
    assert max(float(t.abs().max()) for p, t in tree_leaves(b)
               if p.endswith(".b")) > 0
    la, lb = logs(one), logs(two)
    assert [e["step"] for e in lb] == [e["step"] for e in la]
    assert [e["step"] for e in lb if "loss" in e] == [1, 2]
    for ea, eb in zip(la, lb):
        for k in ea:
            if k != "elapsed_sec":
                np.testing.assert_allclose(eb[k], ea[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
