"""Training over 4 ranks (gloo on the CPU, spawned as in
tests/test_torch_distributed.py, whose rank bodies this file uses): FSDP
over (data 4) and tensor parallelism over (data 2, model 2), at LoRA
dropout 0 and 0.1, both together over (data 2, model 2), and the whole
model (``lora=False``) under each of the three, with its checkpoint and
resume. Each
run's losses, grad norms and trainable after three optimizer steps equal
the one-process Trainer's over the global batch within rtol 1e-5, atol
1e-6 (cross-rank sum order), and at dropout 0 the JAX package's Trainer
on its CPU mesh of the same shape within tests/test_torch_trainer.py's
tolerances. Every parameter's placement equals its recorded
``sharding_spec``: ``Shard(d)`` on each mesh axis the spec names at d,
``Replicate()`` on the others, and a plain tensor where the spec is
replicated."""

import os

import numpy as np
import pytest
import torch

from scaling_retriever_tpu_torch.models.hf_loader import load_pretrained
from test_torch_distributed import (JAX_ATOL, JAX_RTOL, assert_same_run,
                                    jax_trainable, logs, nce_batches,
                                    rank_results, spawn, start_numbers,
                                    train, trainable_of)

# name: (data, model, fsdp, LoRA dropout, LoRA)
RUNS = {"fsdp0": (4, 1, True, 0.0, True), "fsdp1": (4, 1, True, 0.1, True),
        "tp0": (2, 2, False, 0.0, True), "tp1": (2, 2, False, 0.1, True),
        "fsdp_full": (4, 1, True, 0.0, False),
        "tp_full": (2, 2, False, 0.1, False),
        "tp_fsdp0": (2, 2, True, 0.0, True),
        "tp_fsdp_full": (2, 2, True, 0.1, False)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world4"))
    params, lora = start_numbers()
    batches = nce_batches(6)
    dirs = {}
    jobs = []
    for name, (data, model, fsdp, dropout, use_lora) in RUNS.items():
        dirs[name] = os.path.join(tmp, name)
        os.makedirs(dirs[name])
        jobs.append(("job_train", dict(
            out=dirs[name], kind="LlamaBiSparse", params=params,
            lora=lora if use_lora else None, batches=batches, data=data,
            model=model, fsdp=fsdp, lora_dropout=dropout,
            **({} if use_lora else {"learning_rate": 1e-4}))))
    for name in ("fsdp_full", "tp_full", "tp_fsdp_full"):
        data, model, fsdp, _, _ = RUNS[name]
        dirs["resume_" + name] = os.path.join(tmp, "resume_" + name)
        os.makedirs(dirs["resume_" + name])
        jobs.append(("job_resume", dict(
            out=dirs["resume_" + name], kind="LlamaBiSparse", params=params,
            lora=None, batches=nce_batches(5, seed=7), data=data,
            model=model, fsdp=fsdp, learning_rate=1e-4,
            gradient_accumulation_steps=1)))
    spawn(4, jobs, tmp)
    return dict(dirs=dirs, params=params, lora=lora, batches=batches)


@pytest.mark.parametrize("name", list(RUNS))
def test_matches_one_process(world4, name, tmp_path):
    data, model, fsdp, dropout, use_lora = RUNS[name]
    w = world4
    one = train(str(tmp_path), "LlamaBiSparse", w["params"],
                w["lora"] if use_lora else None, w["batches"],
                lora_dropout=dropout,
                **({} if use_lora else {"learning_rate": 1e-4}))
    ranks = rank_results(w["dirs"][name], 4)
    for r in ranks[1:]:
        for p, t in r["trainable"].items():
            assert (t == ranks[0]["trainable"][p]).all(), p
    assert_same_run(w["dirs"][name], str(tmp_path), ranks[0]["trainable"],
                    trainable_of(one))


@pytest.mark.parametrize("name", ["fsdp0", "tp0", "tp_fsdp0"])
def test_placements_equal_recorded_specs(world4, name):
    """FSDP shards the MLP, the embeddings and the head over data (the
    attention and the norms stay plain); tensor parallelism shards every
    projection over model; both together split the MLP over both axes."""
    for r in rank_results(world4["dirs"][name], 4):
        assert r["mismatches"] == []
        names = r["dtensors"]
        if name == "fsdp0":
            assert "embed_tokens.weight" in names and "lm_head.weight" in \
                names and "layers.0.wg.weight" in names
            assert not any(".wq." in n or "norm" in n for n in names)
        elif name == "tp0":
            assert len(names) == 2 * 7 and "layers.1.wd.weight" in names
        else:
            assert len(names) == 2 * 7 + 2 and "embed_tokens.weight" in names


@pytest.mark.parametrize("name", ["fsdp0", "tp0", "tp_fsdp0"])
def test_matches_jax_trainer(world4, name, tmp_path):
    data, model, fsdp, _, _ = RUNS[name]
    w = world4
    want = jax_trainable(str(tmp_path), w["params"], w["lora"],
                         w["batches"], data, model, fsdp=fsdp)
    got = rank_results(w["dirs"][name], 4)[0]["trainable"]
    for eg, ew in zip(logs(w["dirs"][name]), logs(str(tmp_path))):
        for k in ew:
            if k != "elapsed_sec":
                np.testing.assert_allclose(eg[k], ew[k], rtol=JAX_RTOL,
                                           atol=JAX_ATOL, err_msg=k)
    for p, t in want.items():
        np.testing.assert_allclose(got[p].numpy(), t, rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=p)


@pytest.mark.parametrize("name", ["fsdp_full", "tp_full", "tp_fsdp_full"])
def test_full_model_checkpoint_and_resume(world4, name):
    """Training the whole model sharded (FSDP, or tensor parallel), rank 0
    writes the HF checkpoint from the full weights (equal to the gathered
    trainable), and a resume from a full-state checkpoint, re-sharded on
    each rank, continues bit-equal to an uninterrupted run."""
    d = world4["dirs"][name]
    trained = rank_results(d, 4)[0]["trainable"]
    module, _ = load_pretrained(os.path.join(d, "full"), device="cpu")
    saved = dict(module.named_parameters())
    assert saved.keys() == trained.keys()
    for p, t in trained.items():
        assert torch.equal(saved[p], t), p
    for r in rank_results(world4["dirs"]["resume_" + name], 4):
        assert r["steps"] == (4, 4)
        for p, t in r["straight"].items():
            assert torch.equal(t, r["resumed"][p]), p
