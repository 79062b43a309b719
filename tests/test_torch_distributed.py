"""Training over several ranks: the Trainer launched as 2 processes
(``torch.multiprocessing.spawn``, gloo on the CPU, a ``file://``
rendezvous under the test's directory) against the same Trainer in one
process over the global batch, and against the JAX package's Trainer on a
2-device CPU mesh. Every rank iterates the same global batches; the
port's losses, grad norms and LoRA factors after three optimizer steps
(warmup, weight decay, clipping that engages, accumulation over 2 micro
steps) must equal the one-process run's within rtol 1e-5, atol 1e-6 (the
cross-rank sums run in another order), at LoRA dropout 0 and 0.1 (each
rank keeps its rows of the global batch's masks), and the JAX Trainer's
at dropout 0 within tests/test_torch_trainer.py's tolerances, and with a
query count that 2 ranks do not divide (encoded whole on each). Then MNTP
with ranks holding unequal counts of masked tokens, the rows
``shard_batch`` gives each rank, an adapter written by rank 0 (bit-equal
to one process's writing of the same factors), a resume at world 2
(bit-equal to an uninterrupted run at world 2), and T5Sparse over 2
ranks, replicated and under FSDP.

The rank bodies live in this module and import neither JAX nor the JAX
package (the spawned processes import this module); the JAX side runs in
the test process only. tests/test_torch_distributed_mesh.py runs 4 ranks
(FSDP, tensor parallelism) with the same bodies, and
tests/test_torch_distributed_cli.py the CLIs under ``torchrun``."""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard

from scaling_retriever_tpu_torch.models import encoder, t5
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.lora import LoraConfig, save_adapter
from scaling_retriever_tpu_torch.models.t5 import T5Config
from scaling_retriever_tpu_torch.models.t5_encoder import T5Sparse
from scaling_retriever_tpu_torch.models.weights import (lora_from_jax,
                                                        params_from_jax,
                                                        random_params)
from scaling_retriever_tpu_torch.parallel.mesh import make_mesh, shard_batch
from scaling_retriever_tpu_torch.training.mntp import MNTPModel
from scaling_retriever_tpu_torch.training.trainer import (
    LLM2RetrieverTrainingArgs, Trainer, tree_leaves)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6           # one process against several ranks
JAX_RTOL, JAX_ATOL = 1e-4, 1e-6   # tests/test_torch_trainer.py's
# wide enough that FSDP's 2^16-element rule shards the MLP, the
# embeddings and the head (the attention stays replicated), with whole
# heads for 2-way tensor parallelism
CFG = dict(vocab_size=512, hidden_size=128, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=64,
           tie_word_embeddings=False)
LORA = dict(r=4, lora_alpha=8)
T5CFG = dict(vocab_size=512, d_model=128, d_kv=32, d_ff=512, num_layers=2,
             num_decoder_layers=2, num_heads=4,
             feed_forward_proj="gated-gelu")
BZ, NNEG, SEQ = 8, 1, 8
ARGS = dict(max_steps=3, logging_steps=1, learning_rate=3e-3,
            warmup_steps=1, weight_decay=0.01, max_grad_norm=0.05,
            gradient_accumulation_steps=2, reg_T=4, lora_r=4, lora_alpha=8,
            task_names=("rank", "query_reg", "doc_reg"),
            task_weights=(1.0, 0.5, 0.4))


class ListLoader(list):
    def set_epoch(self, e):
        pass


def nce_batches(n, seed=0, bz=BZ):
    """``n`` NCE batches of ``bz`` queries and ``bz`` * (1 + NNEG)
    contexts, left-padded rows."""
    rng = np.random.default_rng(seed)

    def tok(rows):
        ids = rng.integers(4, CFG["vocab_size"], (rows, SEQ)).astype(np.int32)
        mask = np.ones((rows, SEQ), np.int32)
        for i in range(rows):
            mask[i, :int(rng.integers(0, 3))] = 0
        return {"input_ids": ids * mask, "attention_mask": mask}

    return [{"tokenized_queries": tok(bz),
             "tokenized_contexts": tok(bz * (1 + NNEG)),
             "target_labels": np.arange(bz, dtype=np.int32)}
            for _ in range(n)]


def mntp_batches(n, seed=0, rows=8, seq=16):
    """MNTP batches whose first half of rows holds far more masked label
    tokens than the second (so 2 ranks hold unequal counts)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(4, CFG["vocab_size"], (rows, seq)).astype(np.int32)
        labels = np.full((rows, seq), -100, np.int32)
        for i in range(rows):
            k = 10 if i < rows // 2 else 2
            at = rng.choice(np.arange(1, seq), k, replace=False)
            labels[i, at] = ids[i, at]
        out.append({"input_ids": ids,
                    "attention_mask": np.ones((rows, seq), np.int32),
                    "labels": labels})
    return out


def start_numbers(seed=1):
    """(params, live LoRA factors) in the JAX layout, as numpy trees, from
    the JAX package's initializers (the test process only)."""
    import jax

    from scaling_retriever_tpu.models import llama as ref_llama
    from scaling_retriever_tpu.models.lora import LoraConfig as RefLora
    from scaling_retriever_tpu.models.lora import init_lora_params

    cfg = jax_config()
    params = ref_llama.init_params(cfg, jax.random.PRNGKey(seed))
    lora = init_lora_params(cfg, RefLora(**LORA), jax.random.PRNGKey(2))
    lora = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                               x.shape), lora)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return as_np(params), as_np(lora)


def jax_config():
    import jax.numpy as jnp

    from scaling_retriever_tpu.models.config import ModelConfig as RefConfig

    return RefConfig(**CFG, dtype=jnp.float32, param_dtype=jnp.float32)


def t5_encoder(lora: bool):
    """A T5Sparse at T5CFG's widths from seeded torch draws (the same in
    every process), its LoRA's B factors made live."""
    cfg = T5Config(**T5CFG)
    module = random_params(cfg, 0, device="cpu")
    if not lora:
        return T5Sparse(module, cfg)
    g = torch.Generator().manual_seed(1)
    fac = t5.init_lora_params(cfg, LORA["r"], g, device="cpu")
    for side in fac.values():
        for f in side["layers"].values():
            f["b"] = 0.05 * torch.randn(f["b"].shape, generator=g)
            for t in f.values():
                t.requires_grad_(True)
    return T5Sparse(module, cfg, fac, LoraConfig(
        **LORA, target_modules=t5.T5_TARGET_MODULES))


def build_encoder(kind, params, lora, dropout):
    """The port's encoder of ``kind`` ("LlamaBiSparse", ..., "mntp", or
    "t5", which makes its own numbers: ``params`` unused) from numpy
    trees; ``lora`` None trains the whole module."""
    if kind == "t5":
        return t5_encoder(lora is not None)
    cfg = ModelConfig(**CFG)
    module = params_from_jax(params, cfg, "cpu")
    lc = LoraConfig(**LORA, lora_dropout=dropout)
    fac = None if lora is None else lora_from_jax(lora, "cpu",
                                                  trainable=True)
    if kind == "mntp":
        return MNTPModel(module, cfg, fac, lc if fac is not None else None)
    return getattr(encoder, kind)(module, cfg, fac,
                                  lc if fac is not None else None)


def train(out, kind, params, lora, batches, mesh=None, stop=None,
          resume=None, **kw):
    """A Trainer of ``kind`` over ``batches`` into ``out`` (ARGS updated by
    ``kw``); ``stop`` ends it after that many optimizer steps."""
    args = LLM2RetrieverTrainingArgs(**{**ARGS, **kw}, output_dir=out,
                                     lora=lora is not None,
                                     resume_from_checkpoint=resume)
    tr = Trainer(build_encoder(kind, params, lora, args.lora_dropout), args,
                 ListLoader(batches), mesh=mesh)
    if stop is not None:
        tr.args = dataclasses.replace(args, max_steps=stop)
    tr.train()
    return tr


def logs(out):
    with open(os.path.join(out, "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def trainable_of(tr):
    return {p: full(t).clone() for p, t in tree_leaves(tr.trainable)}


def placement_mismatches(params) -> list:
    """The parameters whose placement differs from their recorded spec:
    a DTensor is ``Shard(d)`` on each axis of its mesh that its spec names
    at d, ``Replicate()`` on the others, and its mesh covers every axis
    the spec names; any other tensor's spec is replicated. Returns (name,
    spec, placements) for each mismatch."""
    bad = []
    for name, p in params.named_parameters():
        spec = p.sharding_spec
        if not isinstance(p, DTensor):
            if any(a is not None for a in spec):
                bad.append((name, spec, None))
            continue
        want = [Shard(spec.index(axis)) if axis in spec else Replicate()
                for axis in p.device_mesh.mesh_dim_names]
        covered = set(p.device_mesh.mesh_dim_names)
        if list(p.placements) != want or any(
                a is not None and a not in covered for a in spec):
            bad.append((name, spec, tuple(p.placements)))
    return bad



# ---- the rank bodies (spawned; no JAX) ---------------------------------

def job_train(out, kind, params, lora, batches, data, model, **kw):
    """Train on a (data, model) mesh over the ranks; each rank writes its
    trainable and its parameters' placements against their specs."""
    rank = dist.get_rank()
    tr = train(out, kind, params, lora, batches,
               mesh=make_mesh(data, model, device="cpu"), **kw)
    module = tr.encoder.params
    torch.save({"trainable": trainable_of(tr),
                "mismatches": placement_mismatches(module),
                "dtensors": sorted(n for n, p in module.named_parameters()
                                   if hasattr(p, "placements"))},
               os.path.join(out, f"rank{rank}.pt"))
    if lora is None:
        tr.save_model(os.path.join(out, "full"))
    elif kw.get("lora_dropout", 0.0) > 0:
        tr.save_model(os.path.join(out, "adapter"))


def job_resume(out, kind, params, lora, batches, data, model, **kw):
    """Four steps straight, and two then a resume from checkpoint-2 for
    two more, at world 2 (dropout on)."""
    mesh = make_mesh(data, model, device="cpu")
    kw = {**kw, "max_steps": 4, "save_steps": 2}
    a = train(os.path.join(out, "straight"), kind, params, lora, batches,
              mesh, **kw)
    train(os.path.join(out, "cut"), kind, params, lora, batches, mesh,
          stop=2, **kw)
    c = train(os.path.join(out, "cut"), kind, params, lora, batches, mesh,
              resume=os.path.join(out, "cut", "checkpoint-2"), **kw)
    torch.save({"straight": trainable_of(a), "resumed": trainable_of(c),
                "steps": (a.step, c.step)},
               os.path.join(out, f"rank{dist.get_rank()}.pt"))


def job_shard_batch(out, data, model):
    mesh = make_mesh(data, model, device="cpu")
    b = {"x": np.arange(8 * 3).reshape(8, 3), "odd": np.arange(5),
         "s": np.float32(2.0), "ids": ["a", "b"]}
    got = shard_batch(b, mesh)
    torch.save({k: (v.tolist() if isinstance(v, torch.Tensor) else v)
                for k, v in got.items()},
               os.path.join(out, f"rank{dist.get_rank()}.pt"))


def _rank_main(rank, world, rdv, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=world)
    try:
        for fn, kw in jobs:
            globals()[fn](**kw)
    finally:
        dist.destroy_process_group()


def spawn(world, jobs, tmp):
    """Run ``jobs`` ([(job name, kwargs)]) in ``world`` spawned ranks."""
    rdv = tempfile.mktemp(prefix="rdv-", dir=tmp)
    mp.start_processes(_rank_main, args=(world, rdv, jobs), nprocs=world,
                       start_method="spawn")


def rank_results(out, world):
    res = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(world)]
    return res


def assert_same_run(got_out, want_out, got_tr, want_tr, rtol=RTOL,
                    atol=ATOL):
    """Logs (losses, grad norms, task losses) and factors within
    tolerance."""
    g, w = logs(got_out), logs(want_out)
    assert [e["step"] for e in g] == [e["step"] for e in w]
    for eg, ew in zip(g, w):
        assert eg.keys() == ew.keys()
        for k in ew:
            if k != "elapsed_sec":
                np.testing.assert_allclose(eg[k], ew[k], rtol=rtol,
                                           atol=atol, err_msg=k)
    for p, t in want_tr.items():
        np.testing.assert_allclose(got_tr[p].numpy(), np.asarray(t),
                                   rtol=rtol, atol=atol, err_msg=p)


def jax_trainable(out, params, lora, batches, data, model, fsdp=False,
                  **kw):
    """The JAX package's Trainer on a (data, model) mesh of its CPU
    devices; returns its factors as numpy."""
    import jax
    import jax.numpy as jnp

    from scaling_retriever_tpu.models import encoder as ref_encoder
    from scaling_retriever_tpu.models.lora import LoraConfig as RefLora
    from scaling_retriever_tpu.parallel.mesh import make_mesh as ref_mesh
    from scaling_retriever_tpu.training import trainer as ref_trainer

    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    enc = ref_encoder.LlamaBiSparse(as_j(params), jax_config(), as_j(lora),
                                    RefLora(**LORA, lora_dropout=0.0))
    tr = ref_trainer.Trainer(
        enc, ref_trainer.LLM2RetrieverTrainingArgs(
            **{**ARGS, **kw}, output_dir=out, lora_dropout=0.0, fsdp=fsdp),
        ListLoader(batches),
        mesh=ref_mesh(data, model, devices=jax.devices()[:data * model]))
    tr.train()
    return dict(tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                   tr.trainable)))


# ---- world 2 -----------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of 2 ranks running every world-2 job; returns the output
    directories and the inputs."""
    tmp = str(tmp_path_factory.mktemp("world2"))
    params, lora = start_numbers()
    batches = nce_batches(6)
    mbatches = mntp_batches(2)
    dirs = {k: os.path.join(tmp, k) for k in
            ("dp0", "dp1", "odd", "mntp", "resume", "shard", "t5",
             "t5_fsdp")}
    for d in dirs.values():
        os.makedirs(d)
    common = dict(params=params, lora=lora, data=2, model=1)
    jobs = [("job_train", dict(out=dirs["dp0"], kind="LlamaBiSparse",
                               batches=batches, lora_dropout=0.0, **common)),
            ("job_train", dict(out=dirs["dp1"], kind="LlamaBiSparse",
                               batches=batches, lora_dropout=0.1, **common)),
            ("job_train", dict(out=dirs["odd"], kind="LlamaBiSparse",
                               batches=nce_batches(6, seed=5, bz=3),
                               lora_dropout=0.1, **common)),
            ("job_train", dict(out=dirs["mntp"], kind="mntp",
                               batches=mbatches, lora_dropout=0.1,
                               max_steps=1, gradient_accumulation_steps=1,
                               warmup_steps=0,
                               task_names=("rank",), task_weights=(1.0,),
                               **common)),
            ("job_resume", dict(out=dirs["resume"], kind="LlamaBiSparse",
                                batches=nce_batches(5, seed=7),
                                lora_dropout=0.1, gradient_accumulation_steps=1,
                                **common)),
            ("job_shard_batch", dict(out=dirs["shard"], data=2, model=1)),
            ("job_train", dict(out=dirs["t5"], kind="t5", params=None,
                               lora=True, batches=batches, data=2, model=1,
                               lora_dropout=0.0)),
            ("job_train", dict(out=dirs["t5_fsdp"], kind="t5", params=None,
                               lora=True, batches=batches, data=2, model=1,
                               fsdp=True, lora_dropout=0.0))]
    spawn(2, jobs, tmp)
    return dict(dirs=dirs, params=params, lora=lora, batches=batches,
                mbatches=mbatches, tmp=tmp)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_data_parallel_matches_one_process(world2, dropout, tmp_path):
    w = world2
    out = w["dirs"]["dp0" if dropout == 0.0 else "dp1"]
    one = train(str(tmp_path), "LlamaBiSparse", w["params"], w["lora"],
                w["batches"], lora_dropout=dropout)
    ranks = rank_results(out, 2)
    for r in ranks[1:]:      # every rank holds the same factors
        for p, t in r["trainable"].items():
            assert torch.equal(t, ranks[0]["trainable"][p]), p
    assert ranks[0]["dtensors"] == [] and ranks[0]["mismatches"] == []
    assert_same_run(out, str(tmp_path), ranks[0]["trainable"],
                    trainable_of(one))
    # clipping engaged and the factors moved
    assert all(e["grad_norm"] > 0.05 for e in logs(out))


def test_rows_data_does_not_divide_are_encoded_whole(world2, tmp_path):
    """3 queries a batch: 2 ranks encode all of them (no gather) and
    split the 6 contexts; the step is still the global batch's."""
    w = world2
    one = train(str(tmp_path), "LlamaBiSparse", w["params"], w["lora"],
                nce_batches(6, seed=5, bz=3), lora_dropout=0.1)
    got = rank_results(w["dirs"]["odd"], 2)[0]["trainable"]
    assert_same_run(w["dirs"]["odd"], str(tmp_path), got, trainable_of(one))


def test_data_parallel_matches_jax_trainer(world2, tmp_path):
    w = world2
    want = jax_trainable(str(tmp_path), w["params"], w["lora"],
                         w["batches"], 2, 1)
    got = rank_results(w["dirs"]["dp0"], 2)[0]["trainable"]
    want_logs, got_logs = logs(str(tmp_path)), logs(w["dirs"]["dp0"])
    for eg, ew in zip(got_logs, want_logs):
        for k in ew:
            if k != "elapsed_sec":
                np.testing.assert_allclose(eg[k], ew[k], rtol=JAX_RTOL,
                                           atol=JAX_ATOL, err_msg=k)
    for p, t in want.items():
        np.testing.assert_allclose(got[p].numpy(), t, rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=p)


def test_mntp_unequal_token_counts_matches_one_process(world2, tmp_path):
    """Rank 0's rows hold 5x rank 1's masked tokens: the loss is the mean
    over the global batch's tokens, not a mean of the ranks' means."""
    w = world2
    b = w["mbatches"][0]["labels"]
    assert (b[:4] != -100).sum() == 5 * (b[4:] != -100).sum()
    one = train(str(tmp_path), "mntp", w["params"], w["lora"],
                w["mbatches"], lora_dropout=0.1, max_steps=1,
                gradient_accumulation_steps=1, warmup_steps=0,
                task_names=("rank",),
                task_weights=(1.0,))
    ranks = rank_results(w["dirs"]["mntp"], 2)
    assert_same_run(w["dirs"]["mntp"], str(tmp_path),
                    ranks[0]["trainable"], trainable_of(one))
    start = dict(tree_leaves(w["lora"]))
    assert max(float((t - torch.tensor(start[p])).abs().max())
               for p, t in ranks[0]["trainable"].items()) > 1e-4


def test_shard_batch_takes_each_ranks_rows(world2):
    """Leading dims that data divides are split in rank order; the rest,
    scalars and lists stay whole."""
    got = rank_results(world2["dirs"]["shard"], 2)
    x = np.arange(24).reshape(8, 3)
    for r, g in enumerate(got):
        assert g["x"] == x[4 * r:4 * (r + 1)].tolist()
        assert g["odd"] == list(range(5)) and g["ids"] == ["a", "b"]
        assert g["s"] == 2.0


@pytest.mark.parametrize("name", ["t5", "t5_fsdp"])
def test_t5_over_ranks_matches_one_process(world2, name, tmp_path):
    """T5Sparse over 2 ranks, replicated and under FSDP (its shared
    embedding and feed-forward weights sharded over data), against one
    process."""
    w = world2
    one = train(str(tmp_path), "t5", None, True, w["batches"],
                lora_dropout=0.0)
    ranks = rank_results(w["dirs"][name], 2)
    assert ranks[0]["mismatches"] == []
    assert ("shared.weight" in ranks[0]["dtensors"]) == (name == "t5_fsdp")
    assert_same_run(w["dirs"][name], str(tmp_path), ranks[0]["trainable"],
                    trainable_of(one))


def test_adapter_from_two_ranks_bit_equal(world2, tmp_path):
    """Rank 0 alone writes the adapter, from the full factors: its files
    are bit-equal to one process's writing of the same factors."""
    w = world2
    adapter = os.path.join(w["dirs"]["dp1"], "adapter")
    factors = rank_results(w["dirs"]["dp1"], 2)[0]["trainable"]
    nested = {}
    for path, t in factors.items():
        node = nested
        *head, leaf = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t
    save_adapter(nested, LoraConfig(**LORA, lora_dropout=0.1), str(tmp_path))
    assert sorted(os.listdir(adapter)) == sorted(os.listdir(tmp_path))
    for name in os.listdir(adapter):
        with open(os.path.join(adapter, name), "rb") as a, \
                open(os.path.join(tmp_path, name), "rb") as b:
            assert a.read() == b.read(), name


def test_resume_at_world_two_bit_equal(world2):
    ranks = rank_results(world2["dirs"]["resume"], 2)
    for r in ranks:
        assert r["steps"] == (4, 4)
        for p, t in r["straight"].items():
            assert torch.equal(t, r["resumed"][p]), p
    d = world2["dirs"]["resume"]
    straight = {e["step"]: e["loss"] for e in logs(os.path.join(d,
                                                                "straight"))}
    cut = {e["step"]: e["loss"] for e in logs(os.path.join(d, "cut"))}
    assert all(cut[s] == straight[s] for s in (1, 2, 3, 4))
    # rank 0 alone wrote (and pruned) the checkpoints
    assert sorted(x for x in os.listdir(os.path.join(d, "cut"))
                  if x.startswith("checkpoint-")) == ["checkpoint-4"]
