"""The port's training path against the JAX package's: ``loss_forward``
(every loss, sparse and dense) and its LoRA gradients, then three
optimizer steps of each package's Trainer on the same batches, with
warmup, weight decay, clipping that engages and gradient accumulation.
Both start from the same base weights and LoRA factors (carried by
``params_from_jax`` and ``lora_from_jax``, B randomized so the branch is
live), dropout 0, float32 on the CPU.

Tolerances: losses and gradients rtol 1e-4, atol 1e-6 (the frameworks sum
the matmuls in different orders, ~1e-6 relative, and the softmaxes and
the pooling max amplify it), a gradient's atol raised to 1e-5 of its
leaf's largest entry (its rounding scales with its largest terms: the
dense head's 1/T of 20 makes them large); the factors after three Adam updates rtol
1e-4, atol 1e-6 (an update moves a factor by at most the learning rate,
so a gradient difference of 1e-5 relative moves it by far less).

Then the JAX package's own trainer assertions on the port's trainer: the
loss falls, the ramp is quadratic per micro step, optimizer steps count
as HF counts them under accumulation, epoch mode, resume mid-epoch with
identical batches, auto resume, ``save_total_limit``, dropout in training
only, remat policies with gradients equal to no remat, ``--no_lora``."""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaling_retriever_tpu.models import encoder as ref_encoder
from scaling_retriever_tpu.models import llama as ref_llama
from scaling_retriever_tpu.models.lora import LoraConfig as RefLoraConfig
from scaling_retriever_tpu.models.lora import init_lora_params
from scaling_retriever_tpu.models.losses import RegWeightScheduler
from scaling_retriever_tpu.training import trainer as ref_trainer
from scaling_retriever_tpu_torch.models import encoder
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.lora import LoraConfig
from scaling_retriever_tpu_torch.models.weights import (lora_from_jax,
                                                        params_from_jax)
from scaling_retriever_tpu_torch.parallel.mesh import make_mesh, shard_batch
from scaling_retriever_tpu_torch.training import trainer as port_trainer
from scaling_retriever_tpu_torch.training.trainer import (
    LLM2RetrieverTrainingArgs, Trainer, tree_leaves)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
BZ, NNEG, SEQ = 4, 2, 8
LOSS_CLASSES = {"nce": "", "margin_mse": "ForMarginMSE", "kldiv": "ForKLDiv",
                "nce_kldiv": "ForNCE_KLDiv"}


def _port_config(ref_cfg, **kw) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    base = {f.name: getattr(ref_cfg, f.name)
            for f in dataclasses.fields(ref_cfg)
            if f.name in fields and f.name not in ("dtype", "param_dtype")}
    return ModelConfig(**{**base, **kw})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def start(tiny_config):
    """(JAX config, params, live LoRA factors) as numpy trees."""
    params = ref_llama.init_params(tiny_config, jax.random.PRNGKey(1))
    lora = init_lora_params(tiny_config, RefLoraConfig(r=4, lora_alpha=8),
                            jax.random.PRNGKey(2))
    lora = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                               x.shape), lora)
    return tiny_config, _np(params), _np(lora)


def _pair(start, pooling, loss, dropout=0.0, remat=False):
    """(JAX encoder, port encoder) of one class from the same numbers."""
    cfg, params, lora = start
    name = ("LlamaBiSparse" if pooling == "sparse" else "LlamaBiDense") \
        + LOSS_CLASSES[loss]
    lc = dict(r=4, lora_alpha=8, lora_dropout=dropout)
    T = 0.05 if pooling == "dense" else 1.0
    ref = getattr(ref_encoder, name)(
        jax.tree_util.tree_map(jnp.asarray, params), cfg,
        jax.tree_util.tree_map(jnp.asarray, lora), RefLoraConfig(**lc), T=T)
    pcfg = _port_config(cfg, remat=remat)
    port = getattr(encoder, name)(
        params_from_jax(params, pcfg, "cpu"), pcfg,
        lora_from_jax(lora, "cpu", trainable=True), LoraConfig(**lc), T=T)
    return ref, port


def _batch(loss, seed=0, vocab=250):
    """One collated batch of ``loss``'s layout, left-padded rows."""
    rng = np.random.default_rng(seed)

    def tok(n):
        ids = rng.integers(4, vocab, (n, SEQ)).astype(np.int32)
        mask = np.ones((n, SEQ), np.int32)
        for i in range(n):
            mask[i, :int(rng.integers(0, 3))] = 0
        return {"input_ids": ids * mask, "attention_mask": mask}

    if loss == "margin_mse":
        return {"tokenized_query": tok(BZ), "pos_tokenized_doc": tok(BZ),
                "neg_tokenized_doc": tok(BZ),
                "teacher_pos_scores": rng.standard_normal(BZ).astype(
                    np.float32),
                "teacher_neg_scores": rng.standard_normal(BZ).astype(
                    np.float32)}
    b = {"tokenized_queries": tok(BZ),
         "tokenized_contexts": tok(BZ * (1 + NNEG)),
         "target_labels": np.arange(BZ, dtype=np.int32),
         "teacher_scores": rng.standard_normal((BZ, 1 + NNEG)).astype(
             np.float32),
         "teacher_idxes": np.asarray(
             [[i] + list(range(BZ + i * NNEG, BZ + (i + 1) * NNEG))
              for i in range(BZ)], np.int32)}
    return b


def _jax_batch(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


@pytest.mark.parametrize("loss", list(LOSS_CLASSES))
@pytest.mark.parametrize("pooling", ["sparse", "dense"])
def test_loss_forward_and_lora_grads_match_reference(start, pooling, loss):
    ref, port = _pair(start, pooling, loss)
    b = _batch(loss)

    def total(lora, batch):
        out = ref.loss_forward(ref.params, lora, batch)
        return sum(out.values()), out

    (_, want), want_g = jax.jit(jax.value_and_grad(total, has_aux=True))(
        ref.lora, _jax_batch(b))
    got = port.loss_forward(port.params, port.lora, b)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    leaves = tree_leaves(port.lora)
    grads = torch.autograd.grad(sum(got.values()), [t for _, t in leaves])
    want_leaves = dict(tree_leaves(_np(want_g)))
    for (path, _), g in zip(leaves, grads):
        w = want_leaves[path]
        # a gradient's rounding scales with its largest terms
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=max(ATOL, 1e-5 * np.abs(w).max()),
                                   err_msg=path)


class ListLoader(list):
    def set_epoch(self, e):
        pass


def _trainer_args(out, **kw):
    base = dict(output_dir=str(out), max_steps=3, logging_steps=1,
                learning_rate=3e-3, warmup_steps=1, weight_decay=0.01,
                max_grad_norm=0.05, gradient_accumulation_steps=2,
                lora_dropout=0.0, reg_T=4, lora_r=4, lora_alpha=8,
                task_names=("rank", "query_reg", "doc_reg"),
                task_weights=(1.0, 0.5, 0.4))
    base.update(kw)
    return base


def _logs(out):
    with open(os.path.join(str(out), "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def reference_run(start, tmp_path_factory):
    """Three optimizer steps of the JAX package's Trainer (gas 2), shared
    by the assertions that read it."""
    out = tmp_path_factory.mktemp("ref_run")
    ref, _ = _pair(start, "sparse", "nce")
    batches = [_batch("nce", seed=s) for s in range(6)]
    tr = ref_trainer.Trainer(
        ref, ref_trainer.LLM2RetrieverTrainingArgs(**_trainer_args(out)),
        ListLoader(batches))
    tr.train()
    return _logs(out), _np(tr.trainable), batches


def test_three_steps_match_reference_trainer(start, reference_run, tmp_path):
    want_logs, want_lora, batches = reference_run
    _, port = _pair(start, "sparse", "nce")
    tr = Trainer(port, LLM2RetrieverTrainingArgs(**_trainer_args(tmp_path)),
                 ListLoader(batches))
    tr.train()
    logs = _logs(tmp_path)
    assert [e["step"] for e in logs] == [e["step"] for e in want_logs] \
        == [1, 2, 3]
    for got, want in zip(logs, want_logs):
        assert got.keys() == want.keys()
        for k in want:
            if k != "elapsed_sec":
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
    # clipping engaged: every micro gradient's norm is over max_grad_norm
    assert all(e["grad_norm"] > 0.05 for e in logs)
    want_leaves = dict(tree_leaves(want_lora))
    for path, t in tree_leaves(tr.trainable):
        np.testing.assert_allclose(t.detach().numpy(), want_leaves[path],
                                   rtol=RTOL, atol=ATOL, err_msg=path)
    # the factors moved: warmup 1 makes the first update's rate 0, the
    # next two move them
    start_leaves = dict(tree_leaves(start[2]))
    assert max(np.abs(t.detach().numpy() - start_leaves[p]).max()
               for p, t in tree_leaves(tr.trainable)) > 1e-4


def test_optimizer_arithmetic_matches_optax():
    """Clipping (at and under the limit), AdamW's decoupled decay, bias
    correction and eps, and the schedule at the update's count, against
    optax's chain over four updates."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in p0.items()} for s in (3.0, 0.01, 2.0, 0.05)]
    lr, wd, max_norm = 0.01, 0.1, 1.0
    sched = ref_trainer.linear_warmup_decay(lr, 2, 6)
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(sched, weight_decay=wd))
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               params)
        params = optax.apply_updates(params, upd)

    leaves = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    args = LLM2RetrieverTrainingArgs(
        output_dir="unused", learning_rate=lr, weight_decay=wd,
        max_grad_norm=max_norm, warmup_steps=2, max_steps=6)
    tr = Trainer(types.SimpleNamespace(lora=leaves, params=None), args, [],
                 mesh=make_mesh(device="cpu"))
    for g in grads:
        tr._apply([torch.from_numpy(g[k]) for k in sorted(g)])
        tr.step += 1
    for k in p0:
        np.testing.assert_allclose(leaves[k].detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-5,
                                   atol=1e-7)
    for count in range(9):
        assert tr.schedule(count) == float(sched(count))


# ---- the JAX package's trainer assertions on the port's trainer --------

def _fake_batches(n_batches, bz=2, n_ctx_per_q=2, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "tokenized_queries": {
            "input_ids": rng.integers(4, 250, (bz, seq)).astype(np.int32),
            "attention_mask": np.ones((bz, seq), np.int32)},
        "tokenized_contexts": {
            "input_ids": rng.integers(4, 250, (bz * n_ctx_per_q, seq)
                                      ).astype(np.int32),
            "attention_mask": np.ones((bz * n_ctx_per_q, seq), np.int32)},
        "target_labels": np.arange(bz, dtype=np.int32)}
        for _ in range(n_batches)]


def _args(out, **kw):
    base = dict(output_dir=str(out), max_steps=8, logging_steps=4,
                learning_rate=5e-3, lora=True, lora_r=4, lora_alpha=8,
                task_names=("rank", "query_reg", "doc_reg"),
                task_weights=(1.0, 0.01, 0.008))
    base.update(kw)
    return LLM2RetrieverTrainingArgs(**base)


def _fresh(start, dropout=0.0, remat=False):
    return _pair(start, "sparse", "nce", dropout, remat)[1]


def test_nce_loss_decreases(start, tmp_path):
    tr = Trainer(_fresh(start), _args(tmp_path, max_steps=20,
                                      logging_steps=5),
                 ListLoader(_fake_batches(1, 4) * 25))
    tr.train()
    logs = _logs(tmp_path)
    assert logs[-1]["rank"] < logs[0]["rank"] * 0.9
    assert logs[-1]["step"] == 20


def test_grad_accum_semantics(start, tmp_path):
    """max_steps counts optimizer steps; the ramp advances once per micro
    step, as the reference's stateful scheduler does."""
    gas, max_steps, reg_T = 4, 3, 6
    args = _args(tmp_path, max_steps=max_steps, logging_steps=1,
                 gradient_accumulation_steps=gas, reg_T=reg_T,
                 learning_rate=0.0, lora_dropout=0.0)
    enc = _fresh(start)
    batch = _fake_batches(1)
    raw = float(enc.loss_forward(enc.params, enc.lora, batch[0])[
        "query_reg"].detach())
    tr = Trainer(enc, args, ListLoader(batch * 20))
    tr.train()
    assert tr.step == max_steps and tr.micro_step == gas * max_steps
    logs = _logs(tmp_path)
    assert [e["step"] for e in logs] == [1, 2, 3]
    sched = RegWeightScheduler(args.ln_to_weight["query_reg"], reg_T)
    lambdas = [sched.step() for _ in range(gas * max_steps)]
    for i, e in enumerate(logs):
        np.testing.assert_allclose(
            e["query_reg"], raw * np.mean(lambdas[i * gas:(i + 1) * gas]),
            rtol=1e-4)
    # quadratic: micro step 4's weight is 4x micro step 2's
    assert lambdas[3] == pytest.approx(4 * lambdas[1])


def test_epochs_mode(start, tmp_path):
    tr = Trainer(_fresh(start), _args(tmp_path, max_steps=0,
                                      num_train_epochs=2, logging_steps=1),
                 ListLoader(_fake_batches(3)))
    tr.train()
    assert tr.step == 6 and tr.epoch == 2


class ShufflingLoader:
    def __init__(self, batches):
        self.batches = batches
        self.epoch = 0

    def set_epoch(self, e):
        self.epoch = e

    def __iter__(self):
        idx = np.random.default_rng(self.epoch).permutation(len(self.batches))
        return iter([self.batches[i] for i in idx])


def test_resume_mid_epoch_identical_batches(start, tmp_path):
    """Resume replays the batches an uninterrupted run takes; the resumed
    trainable equals the uninterrupted one bit for bit (dropout on: its
    seed is fold_in(seed, micro step))."""
    batches = _fake_batches(5)

    def run(out, stop_after=None, resume=None):
        args = _args(out, max_steps=8, logging_steps=1, save_steps=4,
                     learning_rate=1e-3, lora_dropout=0.1, reg_T=3,
                     resume_from_checkpoint=resume)
        tr = Trainer(_fresh(start, dropout=0.1), args,
                     ShufflingLoader(batches))
        if stop_after is not None:
            tr.args = dataclasses.replace(args, max_steps=stop_after)
        tr.train()
        return tr, _logs(out)

    tr_a, logs_a = run(tmp_path / "straight")
    run(tmp_path / "interrupted", stop_after=4)
    ckpt = os.path.join(str(tmp_path / "interrupted"), "checkpoint-4")
    assert os.path.exists(os.path.join(ckpt, port_trainer.STATE_FILE))
    tr_c, logs_c = run(tmp_path / "interrupted", resume=ckpt)
    assert tr_c.step == 8 and tr_c.epoch == 1
    a = {e["step"]: e["loss"] for e in logs_a}
    c = {e["step"]: e["loss"] for e in logs_c}
    for s in (5, 6, 7, 8):
        assert c[s] == a[s]
    for (pa, ta), (pc, tc) in zip(tree_leaves(tr_a.trainable),
                                  tree_leaves(tr_c.trainable)):
        assert pa == pc and torch.equal(ta, tc)


def test_auto_resume_and_save_total_limit(start, tmp_path):
    batches = ListLoader(_fake_batches(1) * 10)
    tr = Trainer(_fresh(start), _args(tmp_path, max_steps=6, save_steps=2,
                                      logging_steps=1), batches)
    tr.args = _args(tmp_path, max_steps=3, save_steps=2, logging_steps=1)
    tr.train()
    assert tr.step == 3
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("checkpoint-")) == ["checkpoint-2"]
    tr2 = Trainer(_fresh(start), _args(
        tmp_path, max_steps=6, save_steps=2, logging_steps=1,
        save_total_limit=2, resume_from_checkpoint="auto"), batches)
    tr2.train()
    assert tr2.step == 6
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("checkpoint-")) == ["checkpoint-4",
                                                      "checkpoint-6"]
    assert port_trainer.get_last_checkpoint(str(tmp_path)).endswith(
        "checkpoint-6")


def test_lora_dropout_stochastic_in_training(start):
    """With dropout the loss depends on the seed; ``encode`` and a
    seedless loss_forward stay deterministic."""
    enc = _fresh(start, dropout=0.3)
    b = _fake_batches(1)[0]
    losses = [float(enc.loss_forward(enc.params, enc.lora, b, s)[
        "rank"].detach()) for s in (0, 1, None, None, 0)]
    assert losses[0] != losses[1] and losses[2] == losses[3]
    assert losses[4] == losses[0]
    ids = b["tokenized_queries"]["input_ids"]
    mask = b["tokenized_queries"]["attention_mask"]
    assert torch.equal(enc.encode(ids, mask), enc.encode(ids, mask))


@pytest.mark.parametrize("remat", [True, "dots_saveable",
                                   "dots_with_no_batch_dims_saveable",
                                   "names:attn_q,attn_k,attn_v,attn_out",
                                   "names:attn_q,attn_k,attn_v,attn_out,"
                                   "mlp_mid"])
def test_remat_gradients_equal_no_remat(start, remat):
    """Each remat policy recomputes the same masks and values: gradients
    bit-equal to no remat's, with dropout on."""
    b = _fake_batches(1)[0]

    def grads(r):
        enc = _fresh(start, dropout=0.2, remat=r)
        out = enc.loss_forward(enc.params, enc.lora, b, 11)
        leaves = [t for _, t in tree_leaves(enc.lora)]
        return torch.autograd.grad(sum(out.values()), leaves)

    for g, w in zip(grads(remat), grads(False)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("remat", ["names:attn_q", "dots", "selective"])
def test_unported_remat_policies_raise(start, remat):
    enc = _fresh(start, remat=remat)
    with pytest.raises(NotImplementedError, match="remat"):
        enc.loss_forward(enc.params, enc.lora, _fake_batches(1)[0])


def test_no_lora_trains_the_whole_model(start, tmp_path):
    cfg, params, _ = start
    pcfg = _port_config(cfg)
    enc = encoder.LlamaBiSparse(params_from_jax(params, pcfg, "cpu"), pcfg)
    before = enc.params.layers[0].wq.weight.clone()
    tr = Trainer(enc, _args(tmp_path, max_steps=2, logging_steps=1,
                            lora=False), ListLoader(_fake_batches(1) * 3))
    assert not tr.use_lora and tr.params is None
    assert all(p.requires_grad for p in enc.params.parameters())
    tr.train()
    assert not torch.equal(enc.params.layers[0].wq.weight, before)
    tr.save_model(str(tmp_path / "full"))
    assert os.path.exists(tmp_path / "full" / "model.safetensors")


@pytest.mark.parametrize("fsdp", [False, True])
def test_fsdp_matches_replicated(start, tmp_path, fsdp):
    """The JAX package's Trainer over its 8-device mesh against the port's
    over ``["cpu"] * 8``, a (data 4, model 2) mesh and one entry, on the
    same global batches of 8 queries: the placements' specs equal the
    reference's; the port's losses bit-equal across its meshes (one global
    step on one device) and within rtol 1e-4, atol 1e-6 of the
    reference's."""
    from scaling_retriever_tpu.parallel.mesh import make_mesh as ref_mesh
    from scaling_retriever_tpu_torch.parallel import partitioning

    batches = _fake_batches(3, 8, 2, 8)
    kw = dict(max_steps=3, logging_steps=1, fsdp=fsdp, learning_rate=1e-3)
    ref, _ = _pair(start, "sparse", "nce")
    rtr = ref_trainer.Trainer(
        ref, ref_trainer.LLM2RetrieverTrainingArgs(
            **vars(_args(tmp_path / "ref", **kw))),
        ListLoader(batches), mesh=ref_mesh(model=1))
    rtr.train()
    want = [e["loss"] for e in _logs(tmp_path / "ref")]
    losses = {}
    for name, (data, model, n) in {"8": (8, 1, 8), "4x2": (4, 2, 8),
                                   "1": (1, 1, 1)}.items():
        tr = Trainer(_fresh(start), _args(tmp_path / name, **kw),
                     ListLoader(batches),
                     mesh=make_mesh(data, model, devices=["cpu"] * n))
        if name == "8":
            got_specs = {p: sh.spec for p, sh in
                         partitioning._flatten(tr.param_shardings)}
            want_specs = {tuple(k.key for k in kp): tuple(sh.spec)
                          for kp, sh in jax.tree_util.tree_flatten_with_path(
                              rtr.param_shardings)[0]}
            assert got_specs == want_specs
        tr.train()
        losses[name] = [e["loss"] for e in _logs(tmp_path / name)]
    assert losses["8"] == losses["4x2"] == losses["1"]
    np.testing.assert_allclose(losses["8"], want, rtol=RTOL, atol=ATOL)


def test_mesh_is_one_card(start, tmp_path):
    """A mesh's step runs on its first entry; a mesh of repeated entries
    trains there; one process over several distinct cards raises, naming
    the torchrun launch that trains over them (tests/
    test_torch_distributed.py drives that path)."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    b = shard_batch({"x": np.arange(3), "ids": ["a"]}, mesh)
    assert isinstance(b["x"], torch.Tensor) and b["ids"] == ["a"]
    two = make_mesh(devices=["cpu", "cpu"])
    assert two.shape == {"data": 2, "model": 1} and not two.distinct
    with pytest.raises(NotImplementedError, match="torchrun"):
        Trainer(_fresh(start), _args(tmp_path), ListLoader([]),
                mesh=make_mesh(devices=["cuda:0", "cuda:1"]))
