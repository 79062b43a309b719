"""LoRA sparse NCE training steps through the port's ``Trainer``: one
``Trainer`` over the configuration's encoder (``LoraConfig`` r, alpha and
dropout from the mix, full remat), the rank task plus the FLOPS
regularizers on their quadratic ramp over a third of ``max_steps``, AdamW with clipping, driven by
``Trainer._train_step`` on a fresh micro batch from the seed at every
step, as the port's training driver steps it.

Set-up builds the trainer and takes its first ``check_steps`` steps
through the same call and feed as the window; what those steps did (the
losses, the first gradient as the optimizer holds it, the factors'
change) is what the reference follows. The window steps until its time
is up; ``train_tokens_per_s`` is the tokens of all its micro steps over
the time until the last one's loss was read back.
"""

from __future__ import annotations

import gc
import os
import time


from retrieval_bench import check, gen
from retrieval_bench.reference.training import leaves_of

# what the configuration's architecture module has to define for this kind
ARCH = ("build_encoder", "train_flops", "lora_factors", "train_steps")


def hyper(tr: dict) -> dict:
    return {"lr": tr["learning_rate"], "max_steps": tr["max_steps"],
            "beta1": 0.9, "beta2": 0.999, "eps": 1e-8, "weight_decay": 0.0,
            "max_grad_norm": 1.0, "scale": tr["lora_alpha"] / tr["lora_r"],
            "query_reg": tr["query_reg"], "doc_reg": tr["doc_reg"],
            "reg_T": max(1, tr["max_steps"] // 3)}


def run(ctx) -> dict:
    from scaling_retriever_tpu_torch.models.lora import LoraConfig
    from scaling_retriever_tpu_torch.training.trainer import (
        LLM2RetrieverTrainingArgs, Trainer)

    conf, tr, dev, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    m, arch = conf["model"], ctx.arch
    ctx.stage("imports")
    enc = arch.build_encoder(conf, seed, dev, remat=True)
    ctx.stage("weights")
    lora = arch.lora_factors(m, tr["lora_r"], seed, dev)
    start = {k: v.clone() for k, v in leaves_of(lora).items()}
    enc.lora = lora
    enc.lora_config = LoraConfig(r=tr["lora_r"], lora_alpha=tr["lora_alpha"],
                                 lora_dropout=tr["lora_dropout"])
    args = LLM2RetrieverTrainingArgs(
        output_dir=os.path.join(ctx.scratch, "train_out"),
        max_steps=tr["max_steps"], logging_steps=10 ** 9,
        lora=True, lora_r=tr["lora_r"], lora_alpha=tr["lora_alpha"],
        lora_dropout=tr["lora_dropout"],
        task_names=("rank", "query_reg", "doc_reg"),
        task_weights=(1.0, tr["query_reg"], tr["doc_reg"]),
        learning_rate=tr["learning_rate"], bf16=True)
    trainer = Trainer(enc, args, train_loader=[])

    def batch(i):
        return gen.train_batch(m["vocab_size"], seed, i, tr["bz"],
                               tr["n_negs"], tr["q_len"], tr["d_len"], dev)

    def step(i) -> dict:
        trainer.micro_step += 1
        out = trainer._train_step(batch(i), trainer.micro_step)
        trainer.step += 1
        return out

    n_check = tr["check_steps"]
    losses = [step(1)["loss"]]
    # AdamW's first moment after one update is (1 - beta1) * grad; a leaf
    # the optimizer never got holds no state, and reads a gradient of 0
    g1 = {p: float((trainer.optimizer.state[t]["exp_avg"]
                    / (1.0 - 0.9)).norm())
          if "exp_avg" in trainer.optimizer.state.get(t, {}) else 0.0
          for p, t in zip(trainer._paths, trainer._leaves)}
    for i in range(2, n_check + 1):
        losses.append(step(i)["loss"])
    change = {p: float((t.detach() - start[p]).norm())
              for p, t in zip(trainer._paths, trainer._leaves)}
    for i in range(n_check + 1, n_check + 1 + tr["warm_steps"]):
        step(i)
    ctx.stage(f"{n_check + tr['warm_steps']} steps")

    groups = [(tr["bz"], tr["q_len"]),
              (tr["bz"] * (1 + tr["n_negs"]), tr["d_len"])]
    tokens = sum(r * s for r, s in groups)
    gc.collect()
    gc.freeze()
    ctx.sync()
    i = n_check + tr["warm_steps"]
    with ctx.window() as w:
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        done = 0
        while time.perf_counter() < t_end:
            i += 1
            step(i)
            done += 1
        elapsed = time.perf_counter() - t0
    gc.unfreeze()
    peak = ctx.memory_peak()
    record = {"window_s": w.seconds, "trace": w.summary, "model": m,
              "flops": arch.train_flops(m, groups, remat=True) * done}
    del trainer, enc, lora
    ctx.free()

    batches = [batch(s) for s in range(1, n_check + 1)]
    ref = arch.train_steps(m, seed, arch.lora_factors(
        m, tr["lora_r"], seed, dev), batches, hyper(tr), dev)
    numbers = check.train_numbers(losses, g1, change, ref)
    control = None
    if ctx.control:
        for name, kw in (("fp8", {"precision": "fp8"}),
                         ("half_batch", {"half": True})):
            low = arch.train_steps(m, seed, arch.lora_factors(
                m, tr["lora_r"], seed, dev), batches, hyper(tr), dev, **kw)
            control = dict(control or {}, **{
                f"{name}.{k}": v for k, v in check.train_numbers(
                    low["loss"], low["grad_norms"][0], low["change_norms"],
                    ref).items()})
    ctx.log(f"losses {losses} (reference {ref['loss']}); {done} steps in "
            f"the window")
    return {"attempted": done, "failed": 0,
            "e2e": {"train_tokens_per_s": done * tokens / elapsed},
            "memory_peak_bytes": peak, "record": record,
            "numbers": numbers, "control": control, "window_start": t0}
