"""The sparse NCE training micro step on one card (the port's counterpart of
``bench_train.py``).

    python3 -m scaling_retriever_tpu_torch.benches.train [--model 1b|3b|8b]
        [--remat full] [--bz 8] [--breakdown] [--device cpu]

The reference's 1B recipe (LoRA r 16 contrastive training, per-device
batch 8 with 16 negatives, query length 64 and doc length 128, bf16) at
the published widths of Llama-3.2-1B, Llama-3.2-3B or Llama-3.1-8B
(``--model``) with random bf16 weights from ``--seed`` (the step's time
does not depend on them): ``LlamaBiSparse`` with LoRA r 16, alpha 32,
dropout 0, trained by the port's ``Trainer`` on the tasks rank, query_reg
and doc_reg at weights 1.0, 0.01 and 0.008. One micro step is the
forward over 8 queries and 136 contexts, the backward to the LoRA factors
and the AdamW update (``Trainer._train_step``). ``--remat`` picks the
layers' rematerialization (``full``, the default, keeps nothing inside a
layer). 5 warm steps, then 8 timed steps, each ending in a host read of
its loss.

The line carries ms per micro step, tokens/s, the model FLOPs of a step
(``common.model_flops``: projections, attention products and the LM head,
forward and backward to the activations, plus the layers' forward once
more under full remat) and ``mfu``, those FLOPs over the step time over
the card's dense bf16 peak, and the peak card memory. ``--breakdown``
also times the loss forward alone and the gradient alone
(``_combined_loss`` under ``no_grad``, then with autograd to the LoRA
factors; the optimizer's share is the step less the gradient). Check:
every loss finite, every LoRA factor moved, every frozen base weight
bit-unchanged. A setting that does not fit the card fails with its
error.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
from scaling_retriever_tpu_torch.models.lora import (LoraConfig,
                                                     init_lora_params)
from scaling_retriever_tpu_torch.models.weights import random_params
from scaling_retriever_tpu_torch.training.trainer import (
    REMAT, LLM2RetrieverTrainingArgs, Trainer,
)

N_NEGS, Q_LEN, D_LEN = 16, 64, 128
WARM = 5                # untimed steps
STEPS = 8               # timed steps

# the published config.json widths (bench_train.py's MODELS)
MODELS = {
    "1b": dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
               num_hidden_layers=16, num_attention_heads=32,
               num_key_value_heads=8, head_dim=64, tie_word_embeddings=True),
    "3b": dict(vocab_size=128256, hidden_size=3072, intermediate_size=8192,
               num_hidden_layers=28, num_attention_heads=24,
               num_key_value_heads=8, head_dim=128, tie_word_embeddings=True),
    "8b": dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=8, head_dim=128,
               tie_word_embeddings=False),
}
ROPE = dict(rope_theta=500000.0, max_position_embeddings=131072,
            rope_scaling={"rope_type": "llama3", "factor": 32.0,
                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 8192})


def parser(doc: str):
    ap = common.parser(doc)
    ap.add_argument("--model", default="1b", choices=sorted(MODELS))
    ap.add_argument("--remat", default="full", choices=sorted(REMAT))
    ap.add_argument("--bz", type=int, default=8,
                    help="queries a micro batch")
    ap.add_argument("--breakdown", action="store_true")
    return ap


def model_config(name: str, remat: str,
                 dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    return ModelConfig(dtype=dtype, param_dtype=dtype, remat=REMAT[remat],
                       **ROPE, **MODELS[name])


def lora_for(cfg: ModelConfig, dev, seed: int, **kw):
    """(factors, LoraConfig) at r 16, alpha 32, dropout 0, A drawn from
    ``seed``, B zero (peft's init)."""
    lc = LoraConfig(r=16, lora_alpha=32, lora_dropout=0.0, **kw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_lora_params(cfg, lc, gen, torch.float32, dev), lc


def training_args(out_dir: str, tasks, weights) -> LLM2RetrieverTrainingArgs:
    return LLM2RetrieverTrainingArgs(
        output_dir=out_dir, max_steps=STEPS, logging_steps=10 ** 9,
        lora=True, lora_r=16, lora_alpha=32, lora_dropout=0.0,
        task_names=tuple(tasks), task_weights=tuple(weights), bf16=True)


def make_batch(seed: int, vocab: int, bz: int) -> dict:
    """bench_train.py's batch: ids from ``default_rng(seed)`` in its order
    (queries, then contexts), full masks, labels 0..bz-1."""
    rng = np.random.default_rng(seed)
    n_ctx = bz * (1 + N_NEGS)
    q = rng.integers(4, vocab, (bz, Q_LEN)).astype(np.int32)
    c = rng.integers(4, vocab, (n_ctx, D_LEN)).astype(np.int32)
    return {"tokenized_queries": {"input_ids": q,
                                  "attention_mask": np.ones_like(q)},
            "tokenized_contexts": {"input_ids": c,
                                   "attention_mask": np.ones_like(c)},
            "target_labels": np.arange(bz, dtype=np.int32)}


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dev)


def timed_loop(fn, dev, n: int = STEPS) -> float:
    """WARM untimed calls, then seconds per call over ``n`` (each call ends
    in a host read)."""
    for _ in range(WARM):
        fn()
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def measure(trainer: Trainer, batch: dict, dev, flops: float, tokens: int,
            breakdown: bool, checks: common.Checks) -> dict:
    """The micro step's numbers (and the stages under ``breakdown``), then
    the checks on what the steps did to the weights."""
    base = [p.detach().to("cpu", copy=True)
            for p in trainer.encoder.params.parameters()]
    start = [t.detach().clone() for t in trainer._leaves]
    stages = {}
    if breakdown:
        def fwd():
            with torch.no_grad():
                return float(trainer._combined_loss(batch, 1)[0])

        def grad():
            loss, _ = trainer._combined_loss(batch, 1)
            g = torch.autograd.grad(loss, trainer._leaves)
            return float(g[-1].reshape(-1)[0])

        stages["fwd_ms"] = timed_loop(fwd, dev) * 1e3
        stages["grad_ms"] = timed_loop(grad, dev) * 1e3
        common.log(f"stages: forward {stages['fwd_ms']:.1f} ms, gradient "
                   f"{stages['grad_ms']:.1f} ms")
    losses = []

    def step():
        trainer.micro_step += 1
        metrics = trainer._train_step(batch, trainer.micro_step)
        trainer.step += 1
        losses.append(metrics["loss"])

    t0 = time.perf_counter()
    step()
    first_s = time.perf_counter() - t0
    dt = timed_loop(step, dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if breakdown:
        stages["step_ms"] = dt * 1e3
        stages["optimizer_ms"] = stages["step_ms"] - stages["grad_ms"]

    def finite():
        assert np.isfinite(losses).all(), f"losses {losses}"

    def moved():
        still = [path for path, a, b in zip(trainer._paths, start,
                                            trainer._leaves)
                 if torch.equal(a, b.detach())]
        assert not still, f"LoRA factors that did not move: {still}"

    def frozen():
        changed = [name for (name, p), b in zip(
            trainer.encoder.params.named_parameters(), base)
            if not torch.equal(p.detach().cpu(), b)]
        assert not changed, f"frozen weights that changed: {changed}"

    checks.run(f"all {len(losses)} losses finite", finite)
    checks.run("every LoRA factor moved", moved)
    checks.run("every frozen base weight bit-unchanged", frozen)
    ms = dt * 1e3
    out = {"ms": ms, "first_step_s": first_s, "tokens_per_s": tokens / dt,
           "flops_per_step": flops,
           "mfu": flops / dt / common.BF16_OPS_PER_S,
           "peak_gb": None if peak is None else peak / 1e9,
           "loss_first": losses[0], "loss_last": losses[-1]}
    if stages:
        out["stages"] = stages
    common.log(f"{ms:.1f} ms per micro step, {tokens / dt:.0f} tokens/s, "
               f"{flops / 1e12:.2f} TFLOP a step, mfu {out['mfu']:.4f} of "
               f"{common.BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, peak "
               f"{'not measured' if peak is None else f'{peak / 1e9:.2f} GB'}"
               f"; losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    return out


def emit(metric: str, unit: str, arm: str, out: dict, args, dev, card_s,
         before, checks) -> int:
    return common.emit({
        "metric": metric, "value": out["ms"], "unit": unit,
        "mfu": out["mfu"], "tokens_per_s": out["tokens_per_s"],
        "flops_per_step": out["flops_per_step"], "peak_gb": out["peak_gb"],
        **({"stages": out["stages"]} if "stages" in out else {}),
        "card": card_s, "device": str(dev), "arms": {arm: out},
        "launches": common.since(before),
        "kernels": "none: the step runs the encoder's PyTorch ops",
    }, checks, args.out)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}; "
               f"model {args.model}, remat {args.remat}, bz {args.bz}")
    before = common.launches()
    checks = common.Checks()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cfg = model_config(args.model, args.remat)
    t0 = time.perf_counter()
    params = random_params(cfg, args.seed, dev)
    lora, lc = lora_for(cfg, dev, args.seed + 1,
                        base_model_name_or_path=f"llama-{args.model}-random")
    common.sync(dev)
    n_params = sum(p.numel() for p in params.parameters())
    common.log(f"{n_params / 1e9:.2f}B parameters on the device in "
               f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="bench_train_") as tmp:
        trainer = Trainer(LlamaBiSparse(params, cfg, lora, lc),
                          training_args(tmp, ("rank", "query_reg",
                                              "doc_reg"),
                                        (1.0, 0.01, 0.008)),
                          train_loader=[])
        batch = to_device(make_batch(args.seed, cfg.vocab_size, args.bz),
                          dev)
        n_ctx = args.bz * (1 + N_NEGS)
        groups = [(args.bz, Q_LEN), (n_ctx, D_LEN)]
        out = measure(trainer, batch, dev,
                      common.model_flops(cfg, groups, lm_head=True,
                                         remat=args.remat == "full"),
                      sum(r * s for r, s in groups), args.breakdown, checks)
    return emit(
        f"train_step_ms_llama{args.model}_lora_nce",
        f"ms per micro step (Llama {args.model} published widths, random "
        f"bf16 weights, sparse NCE, batch {args.bz} x (1 + {N_NEGS}) at "
        f"q{Q_LEN}/d{D_LEN}, LoRA r 16, remat {args.remat}, one card; "
        f"mean of {STEPS} steps after 1 + {WARM} untimed)",
        args.remat, out, args, dev, card_s, before, checks)


if __name__ == "__main__":
    raise SystemExit(main())
