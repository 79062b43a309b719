"""The MNTP training micro step on one card (the port's counterpart of
``bench_mntp.py``).

    python3 -m scaling_retriever_tpu_torch.benches.mntp [--model 1b|3b|8b]
        [--remat full] [--bz 8] [--breakdown] [--device cpu]

The reference's MNTP recipe (masked next-token prediction with LoRA r 16,
alpha 32, 512-token rows, mask probability 0.2, bf16) at the published
widths of ``benches.train`` with random bf16 weights from ``--seed``:
``MNTPModel`` trained by the port's ``Trainer`` on its shifted masked
cross-entropy. A micro step is the bidirectional forward over ``--bz``
rows of 512 tokens, the LM head, the loss on the picked positions, the
backward to the LoRA factors and the AdamW update. The batch is
bench_mntp.py's: random ids, each position picked with probability 0.2,
80% of the picked set to id 95, labels -100 elsewhere. Timing, the
breakdown, ``mfu`` and the checks are ``benches.train``'s.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common, train
from scaling_retriever_tpu_torch.models.weights import random_params
from scaling_retriever_tpu_torch.training.mntp import MNTPModel
from scaling_retriever_tpu_torch.training.trainer import Trainer

SEQ = 512
MLM_P = 0.2
MASK_ID = 95


def make_batch(seed: int, vocab: int, bz: int) -> dict:
    """bench_mntp.py's batch, in its ``default_rng(seed)`` order: ids, the
    picked positions, then which of them take the mask id."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (bz, SEQ)).astype(np.int32)
    picked = rng.random((bz, SEQ)) < MLM_P
    labels = np.where(picked, ids, -100).astype(np.int32)
    masked = np.where(picked & (rng.random((bz, SEQ)) < 0.8), MASK_ID, ids)
    return {"input_ids": masked.astype(np.int32),
            "attention_mask": np.ones((bz, SEQ), np.int32),
            "labels": labels}


def main(argv=None) -> int:
    args = train.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}; "
               f"model {args.model}, remat {args.remat}, bz {args.bz}, "
               f"seq {SEQ}")
    before = common.launches()
    checks = common.Checks()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cfg = train.model_config(args.model, args.remat)
    t0 = time.perf_counter()
    params = random_params(cfg, args.seed, dev)
    lora, lc = train.lora_for(cfg, dev, args.seed + 1,
                              base_model_name_or_path="llama-random",
                              base_model_class="LlamaBiForMNTP")
    common.sync(dev)
    common.log(f"{sum(p.numel() for p in params.parameters()) / 1e9:.2f}B "
               f"parameters on the device in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="bench_mntp_") as tmp:
        trainer = Trainer(MNTPModel(params, cfg, lora, lc),
                          train.training_args(tmp, ("rank",), (1.0,)),
                          train_loader=[])
        batch = train.to_device(make_batch(args.seed, cfg.vocab_size,
                                           args.bz), dev)
        out = train.measure(
            trainer, batch, dev,
            common.model_flops(cfg, [(args.bz, SEQ)], lm_head=True,
                               remat=args.remat == "full"),
            args.bz * SEQ, args.breakdown, checks)
    return train.emit(
        f"mntp_step_ms_llama{args.model}_lora",
        f"ms per micro step (Llama {args.model} published widths, random "
        f"bf16 weights, MNTP, batch {args.bz} x {SEQ}, mlm {MLM_P}, LoRA r "
        f"16, remat {args.remat}, one card; mean of {train.STEPS} steps "
        f"after 1 + {train.WARM} untimed)",
        args.remat, out, args, dev, card_s, before, checks)


if __name__ == "__main__":
    raise SystemExit(main())
