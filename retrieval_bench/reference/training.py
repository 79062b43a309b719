"""The plain reference of the LoRA sparse NCE step, in float32 with TF32
off: the decoder of ``reference/decoder.py`` with a LoRA branch on every
projection (``y += x @ A @ B * alpha / r``), the SPLADE head, the NCE
loss over in-batch contexts (``cross_entropy(q @ c.T, labels)``) plus the
FLOPS regularizers (``sum_j mean_i(|x_ij|)^2``) at ``lambda * (min(t, T) /
T)^2`` at micro step t (from 1),
the gradients to the factors by autograd (each layer recomputed in the
backward, the head in blocks of rows), clipping to a global norm, and
AdamW's update at a linearly decaying learning rate, written out.

``precision="fp8"`` rounds the base projections' inputs and weights to
e4m3 (the control). ``half=True`` drops the second half of the queries
and their contexts and takes the mean over the rest (a fault the
comparison has to catch).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from retrieval_bench import gen
from retrieval_bench.reference.decoder import (exact_f32, layer, linear,
                                               rms_norm)

HEAD_ROWS = 8


def leaves_of(lora: dict) -> dict:
    """{path: tensor} in the Trainer's order (keys sorted at every
    level)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
        else:
            out[path] = node

    walk(lora, "")
    return out


def _layer(m, seed, li, precision, scale, x, keep, *factors):
    w = {k: v.float() for k, v in gen.layer_weights(m, seed, li,
                                                     x.device).items()}
    names = [n for _, n in gen.LORA_MODULES]
    lora = {n: (factors[2 * j], factors[2 * j + 1])
            for j, n in enumerate(names)}
    return layer(m, w, x, keep, precision, lora, scale)


def _head(m, head, final, precision, x, keep):
    x = rms_norm(x, final, m["rms_norm_eps"])
    logits = linear(x, head, precision) * float(m["hidden_size"]) ** -0.25
    logits = logits.masked_fill(~keep[:, :, None], float("-inf"))
    return torch.log1p(torch.relu(logits.amax(dim=1)))


def reps(m, seed, ids, keep, leaves, scale, precision, table, head, final):
    x = table[ids.long()]
    for li in range(m["num_hidden_layers"]):
        factors = []
        for group, name in gen.LORA_MODULES:
            factors += [leaves[f"layers.{group}.{name}.a"][li],
                        leaves[f"layers.{group}.{name}.b"][li]]
        x = checkpoint(_layer, m, seed, li, precision, scale, x, keep,
                       *factors, use_reentrant=False)
    return torch.cat([checkpoint(_head, m, head, final, precision,
                                 x[r:r + HEAD_ROWS], keep[r:r + HEAD_ROWS],
                                 use_reentrant=False)
                      for r in range(0, x.shape[0], HEAD_ROWS)])


def flops_reg(x: torch.Tensor) -> torch.Tensor:
    return (x.abs().mean(dim=0) ** 2).sum()


def ramp(lam: float, horizon: int, step: int) -> float:
    """lambda * (min(step, horizon) / horizon)^2, in float32."""
    t = torch.tensor(float(min(step, horizon)), dtype=torch.float32)
    return float(lam * (t / float(horizon)) ** 2)


def loss(m, seed, batch, leaves, hp, precision, half, tables, step):
    q_ids = batch["tokenized_queries"]["input_ids"]
    c_ids = batch["tokenized_contexts"]["input_ids"]
    q_keep = batch["tokenized_queries"]["attention_mask"] > 0
    c_keep = batch["tokenized_contexts"]["attention_mask"] > 0
    labels = batch["target_labels"].long()
    if half:
        bz = q_ids.shape[0] // 2
        per = c_ids.shape[0] // q_ids.shape[0]
        q_ids, q_keep, labels = q_ids[:bz], q_keep[:bz], labels[:bz]
        c_ids, c_keep = c_ids[:bz * per], c_keep[:bz * per]
    q = reps(m, seed, q_ids, q_keep, leaves, hp["scale"], precision, *tables)
    c = reps(m, seed, c_ids, c_keep, leaves, hp["scale"], precision, *tables)
    logp = torch.log_softmax(q @ c.T, dim=-1)
    rank = -logp.gather(1, labels[:, None])[:, 0].mean()
    return (rank + ramp(hp["query_reg"], hp["reg_T"], step) * flops_reg(q)
            + ramp(hp["doc_reg"], hp["reg_T"], step) * flops_reg(c))


def lr_at(hp: dict, count: int) -> float:
    """The linear schedule (no warmup) at an update's count, in float32."""
    f32 = torch.float32
    frac = torch.tensor(1.0, dtype=f32) - torch.tensor(
        float(min(count, hp["max_steps"])), dtype=f32) / torch.tensor(
        float(hp["max_steps"]), dtype=f32)
    return float(torch.tensor(hp["lr"], dtype=f32) * frac)


def train_steps(m: dict, seed: int, lora: dict, batches: list, hp: dict,
                device, precision: str = "f32", half: bool = False) -> dict:
    """Follow ``len(batches)`` optimizer steps from ``lora``. Returns each
    step's loss, each step's clipped gradient norm by leaf, and the
    leaves' change after the last step, by leaf."""
    with exact_f32():
        emb = gen.embed_weights(m, seed, device)
        table = emb["embed"].float()
        head = gen.head_weight(m, seed, device)
        tables = (table, table if head is None else head.float(),
                  emb["final_norm"].float())
        start = {k: v.detach().float().clone()
                 for k, v in leaves_of(lora).items()}
        leaves = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        m1 = {k: torch.zeros_like(v) for k, v in start.items()}
        m2 = {k: torch.zeros_like(v) for k, v in start.items()}
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
        out = {"loss": [], "grad_norms": []}
        for step, batch in enumerate(batches, start=1):
            total = loss(m, seed, batch, leaves, hp, precision, half, tables,
                         step)
            grads = torch.autograd.grad(total, list(leaves.values()))
            grads = dict(zip(leaves, grads))
            norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
            if not bool(norm < hp["max_grad_norm"]):
                grads = {k: g / norm * hp["max_grad_norm"]
                         for k, g in grads.items()}
            out["loss"].append(float(total.detach()))
            out["grad_norms"].append({k: float(g.norm())
                                      for k, g in grads.items()})
            lr = lr_at(hp, step - 1)
            with torch.no_grad():
                for k, p in leaves.items():
                    g = grads[k]
                    p.mul_(1.0 - lr * hp["weight_decay"])
                    m1[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    m2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (m2[k].sqrt() / math.sqrt(1.0 - b2 ** step)
                             ).add_(eps)
                    p.addcdiv_(m1[k], denom, value=-lr / (1.0 - b1 ** step))
        out["change_norms"] = {k: float((leaves[k].detach() - start[k]).norm())
                               for k in leaves}
    return out
