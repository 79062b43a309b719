"""The training loop for retriever encoders (port of training/trainer.py).

  * the loss combination of the reference's training step:
    ``total = sum_nonreg w_k * loss_k + sum_reg lambda_t * loss_k``, the
    quadratic ramp lambda_t read at the micro step (counted from 1), tasks
    not listed kept as metrics only, times ``loss_scale``;
  * gradients from autograd over the trainable leaves only (the LoRA
    factors; the whole module under ``lora=False``), the base frozen;
  * optax's arithmetic: gradient accumulation as ``MultiSteps`` (the
    running mean of the micro gradients, then one update), global-norm
    clipping as ``clip_by_global_norm`` (``g / norm * max_norm``, no
    epsilon), then ``torch.optim.AdamW`` at the learning rate of the
    schedule at the update's count (the first update reads count 0);
  * ``max_steps`` counts optimizer steps; ``max_steps <= 0`` trains
    ``num_train_epochs`` epochs;
  * per-task metrics to ``trainer_log.jsonl`` (and wandb, where installed);
  * artifacts: a peft adapter or an HF checkpoint (``save_model``), and a
    resumable ``checkpoint-N/`` written with ``torch.save`` (the port's own
    format), resumed by path or ``"auto"``, mid-epoch included;
  * placements as the reference chooses them over its mesh (tensor
    parallel on a ``model`` axis above 1, FSDP under ``fsdp`` on a ``data``
    axis above 1, else replicated), kept as ``param_shardings`` and
    ``trainable_shardings`` and applied with
    ``parallel.partitioning.apply_shardings``. A mesh whose entries are
    one device runs the global batch's step there, as the reference's one
    program over a sharded batch computes it; a single process over
    several distinct cards raises.
  * launched under ``torchrun`` (a distributed mesh, ``parallel.mesh``),
    every rank iterates the same global loader and computes the global
    batch's losses from its own rows (``loss_forward(..., mesh=)`` gathers
    the reps), so each step equals the reference's one-program step: the
    trainable's gradients are then all-reduced over ``data`` and divided
    by its size (FSDP's reduce-scatter already averages what it shards),
    the tensor-parallel LoRA factors' partial gradients summed over
    ``model``, and the norm taken over the global gradient (a shard's
    squares summed over the axes it is split over). Rank 0 alone
    writes the log, the checkpoints and the artifact, from full tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from scaling_retriever_tpu_torch.models import losses as losses_lib
from scaling_retriever_tpu_torch.models.llama import fold_in
from scaling_retriever_tpu_torch.parallel.mesh import (make_mesh, shard_batch,
                                                       to_device)
from scaling_retriever_tpu_torch.parallel.partitioning import (
    apply_shardings, fsdp_shardings, model_parallel_shardings,
    replicated_shardings,
)
from scaling_retriever_tpu_torch.utils.profiling import profile_span
from scaling_retriever_tpu_torch.utils.utils import is_first_worker

STATE_FILE = "trainer_state.pt"
# the CLIs' --remat → ModelConfig.remat, the reference's values
REMAT = {"none": False, "full": True, "dots": "dots_saveable",
         "dots_nb": "dots_with_no_batch_dims_saveable",
         "attn": "names:attn_q,attn_k,attn_v,attn_out",
         "attn_mlp": "names:attn_q,attn_k,attn_v,attn_out,mlp_mid"}


@dataclasses.dataclass
class LLM2RetrieverTrainingArgs:
    """The reference's training arguments, field for field."""

    model_name_or_path: str = ""
    output_dir: str = "out"
    model_type: str = "llama"
    loss_type: str = "nce"           # nce | margin_mse | kldiv | nce_kldiv
    # non-"reg" names are weighted directly; "*reg*" names get the
    # quadratic ramp with lambda = the task weight
    task_names: Sequence[str] = ("rank", "query_reg", "doc_reg")
    task_weights: Sequence[float] = (1.0, 0.01, 0.008)
    reg_T: Optional[int] = None      # ramp horizon; default max_steps // 3
    # lora
    lora: bool = True
    lora_r: int = 16
    lora_alpha: int = 32
    lora_dropout: float = 0.1
    lora_modules_to_save: Optional[Sequence[str]] = None
    # optimization
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.0
    warmup_steps: int = 0
    max_steps: int = 1000            # optimizer steps; <= 0 → epochs
    num_train_epochs: float = 3.0    # used only when max_steps <= 0
    per_device_train_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    # data
    n_negs: int = 1
    query_max_length: int = 64
    doc_max_length: int = 128
    T: float = 0.01                   # dense temperature
    # runtime
    bf16: bool = False
    fsdp: bool = False               # FSDP over data (replicated at 1)
    n_data_shards: Optional[int] = None
    loss_scale: float = 1.0
    logging_steps: int = 50
    eval_steps: Optional[int] = None   # eval_fn every N optimizer steps
    save_steps: Optional[int] = None
    save_total_limit: int = 1
    seed: int = 42
    resume_from_checkpoint: Optional[str] = None   # path or "auto"
    wandb_project_name: Optional[str] = None
    run_name: Optional[str] = None

    @property
    def ln_to_weight(self) -> dict:
        return dict(zip(self.task_names, self.task_weights))

    @property
    def reg_horizon(self) -> int:
        return self.reg_T if self.reg_T else max(1, self.max_steps // 3)


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    """The latest ``checkpoint-N`` directory, or None."""
    if not os.path.isdir(output_dir):
        return None
    ckpts = [d for d in os.listdir(output_dir)
             if d.startswith("checkpoint-")
             and os.path.isdir(os.path.join(output_dir, d))]
    if not ckpts:
        return None
    latest = max(ckpts, key=lambda d: int(d.split("-")[1]))
    return os.path.join(output_dir, latest)


def linear_warmup_decay(lr: float, warmup: int, total: int):
    """The HF 'linear' schedule as optax joins it: 0 → lr over ``warmup``
    counts, lr → 0 over the rest, each piece clamped to its range, in
    float32. Returns count → learning rate."""
    warmup = max(warmup, 0)
    f32 = np.float32

    def linear(init, end, steps, count):
        count = min(max(count, 0), steps)
        frac = f32(1) - f32(count) / f32(steps)
        return f32(init - end) * frac + f32(end)

    def schedule(count: int) -> float:
        if count < warmup:
            return float(linear(0.0, lr, max(warmup, 1), count))
        return float(linear(lr, 0.0, max(total - warmup, 1), count - warmup))

    return schedule


def tree_leaves(tree) -> list:
    """(path, tensor) pairs of a nested dict of tensors, or of a module's
    parameters, in a fixed order."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.named_parameters())
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in float32. A
    DTensor's squares (an FSDP or a tensor-parallel shard) are summed over
    each mesh axis it is split over, as ``torch.nn.utils.get_total_norm``
    does."""
    plain = [t for t in tensors if not isinstance(t, DTensor)]
    total = sum((t.float() ** 2).sum() for t in plain)
    split: dict = {}      # (mesh, the axes it is split over) -> squares
    for t in tensors:
        if isinstance(t, DTensor):
            key = (t.device_mesh, tuple(i for i, p in enumerate(t.placements)
                                        if p.is_shard()))
            split[key] = split.get(key, 0.0) + (t.to_local().float()
                                                ** 2).sum()
    for (mesh, axes), sq in split.items():
        for i in axes:
            dist.all_reduce(sq, group=mesh.get_group(i))
        total = total + sq
    return torch.sqrt(total)


class Trainer:
    """The training loop; ``encoder`` is any LLM2Retriever (or MNTPModel).
    It trains in place: ``encoder.lora`` (or ``encoder.params`` under
    ``lora=False``) is ``self.trainable``."""

    def __init__(self, encoder, args: LLM2RetrieverTrainingArgs,
                 train_loader, mesh=None, eval_fn=None):
        self.encoder = encoder
        self.args = args
        self.train_loader = train_loader
        # eval_fn(trainable, step) -> metrics, every args.eval_steps
        # optimizer steps
        self.eval_fn = eval_fn
        self.mesh = mesh if mesh is not None else make_mesh(
            device=encoder.params.device)
        if self.mesh.distinct:
            raise NotImplementedError(
                "one process trains on one card: to train over several "
                "cards, launch one process per card under torchrun "
                "(torch.distributed), e.g. torchrun --nproc_per_node N -m "
                "scaling_retriever_tpu_torch.training.train_sparse ...")
        self.step = 0        # optimizer steps completed
        self.micro_step = 0  # loader batches consumed
        self.epoch = 0
        self._epoch_start_micro = 0
        self._resume_skip_batches = 0
        self._log_path = os.path.join(args.output_dir, "trainer_log.jsonl")

        warmup = args.warmup_steps or int(args.warmup_ratio * args.max_steps)
        self.schedule = linear_warmup_decay(args.learning_rate, warmup,
                                            args.max_steps)
        self.use_lora = encoder.lora is not None
        if self.mesh.shape.get("model", 1) > 1:
            self.param_shardings = model_parallel_shardings(
                encoder.params, self.mesh, fsdp=args.fsdp)
        elif args.fsdp and self.mesh.shape["data"] > 1:
            self.param_shardings = fsdp_shardings(encoder.params, self.mesh)
        else:
            self.param_shardings = replicated_shardings(encoder.params,
                                                        self.mesh)
        encoder.params = apply_shardings(encoder.params,
                                         self.param_shardings)
        if self.use_lora:
            self.trainable_shardings = replicated_shardings(encoder.lora,
                                                            self.mesh)
            encoder.lora = apply_shardings(encoder.lora,
                                           self.trainable_shardings)
        else:
            self.trainable_shardings = self.param_shardings
        self.params = encoder.params if self.use_lora else None
        self.trainable = encoder.lora if self.use_lora else encoder.params
        leaves = tree_leaves(self.trainable)
        self._paths = [path for path, _ in leaves]
        self._leaves = [t for _, t in leaves]
        for t in self._leaves:
            t.requires_grad_(True)
        self.optimizer = torch.optim.AdamW(
            self._leaves, lr=self.schedule(0),
            betas=(args.adam_beta1, args.adam_beta2), eps=args.adam_epsilon,
            weight_decay=args.weight_decay)
        self._acc = None     # the running mean of the micro gradients

    # ------------------------------------------------------------------

    def _combined_loss(self, batch, step: int):
        args = self.args
        dropout_seed = (fold_in(args.seed, step)
                        if self.use_lora and args.lora_dropout > 0.0
                        else None)
        kw = {"mesh": self.mesh} if self.mesh.distributed else {}
        if self.use_lora:
            task_losses = self.encoder.loss_forward(
                self.params, self.trainable, batch, dropout_seed, **kw)
        else:
            task_losses = self.encoder.loss_forward(self.trainable, None,
                                                    batch, **kw)
        total = 0.0
        weighted = {}
        for name, value in task_losses.items():
            if "reg" in name:
                lam = losses_lib.reg_weight_at_step(
                    args.ln_to_weight.get(name, 0.0), args.reg_horizon, step)
                total = total + value * lam
                weighted[name] = value * lam
            elif name in args.ln_to_weight:
                w = args.ln_to_weight[name]
                total = total + value * w
                weighted[name] = value * w
            else:
                weighted[name] = value   # metric only (nce/kldiv splits)
        return total * args.loss_scale, weighted

    def _train_step(self, batch, step: int) -> dict:
        """One micro step: the loss and its gradients, accumulated; at the
        last micro step of an optimizer step, clip and update. Spans:
        ``train.forward``, ``train.backward``, ``train.reduce`` (the
        gradients gathered, reduced over ranks, their norm and the
        accumulation), ``train.optimizer`` (``_apply``) and ``train.read``
        (the metrics read to the host)."""
        with profile_span("train.forward"):
            loss, weighted = self._combined_loss(batch, step)
        with profile_span("train.backward"):
            # backward (not autograd.grad): FSDP reduce-scatters into .grad
            loss.backward(inputs=self._leaves if self.use_lora else None)
        with profile_span("train.reduce"):
            grads = []
            for p in self._leaves:
                grads.append(torch.zeros_like(p) if p.grad is None
                             else p.grad)
                p.grad = None
            grads = self._reduce(grads)
            gnorm = global_norm(grads)
            gas = max(self.args.gradient_accumulation_steps, 1)
            mini = (step - 1) % gas
            if mini == 0:
                self._acc = list(grads)
            else:
                for acc, g in zip(self._acc, grads):
                    acc.add_((g - acc) / (mini + 1))
        if mini == gas - 1:
            self._apply(self._acc)
            self._acc = None
        with profile_span("train.read"):
            metrics = {"loss": loss, "grad_norm": gnorm, **weighted}
            return {k: float(v.detach()) for k, v in metrics.items()}

    @torch.no_grad()
    def _reduce(self, grads) -> list:
        """Each rank's gradients → the global batch's, on a distributed
        mesh (see the module's docstring); as they are otherwise. FSDP's
        shards come averaged over data; every other gradient (of a
        tensor-parallel shard: its local part) is all-reduced over data
        and divided by its size. A LoRA factor of the layers is then
        summed over ``model``: each rank's projection columns or rows gave
        a part of it (every other gradient is whole on each model
        rank)."""
        if not self.mesh.distributed:
            return grads
        n_data = self.mesh.shape["data"]
        data = self.mesh.group("data")
        model = (self.mesh.group("model")
                 if self.use_lora and self.mesh.shape["model"] > 1 else None)
        for path, g in zip(self._paths, grads):
            if isinstance(g, DTensor):
                axes = g.device_mesh.mesh_dim_names
                if "data" in axes and g.placements[
                        axes.index("data")].is_shard():
                    continue                # FSDP's reduce-scatter averaged
                g = g.to_local()
            dist.all_reduce(g, group=data)
            g.div_(n_data)
            if model is not None and path.startswith("layers."):
                dist.all_reduce(g, group=model)
        return grads

    @torch.no_grad()
    def _apply(self, grads) -> None:
        """Clip (one read of the norm) and take the AdamW step: the span
        ``train.optimizer``."""
        with profile_span("train.optimizer"):
            norm = global_norm(grads)
            if not bool(norm < self.args.max_grad_norm):
                grads = [g / norm * self.args.max_grad_norm for g in grads]
            for p, g in zip(self._leaves, grads):
                p.grad = g.to(p.dtype)
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)

    # ------------------------------------------------------------------

    def train(self) -> dict:
        args = self.args
        os.makedirs(args.output_dir, exist_ok=True)
        if args.resume_from_checkpoint == "auto":
            last = get_last_checkpoint(args.output_dir)
            if last:
                print(f"resuming from {last}", flush=True)
                self.load_state(last)
        elif args.resume_from_checkpoint:
            self.load_state(args.resume_from_checkpoint)
        self._wandb = None
        if args.wandb_project_name:
            try:
                import wandb

                self._wandb = wandb.init(project=args.wandb_project_name,
                                         name=args.run_name, resume="allow")
            except ImportError:
                print("wandb not installed; logging to jsonl only",
                      flush=True)

        accum: dict[str, float] = {}
        n_acc = 0
        t0 = time.time()
        gas = max(args.gradient_accumulation_steps, 1)
        # batches of the current epoch already consumed before a resume
        skip_in_epoch = self._resume_skip_batches
        self._resume_skip_batches = 0
        done = self._stop(args)
        while not done:
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(self.epoch)
            self._epoch_start_micro = self.micro_step - skip_in_epoch
            epoch_had_batches = False
            for batch in self.train_loader:
                epoch_had_batches = True
                if skip_in_epoch > 0:
                    skip_in_epoch -= 1
                    continue
                # every rank holds the global batch; loss_forward takes
                # each encoded input's rows of this rank
                batch = (to_device(batch, self.mesh.device)
                         if self.mesh.distributed
                         else shard_batch(batch, self.mesh))
                # the ramp advances once per micro step
                self.micro_step += 1
                with profile_span("train.step"):
                    metrics = self._train_step(batch, self.micro_step)
                for k, v in metrics.items():
                    accum[k] = accum.get(k, 0.0) + v
                n_acc += 1
                if self.micro_step % gas == 0:
                    self.step += 1
                    if self.step % args.logging_steps == 0:
                        self._log({k: v / n_acc for k, v in accum.items()},
                                  time.time() - t0)
                        accum, n_acc = {}, 0
                    if args.save_steps and self.step % args.save_steps == 0:
                        self.save_checkpoint()
                    if (self.eval_fn is not None and args.eval_steps
                            and self.step % args.eval_steps == 0):
                        self._log(dict(self.eval_fn(self.trainable,
                                                    self.step)),
                                  time.time() - t0)
                if self._stop(args):
                    done = True
                    break
            if not done:
                self.epoch += 1
                if not epoch_had_batches or self._stop(args):
                    break
        if n_acc:
            self._log({k: v / n_acc for k, v in accum.items()},
                      time.time() - t0)
        return {"train_steps": self.step, "micro_steps": self.micro_step}

    def _stop(self, args) -> bool:
        if args.max_steps and args.max_steps > 0:
            return self.step >= args.max_steps
        return self.epoch >= args.num_train_epochs

    def _log(self, metrics: dict, elapsed: float) -> None:
        if not is_first_worker():
            return
        entry = {"step": self.step, "elapsed_sec": round(elapsed, 2),
                 **metrics}
        print(json.dumps(entry), flush=True)
        with open(self._log_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        if getattr(self, "_wandb", None) is not None:
            self._wandb.log(metrics, step=self.step)

    # -- checkpointing -------------------------------------------------------

    def _barrier(self) -> None:
        if self.mesh.distributed:
            dist.barrier()

    @property
    def _sharded(self) -> bool:
        """Some trainable leaf is a shard (FSDP's or tensor-parallel,
        under ``--no_lora``)."""
        return any(isinstance(t, DTensor) for t in self._leaves)

    def save_model(self, out_dir: Optional[str] = None) -> None:
        """The final artifact: a peft adapter, or an HF checkpoint; the
        encoder picks the format. Rank 0 writes it, from full tensors."""
        trainable = self.trainable
        if self._sharded:
            trainable = self._full_module()
        if is_first_worker():
            self.encoder.save_trained(trainable,
                                      out_dir or self.args.output_dir,
                                      use_lora=self.use_lora)
        self._barrier()

    def _full_module(self) -> Optional[torch.nn.Module]:
        """The sharded module's full weights on the host, in a module of
        their own, on rank 0 (every rank takes part in the gathers; the
        others get None)."""
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_model_state_dict)

        sd = get_model_state_dict(self.trainable, options=StateDictOptions(
            full_state_dict=True, cpu_offload=True))
        if not is_first_worker():
            return None
        with torch.device("meta"):
            full = type(self.trainable)(self.trainable.config)
        if self.trainable.lm_head is None:
            full.lm_head = None
        full.load_state_dict(sd, assign=True)
        return full

    def save_checkpoint(self) -> str:
        """Resumable state (counters, trainable, optimizer) in
        ``checkpoint-<step>/trainer_state.pt``, taken at an optimizer-step
        boundary; rank 0 writes it, from full tensors."""
        ckpt_dir = os.path.join(os.path.abspath(self.args.output_dir),
                                f"checkpoint-{self.step}")
        if self._sharded:
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, get_state_dict)

            trainable, optimizer = get_state_dict(
                self.trainable, self.optimizer, options=StateDictOptions(
                    full_state_dict=True, cpu_offload=True))
        else:
            trainable = {k: t.detach().cpu()
                         for k, t in tree_leaves(self.trainable)}
            optimizer = self.optimizer.state_dict()
        if is_first_worker():
            os.makedirs(ckpt_dir, exist_ok=True)
            torch.save({
                "step": self.step,
                "micro_step": self.micro_step,
                "epoch": self.epoch,
                "micro_in_epoch": self.micro_step - self._epoch_start_micro,
                "trainable": trainable,
                "optimizer": optimizer,
            }, os.path.join(ckpt_dir, STATE_FILE))
            self._prune_checkpoints()
        self._barrier()
        return ckpt_dir

    def _prune_checkpoints(self) -> None:
        limit = self.args.save_total_limit
        if not limit:
            return
        root = self.args.output_dir
        ckpts = sorted(
            (d for d in os.listdir(root) if d.startswith("checkpoint-")),
            key=lambda d: int(d.split("-")[1]))
        for d in ckpts[:-limit]:
            shutil.rmtree(os.path.join(root, d))

    @torch.no_grad()
    def load_state(self, ckpt_dir: str) -> None:
        """Every rank reads the full state; FSDP's shards are cut from it
        on each rank."""
        state = torch.load(os.path.join(ckpt_dir, STATE_FILE),
                           map_location=self.mesh.device, weights_only=True)
        self.step = int(state["step"])
        gas = max(self.args.gradient_accumulation_steps, 1)
        self.micro_step = int(state.get("micro_step", self.step * gas))
        self.epoch = int(state.get("epoch", 0))
        # re-seek the loader within the epoch; the dropout needs no state:
        # its seed is fold_in(seed, micro_step)
        self._resume_skip_batches = int(state.get("micro_in_epoch", 0))
        if self._sharded:
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, set_state_dict)

            set_state_dict(self.trainable, self.optimizer,
                           model_state_dict=state["trainable"],
                           optim_state_dict=state["optimizer"],
                           options=StateDictOptions(full_state_dict=True))
        else:
            saved = state["trainable"]
            for k, t in tree_leaves(self.trainable):
                t.copy_(saved[k])
            self.optimizer.load_state_dict(state["optimizer"])
        self._acc = None


SparseTrainer = Trainer
DenseTrainer = Trainer
DenseTrainerForNCE_KLdiv = Trainer
