"""MNTP (masked next-token prediction) pretraining (port of
training/mntp.py).

Tokens are masked MLM-style (probability 0.2; the mask token is "_", eos or
the tokenizer's own) and the loss is the causal shift: position i-1
predicts the masked token at i. Components:

  * ``MNTPCollator``: the 80/10/10 masking of HF's
    DataCollatorForLanguageModeling, or 100% masking, drawn with numpy's
    ``default_rng(seed)`` as the reference draws (the same masks for the
    same seed);
  * ``group_texts``: concatenate and chunk;
  * ``MNTPModel``: an encoder-like wrapper whose ``loss_forward`` is the
    shifted masked cross-entropy, so the shared Trainer drives it;
  * the CLI, with the reference's flags and ``--config_json`` (the
    ``configs/mntp/*.json`` files), plus ``--device`` (default "cuda")
    and train_sparse's ``--remat``:

    python -m scaling_retriever_tpu_torch.training.mntp \\
        --config_json configs/mntp/llama3_1b_msmarco.json \\
        --model_name_or_path CKPT --train_file raw.train.tsv --output_dir OUT
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP
from scaling_retriever_tpu_torch.parallel.collectives import sum_over
from scaling_retriever_tpu_torch.parallel.mesh import (init_distributed,
                                                       rank_part)
from scaling_retriever_tpu_torch.utils.utils import is_first_worker

IGNORE = -100


def resolve_mask_token_id(tokenizer, mask_token_type: str) -> int:
    """'blank' → '_', 'eos' → eos, 'mask' → the tokenizer's mask token."""
    if mask_token_type == "blank":
        ids = tokenizer.convert_tokens_to_ids(["_"])
        if ids and ids[0] != tokenizer.unk_token_id and ids[0] is not None:
            return ids[0]
        enc = tokenizer("_", add_special_tokens=False)["input_ids"]
        if not enc:
            raise ValueError("the tokenizer cannot encode '_'")
        return enc[-1]
    if mask_token_type == "eos":
        return tokenizer.eos_token_id
    if mask_token_type == "mask":
        if tokenizer.mask_token_id is None:
            raise ValueError("the tokenizer has no mask token")
        return tokenizer.mask_token_id
    raise ValueError(mask_token_type)


def group_texts(token_lists: Sequence[Sequence[int]], max_seq_length: int
                ) -> np.ndarray:
    """Concatenate all sequences and split into ``max_seq_length`` chunks
    (the tail shorter than a chunk is dropped)."""
    flat: list[int] = []
    for toks in token_lists:
        flat.extend(toks)
    total = (len(flat) // max_seq_length) * max_seq_length
    if total == 0:
        return np.zeros((0, max_seq_length), np.int32)
    return np.asarray(flat[:total], np.int32).reshape(-1, max_seq_length)


class MNTPCollator:
    """MLM masking over token rows. ``full_masking`` replaces every
    selected token with the mask token; otherwise 80% mask / 10% random /
    10% kept. Variable-length rows are right-padded to a multiple of 8 with
    ``pad_token_id``: pads get attention 0, label IGNORE, never masked."""

    def __init__(self, mask_token_id: int, vocab_size: int,
                 mlm_probability: float = 0.2, full_masking: bool = False,
                 special_token_ids: Sequence[int] = (), seed: int = 0,
                 pad_token_id: int = 0):
        self.mask_token_id = mask_token_id
        self.vocab_size = vocab_size
        self.mlm_probability = mlm_probability
        self.full_masking = full_masking
        self.special = np.asarray(sorted(special_token_ids), np.int64)
        self.rng = np.random.default_rng(seed)
        self.pad_token_id = pad_token_id

    def __call__(self, batch_rows) -> dict:
        rows = [np.asarray(r, np.int32) for r in batch_rows]
        lens = np.asarray([len(r) for r in rows])
        width = max(8, int(-(-lens.max() // 8) * 8))
        inputs = np.full((len(rows), width), self.pad_token_id, np.int32)
        attention = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            inputs[i, :len(r)] = r
            attention[i, :len(r)] = 1

        labels = inputs.astype(np.int64).copy()
        prob = np.full(inputs.shape, self.mlm_probability)
        if self.special.size:
            prob[np.isin(inputs, self.special)] = 0.0
        prob[attention == 0] = 0.0
        masked = self.rng.random(inputs.shape) < prob
        labels[~masked] = IGNORE

        inputs = inputs.copy()
        if self.full_masking:
            inputs[masked] = self.mask_token_id
        else:
            r = self.rng.random(inputs.shape)
            replace_mask = masked & (r < 0.8)
            replace_rand = masked & (r >= 0.8) & (r < 0.9)
            inputs[replace_mask] = self.mask_token_id
            inputs[replace_rand] = self.rng.integers(
                0, self.vocab_size, replace_rand.sum())
        return {
            "input_ids": inputs.astype(np.int32),
            "attention_mask": attention,
            "labels": labels.astype(np.int32),
        }


def mntp_shift_loss(logits: torch.Tensor, labels: torch.Tensor,
                    group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """CE(logits[:, :-1], labels[:, 1:]) over labels != -100, in float32,
    and the masked prediction accuracy. With a process ``group`` the rows
    are this rank's part of the global batch: the mean is over the group's
    label tokens (their count all-reduced), and the loss and accuracy are
    summed over the group (the loss with ``sum_over``, whose backward sums
    as the reps' gather does)."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:].long()
    mask = labels != IGNORE
    safe = labels.clamp_min(0)
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    count = mask.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    denom = count.clamp_min(1)
    loss = -(picked * mask).sum() / denom
    acc = ((logits.argmax(-1) == safe) & mask).sum() / denom
    if group is not None:
        loss = sum_over(loss, group)
        dist.all_reduce(acc, group=group)
    return loss, acc


class MNTPModel:
    """Encoder-like wrapper so that the shared Trainer drives MNTP (the
    LM head on the bidirectional model)."""

    BASE_MODEL_CLASS = "LlamaBiForMNTP"
    POOLING = "mntp"
    LOSS_TYPE = "mntp"

    def __init__(self, params: LlamaBiForMNTP, config: ModelConfig,
                 lora=None, lora_config=None):
        self.params = params
        self.config = config
        self.lora = lora
        self.lora_config = lora_config
        self.T = 1.0

    @property
    def device(self) -> torch.device:
        return self.params.device

    def loss_forward(self, params: LlamaBiForMNTP, lora: Optional[dict],
                     batch: dict, dropout_seed: Optional[int] = None,
                     mesh=None) -> dict:
        """The shifted masked cross-entropy and accuracy of one batch. On
        a distributed ``mesh`` each rank runs its rows (the [B, S, V]
        logits are never gathered) and the token mean is the global
        batch's."""
        on = lora is not None and self.lora_config is not None
        scale = self.lora_config.scaling if on else 0.0
        drop = self.lora_config.lora_dropout if on else 0.0
        dev = params.device
        ids, mask, labels = (torch.as_tensor(batch[k], device=dev) for k in
                             ("input_ids", "attention_mask", "labels"))
        part = rank_part(ids.shape[0], mesh)
        if part is not None:
            ids, mask, labels = (t[part.local] for t in (ids, mask, labels))
        logits = params.forward_logits(ids, mask, lora, scale, drop,
                                       dropout_seed, part)
        loss, acc = mntp_shift_loss(
            logits, labels, None if part is None else mesh.group("data"))
        return {"rank": loss, "accuracy": acc}

    def save_pretrained(self, save_dir: str) -> None:
        self.save_trained(self.lora if self.lora is not None else self.params,
                          save_dir, use_lora=self.lora is not None)

    @torch.no_grad()
    def save_trained(self, trainable, out_dir: str,
                     use_lora: bool = True) -> None:
        """The trainer's artifact: a peft adapter, or an HF checkpoint."""
        if use_lora and self.lora_config is not None:
            from scaling_retriever_tpu_torch.models.lora import save_adapter

            save_adapter(trainable, self.lora_config, out_dir)
        else:
            from scaling_retriever_tpu_torch.models.hf_loader import \
                save_pretrained

            save_pretrained(trainable, self.config, out_dir)


def load_mntp_corpus(path: str) -> list[str]:
    """One text per line: an MSMARCO corpus TSV (pid\\ttext), plain .txt,
    or .json/.jsonl with a "text" field."""
    texts = []
    if path.endswith((".json", ".jsonl")):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    texts.append(json.loads(line)["text"])
        return texts
    is_tsv = path.endswith(".tsv")
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.isspace():
                continue
            if is_tsv:
                parts = line.split("\t")
                texts.append(parts[1] if len(parts) >= 2 else parts[0])
            else:
                texts.append(line)
    return texts


def load_hf_dataset_texts(dataset_name: str, dataset_config_name=None,
                          split: str = "train", text_column: str = "text"
                          ) -> list[str]:
    """The wikitext-style branch through the ``datasets`` package (imported
    here): ``dataset_name`` is a local ``save_to_disk`` directory, or a
    name its cache resolves."""
    import datasets as hfd

    if os.path.isdir(dataset_name) and (
            os.path.exists(os.path.join(dataset_name, "dataset_info.json"))
            or os.path.exists(os.path.join(dataset_name,
                                           "dataset_dict.json"))):
        ds = hfd.load_from_disk(dataset_name)
    else:
        ds = hfd.load_dataset(dataset_name, dataset_config_name)
    if hasattr(ds, "keys") and split in ds:
        ds = ds[split]
    return [t for t in ds[text_column] if t and not t.isspace()]


def tokenize_line_by_line(tokenizer, texts, max_seq_length: int,
                          pad_to_max_length: bool = False) -> list:
    """Each nonempty line its own example, truncated (and optionally
    padded) to ``max_seq_length``."""
    texts = [t for t in texts if t and not t.isspace()]
    enc = tokenizer(texts, truncation=True, max_length=max_seq_length,
                    padding="max_length" if pad_to_max_length else False)
    return list(enc["input_ids"])


@torch.no_grad()
def evaluate_mntp(model: MNTPModel, trainable, eval_loader) -> dict:
    """The shifted masked-prediction loss and accuracy, averaged over the
    eval batches."""
    tot_loss, tot_acc, n = 0.0, 0.0, 0
    for batch in eval_loader:
        if model.lora is not None:
            out = model.loss_forward(model.params, trainable, batch)
        else:
            out = model.loss_forward(trainable, None, batch)
        tot_loss += float(out["rank"])
        tot_acc += float(out["accuracy"])
        n += 1
    if n == 0:
        return {"eval_loss": float("nan"), "eval_accuracy": float("nan")}
    return {"eval_loss": tot_loss / n, "eval_accuracy": tot_acc / n}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config_json", default=None,
                   help="JSON config file (configs/mntp/*.json)")
    p.add_argument("--model_name_or_path")
    p.add_argument("--train_file")
    p.add_argument("--validation_file", default=None)
    p.add_argument("--validation_split_percentage", type=int, default=5)
    p.add_argument("--dataset_name", default=None,
                   help="datasets name or save_to_disk dir (wikitext branch)")
    p.add_argument("--dataset_config_name", default=None)
    p.add_argument("--line_by_line", action="store_true",
                   help="one example per line instead of group_texts chunks")
    p.add_argument("--pad_to_max_length", action="store_true")
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--max_eval_samples", type=int, default=None)
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--eval_steps", type=int, default=None)
    p.add_argument("--per_device_eval_batch_size", type=int, default=None)
    p.add_argument("--output_dir")
    p.add_argument("--mlm_probability", type=float, default=0.2)
    p.add_argument("--mask_token_type", default="blank",
                   choices=["blank", "eos", "mask"])
    p.add_argument("--data_collator_type", default="default",
                   choices=["default", "all_mask"])
    p.add_argument("--max_seq_length", type=int, default=512)
    p.add_argument("--stop_after_n_steps", type=int, default=10000)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=int, default=None)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--remat", default="none",
                   choices=["none", "full", "dots", "dots_nb", "attn",
                            "attn_mlp"],
                   help="layer activation rematerialization, as "
                        "train_sparse's (the 1B recipe's batch of 32 x 512 "
                        "needs full on one 80 GB card)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def main(argv=None, tokenizer=None):
    """The MNTP CLI. ``tokenizer`` replaces the checkpoint's own (loaded by
    ``transformers``) when given."""
    from scaling_retriever_tpu_torch.data.loader import DataLoader
    from scaling_retriever_tpu_torch.models.encoder import load_tokenizer
    from scaling_retriever_tpu_torch.models.hf_loader import load_pretrained
    from scaling_retriever_tpu_torch.models.lora import (LoraConfig,
                                                        init_lora_params)
    from scaling_retriever_tpu_torch.training.trainer import (
        REMAT, LLM2RetrieverTrainingArgs, Trainer)

    p = build_parser()
    ns = p.parse_args(argv)
    if ns.config_json:
        with open(ns.config_json) as f:
            cfg = json.load(f)
        for k, v in cfg.items():
            if hasattr(ns, k) and getattr(ns, k) in (None, p.get_default(k)):
                setattr(ns, k, v)

    if tokenizer is None:
        tokenizer = load_tokenizer(ns.model_name_or_path)
    joined = dist.is_initialized()
    # under torchrun: this rank's card (or the CPU); the Trainer's mesh is
    # then over the ranks and shards each loader batch over them, as the
    # reference's mesh over its devices
    device = init_distributed(ns.device)
    dt = torch.bfloat16 if ns.bf16 else torch.float32
    params, config = load_pretrained(ns.model_name_or_path, device=device,
                                     param_dtype=dt, dtype=dt,
                                     remat=REMAT[ns.remat])
    # lora_alpha defaults to 2 * r; the adapter class follows the family
    mntp_class = {"llama": "LlamaBiForMNTP", "qwen2": "Qwen2BiForMNTP",
                  "mistral": "MistralBiForMNTP"}.get(config.model_type,
                                                     "LlamaBiForMNTP")
    lora_alpha = ns.lora_alpha if ns.lora_alpha else 2 * ns.lora_r
    lora_config = LoraConfig(r=ns.lora_r, lora_alpha=lora_alpha,
                             lora_dropout=ns.lora_dropout,
                             base_model_name_or_path=ns.model_name_or_path,
                             base_model_class=mntp_class)
    g = torch.Generator(device=params.device).manual_seed(ns.seed)
    lora = init_lora_params(config, lora_config, g, device=params.device)
    model = MNTPModel(params, config, lora, lora_config)

    # raw texts: the datasets branch or the file branch, with the
    # validation split taken off the front of the training texts
    if ns.dataset_name:
        train_texts = load_hf_dataset_texts(ns.dataset_name,
                                            ns.dataset_config_name, "train")
        try:
            eval_texts = load_hf_dataset_texts(
                ns.dataset_name, ns.dataset_config_name, "validation")
        except (KeyError, ValueError, FileNotFoundError):
            eval_texts = None
    else:
        train_texts = load_mntp_corpus(ns.train_file)
        eval_texts = (load_mntp_corpus(ns.validation_file)
                      if ns.validation_file else None)
    if eval_texts is None and ns.do_eval:
        cut = max(1, len(train_texts) * ns.validation_split_percentage // 100)
        eval_texts, train_texts = train_texts[:cut], train_texts[cut:]

    def to_rows(texts):
        if ns.line_by_line:
            return tokenize_line_by_line(tokenizer, texts, ns.max_seq_length,
                                         ns.pad_to_max_length)
        token_lists = tokenizer(texts, add_special_tokens=True,
                                truncation=False)["input_ids"]
        return list(group_texts(token_lists, ns.max_seq_length))

    train_rows = to_rows(train_texts)
    if ns.max_train_samples:
        train_rows = train_rows[:ns.max_train_samples]
    mask_id = resolve_mask_token_id(tokenizer, ns.mask_token_type)
    pad_id = tokenizer.pad_token_id or 0
    specials = [t for t in (tokenizer.bos_token_id, tokenizer.eos_token_id,
                            tokenizer.pad_token_id) if t is not None]

    def collator(seed):
        return MNTPCollator(
            mask_id, config.vocab_size, ns.mlm_probability,
            full_masking=(ns.data_collator_type == "all_mask"),
            special_token_ids=specials, seed=seed, pad_token_id=pad_id)

    eval_fn = None
    if ns.do_eval and eval_texts:
        eval_rows = to_rows(eval_texts)
        if ns.max_eval_samples:
            eval_rows = eval_rows[:ns.max_eval_samples]
        eval_bz = (ns.per_device_eval_batch_size
                   or ns.per_device_train_batch_size)

        def eval_fn(trainable, step):
            # the same masks on every call, for comparable numbers
            return evaluate_mntp(model, trainable, DataLoader(
                eval_rows, eval_bz, collator(ns.seed + 1)))

    args = LLM2RetrieverTrainingArgs(
        model_name_or_path=ns.model_name_or_path, output_dir=ns.output_dir,
        task_names=("rank",), task_weights=(1.0,),
        lora_dropout=ns.lora_dropout,
        learning_rate=ns.learning_rate, max_steps=ns.stop_after_n_steps,
        per_device_train_batch_size=ns.per_device_train_batch_size,
        gradient_accumulation_steps=ns.gradient_accumulation_steps,
        logging_steps=ns.logging_steps, save_steps=ns.save_steps,
        eval_steps=ns.eval_steps, bf16=ns.bf16, fsdp=ns.fsdp, seed=ns.seed)
    loader = DataLoader(train_rows, args.per_device_train_batch_size,
                        collator(ns.seed), shuffle=True, seed=ns.seed,
                        drop_last=True)
    trainer = Trainer(model, args, loader, eval_fn=eval_fn)
    trainer.train()
    trainer.save_model(ns.output_dir)
    if eval_fn is not None:
        results = eval_fn(trainer.trainable, trainer.step)
        if is_first_worker():
            os.makedirs(ns.output_dir, exist_ok=True)
            with open(os.path.join(ns.output_dir, "eval_results.json"),
                      "w") as f:
                json.dump(results, f, indent=2)
            print(json.dumps({"final_eval": results}), flush=True)
    if not joined and dist.is_initialized():
        dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
