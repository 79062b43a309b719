"""What the benchmark drivers share: the card's name, the stderr log, the
one-line emitter, the correctness record, the depth-2 timing loop, the
closed-loop client ladder (the loop ``bench_serving.py`` ``run_ladder``,
``bench_text.py`` and ``bench_serving_zipf.py`` each repeat), the stand-in
tokenizer, the random Llama-3.2-1B-architecture sparse encoder, and the
model FLOPs of a training micro step beside the card's dense bf16 peak."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.utils.utils import depth2_pipeline

BF16_OPS_PER_S = 989e12       # H100 SXM data sheet, dense bf16 tensor cores


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them;
    "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[dev.index or 0]


def device(name: str) -> torch.device:
    """The driver's device; "cuda" without a card raises (a measurement
    never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to rehearse "
                           "this driver on the CPU")
    return dev


def parser(doc: str, topk: Optional[int] = None) -> argparse.ArgumentParser:
    """The drivers' flags; ``topk`` adds ``--topk`` with that default."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    if topk is not None:
        ap.add_argument("--topk", type=int, default=topk,
                        help="results per query")
    return ap


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launches() -> dict:
    """The kernel launch counts so far (``ops/cuda_lib.LAUNCHES``)."""
    from scaling_retriever_tpu_torch.ops import cuda_lib

    return dict(cuda_lib.LAUNCHES)


def since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in launches().items()}


class Checks:
    """The run's correctness record: each check that raises
    ``AssertionError`` is logged and marks the run incorrect."""

    def __init__(self):
        self.failed: list[str] = []

    def run(self, label: str, fn: Callable[[], None]) -> None:
        try:
            fn()
        except AssertionError as e:
            self.failed.append(label)
            log(f"MISMATCH {label}: {str(e)[:2000]}")
        else:
            log(f"check passed: {label}")

    @property
    def ok(self) -> bool:
        return not self.failed


def emit(line: dict, checks: Checks, out: Optional[str]) -> int:
    """Print the driver's JSON line last on stdout (and to ``out``);
    returns the exit code: 0, or 1 after a mismatch."""
    line = dict(line, correct=checks.ok)
    if checks.failed:
        line["failed_checks"] = checks.failed
    text = json.dumps(line)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if checks.ok else 1


def positive(ids, scores) -> tuple[np.ndarray, np.ndarray]:
    """The entries of a top-k list whose score is finite and positive
    (a matched doc), ids as int64."""
    ids = np.asarray(ids, np.int64)
    scores = np.asarray(scores, np.float32)
    keep = np.isfinite(scores) & (scores > 0)
    return ids[keep], scores[keep]


def engine_topk(engine, query, topk: int) -> tuple[np.ndarray, np.ndarray]:
    """A segsort-protocol engine's own one-query tile over ``query`` =
    (terms, vals): (rows, scores) of its matched docs."""
    terms, vals = query
    qt = np.zeros((1, max(engine.T, len(terms))), np.int32)
    qv = np.zeros(qt.shape, np.float32)
    qt[0, :len(terms)] = terms
    qv[0, :len(vals)] = vals
    s, r = engine.finalize(engine.retrieve_tile_async(
        None, topk, sparsified=(qt, qv)))
    return positive(r[0], s[0])


def timed(items, dispatch, drain, dev: torch.device) -> float:
    """Seconds for ``depth2_pipeline`` over ``items``: tile i+1 dispatched
    before tile i's host read, as the offline driver runs."""
    sync(dev)
    t0 = time.perf_counter()
    depth2_pipeline(items, dispatch, drain)
    sync(dev)
    return time.perf_counter() - t0


def server_counters(server) -> Callable[[], dict]:
    """Cumulative counters of a ``RetrievalServer`` for ``closed_loop``."""
    def read() -> dict:
        with server._lock:
            return {"batches": server.n_batches,
                    "batched": sum(server.batch_sizes),
                    "n_cost_splits": server.n_cost_splits,
                    "n_hot": server.n_hot, "n_hot_shed": server.n_hot_shed}
    return read


def closed_loop(call: Callable, pick: Callable, concurrency, seconds: float,
                counters: Optional[Callable[[], dict]] = None,
                shed: tuple = (), keep: int = 0, seed: int = 0,
                label: str = "") -> tuple[dict, dict]:
    """The closed-loop ladder: at each concurrency C, C client threads each
    keep one request in flight for ``seconds`` (``call(pick(rng, j))``,
    ``j`` the client's request count from 1, ``rng`` its own generator).
    A request that raises one of ``shed`` is counted as shed; any other
    exception fails the ladder. Returns ({C: QPS, client-side latency
    p50/p95/p99 in ms, shed count, and from ``counters`` the mean batch
    and the growth of n_cost_splits, n_hot, n_hot_shed}, {C: up to
    ``keep`` (request, result) pairs served in that window})."""
    results, samples = {}, {}
    for conc in concurrency:
        before = counters() if counters else {}
        lat = [[] for _ in range(conc)]
        n_shed = [0] * conc
        errors: list = []
        kept: list = []
        lock = threading.Lock()
        stop_t = time.perf_counter() + seconds

        def client(i):
            rng = np.random.default_rng([seed, conc, i])
            j = 0
            try:
                while time.perf_counter() < stop_t:
                    j += 1
                    req = pick(rng, j)
                    t0 = time.perf_counter()
                    try:
                        res = call(req)
                    except shed:
                        n_shed[i] += 1
                        continue
                    lat[i].append(time.perf_counter() - t0)
                    if len(kept) < keep:
                        with lock:
                            if len(kept) < keep:
                                kept.append((req, res))
            except Exception as e:   # surfaced after the join below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(conc)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        ms = np.concatenate([np.asarray(x) for x in lat]) * 1e3
        entry = {"qps": ms.size / dt, "n": int(ms.size),
                 "p50_ms": float(np.percentile(ms, 50)) if ms.size else None,
                 "p95_ms": float(np.percentile(ms, 95)) if ms.size else None,
                 "p99_ms": float(np.percentile(ms, 99)) if ms.size else None,
                 "n_shed": sum(n_shed)}
        if counters:
            after = counters()
            batches = after["batches"] - before["batches"]
            entry["mean_batch"] = ((after["batched"] - before["batched"])
                                   / batches if batches else 0.0)
            for k in ("n_cost_splits", "n_hot", "n_hot_shed"):
                if k in after:
                    entry[k] = after[k] - before[k]
        log(f"{label}concurrency {conc}: {json.dumps(entry)}")
        results[conc] = entry
        samples[conc] = kept
    return results, samples


class StandInTokenizer:
    """Texts of words "w<id>" → token id = id mod vocab, padded on the left,
    or on the right with ``padding_side="right"`` as T5 pads (the stand-in
    for the Llama-3 and T5 tokenizers, whose files are not in the
    repository). ``tok(texts, length=None)`` pads to ``length`` or to the
    smallest length rung that holds the batch and returns (ids, mask), as
    the text frontend calls it; with Hugging Face keywords
    (``max_length``, ``padding``, ...) it answers that protocol instead,
    as the data collators call it."""

    pad_token_id = 0
    bos_token_id = eos_token_id = unk_token_id = mask_token_id = None

    def __init__(self, vocab: int, lengths=(16, 64),
                 padding_side: str = "left"):
        self.vocab = vocab
        self.lengths = tuple(lengths)
        self.padding_side = padding_side   # "right" for T5

    def convert_tokens_to_ids(self, tokens):
        """"w<id>" → its id; "_" (MNTP's blank mask token) → the last."""
        return [self.vocab - 1 if t == "_" else int(t[1:]) % self.vocab
                for t in tokens]

    def __call__(self, texts, length=None, *, truncation=False,
                 max_length=None, padding=None, pad_to_multiple_of=None,
                 return_attention_mask=True, add_special_tokens=None):
        toks = [[int(w[1:]) % self.vocab for w in t.split()] for t in texts]
        hf = (max_length is not None or padding is not None
              or add_special_tokens is not None)
        if hf and not padding:
            # unpadded rows, as MNTP's grouping and line-by-line modes ask
            if truncation and max_length is not None:
                toks = [t[:max_length] for t in toks]
            return {"input_ids": toks,
                    "attention_mask": [[1] * len(t) for t in toks]}
        if hf:
            if truncation and max_length is not None:
                toks = [t[:max_length] for t in toks]
            length = (max_length if padding == "max_length"
                      else max(len(t) for t in toks))
            if pad_to_multiple_of:
                length = -(-length // pad_to_multiple_of) * pad_to_multiple_of
        elif length is None:
            need = max(len(t) for t in toks)
            length = next(r for r in self.lengths if r >= need)
        ids = np.zeros((len(texts), length), np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, t in enumerate(toks):
            t = t[:length]
            at = (slice(0, len(t)) if self.padding_side == "right"
                  else slice(length - len(t), length))
            if t:
                ids[i, at] = t
                mask[i, at] = 1
        if hf:
            return {"input_ids": ids, "attention_mask": mask}
        return ids, mask


def sparse_encoder(dev: torch.device, seed: int, overrides=None):
    """The published Llama-3.2-1B architecture as ``LlamaBiSparse`` with
    random bf16 weights from ``seed``; ``overrides`` replaces config.json
    fields (a depth or width cut)."""
    from scaling_retriever_tpu_torch.models.config import (LLAMA_3_2_1B,
                                                           ModelConfig)
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
    from scaling_retriever_tpu_torch.models.weights import random_params

    cfg = ModelConfig.from_hf_config(dict(LLAMA_3_2_1B, **(overrides or {})),
                                     dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16)
    return LlamaBiSparse(random_params(cfg, seed, dev), cfg)


def model_flops(cfg, groups, lm_head: bool, remat: bool) -> float:
    """Model FLOPs of one micro step over ``groups`` of (rows, tokens):
    the layers' projections and attention products, and the LM head, each
    forward and backward to the activations (the base is frozen; the LoRA
    factors' own products, under 1%, are left out); full remat runs the
    layers' forward once more."""
    h, q, kv, i = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                   cfg.intermediate_size)
    layers = head = 0
    for rows, seq in groups:
        layers += 2 * rows * seq * cfg.num_hidden_layers * (
            2 * h * q + 2 * h * kv + 3 * h * i + 2 * seq * q)
        head += 2 * rows * seq * cfg.vocab_size * h if lm_head else 0
    return layers * (3 if remat else 2) + head * 2
