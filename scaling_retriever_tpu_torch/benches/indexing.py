"""The indexing pipeline's throughput on one card (the port's counterpart of
``bench_indexing.py``): encode, nonzero extraction, CSR build and save.

    python3 -m scaling_retriever_tpu_torch.benches.indexing [--batches 100]
        [--device cpu]

The encoder is Llama-3.2-1B's published architecture with random bf16
weights from ``--seed`` (throughput does not depend on the weights),
wrapped so that each rep keeps its top 128 entries on the device inside
the encode (``SparsifiedEncoder``): the doc sparsity of a trained
SPLADE-style model (MSMARCO's 1.13B postings over 8.8M docs), which
random weights do not give. Docs are 192 random token ids (the reference's
doc_max_length), 64 a batch, ``--batches`` batches (6,400 docs at the
default 100).

Two arms over the same batches, each through ``index/indexer.py``
``SparseIndexer`` (batch i+1 encoded while batch i is read and appended)
and then saved into a temporary directory:
  * ``full``: the reference's [64, 128,256] f32 read of each batch;
  * ``packed``: the top-1024 packed read (``device_sparsify_t=1024``,
    [64, 2049] a batch, exact through its count column and the full-read
    fallback).
Both must build the same index (offsets and rows equal, values within
rtol 1e-6). The path runs no kernel of the port: the encoder, then
``torch.topk``.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import common
from scaling_retriever_tpu_torch.index.indexer import (SparseIndexer,
                                                       _pack_sparse_topk)

SEQ = 192               # the reference's doc_max_length for MSMARCO
BZ = 64
L0_DOC = 128            # postings kept a doc
T_PACK = 1024           # the CLI's default --index_sparsify_t
MODEL: dict = {}        # config.json overrides (a depth or width cut)


class SparsifiedEncoder:
    """A sparse encoder whose reps keep only their top ``l0`` entries (the
    rest 0, negative kept values clamped to 0), computed on the device in
    the same call as the forward."""

    def __init__(self, model, l0: int):
        self.model = model
        self.l0 = l0
        self.vocab_size = model.vocab_size

    def encode(self, input_ids, attention_mask) -> torch.Tensor:
        reps = self.model.encode(input_ids, attention_mask)       # [bz, V]
        vals, terms = torch.topk(reps, self.l0, dim=1)
        return torch.zeros_like(reps).scatter_(1, terms, vals.clamp_min(0.0))


def make_batches(seed: int, vocab: int, n: int) -> list:
    """bench_indexing.py's batches: ids from ``default_rng(seed)`` in its
    order, full masks, doc ids "d<row>"."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(4, vocab, (BZ, SEQ)).astype(np.int32),
             "attention_mask": np.ones((BZ, SEQ), np.int32),
             "ids": [f"d{b * BZ + i}" for i in range(BZ)]}
            for b in range(n)]


def main(argv=None) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("--batches", type=int, default=100,
                    help=f"batches of {BZ} docs an arm")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    card_s = common.card(dev)
    common.log(f"device {dev}, card {card_s}, torch {torch.__version__}")
    before = common.launches()
    checks = common.Checks()

    t0 = time.perf_counter()
    enc = common.sparse_encoder(dev, args.seed, MODEL)
    cfg = enc.config
    model = SparsifiedEncoder(enc, L0_DOC)
    common.sync(dev)
    common.log(f"encoder ({cfg.num_hidden_layers} layers x "
               f"{cfg.hidden_size}, vocab {cfg.vocab_size}, bf16) on the "
               f"device in {time.perf_counter() - t0:.1f} s")
    batches = make_batches(args.seed, cfg.vocab_size, args.batches)
    n_docs = len(batches) * BZ

    t0 = time.perf_counter()
    for _ in range(4):
        reps = model.encode(batches[0]["input_ids"],
                            batches[0]["attention_mask"])
        float(reps[0, 0])
    for _ in range(4):
        float(_pack_sparse_topk(reps, T_PACK)[0, 0])
    common.log(f"encode warm in {time.perf_counter() - t0:.1f} s")

    arms, indexes = {}, {}
    with tempfile.TemporaryDirectory(prefix="bench_indexing_") as tmp:
        for name, t_pack in (("full", 0), ("packed", T_PACK)):
            ix = SparseIndexer(model, None, dim_voc=cfg.vocab_size,
                               device_sparsify_t=t_pack)
            t0 = time.perf_counter()
            out = ix.index(batches)
            dt = time.perf_counter() - t0
            t1 = time.perf_counter()
            out["index"].save(f"{tmp}/{name}")
            save_s = time.perf_counter() - t1
            arms[name] = {"psg_per_s": n_docs / dt, "pipeline_s": dt,
                          "save_s": save_s,
                          "fallback_batches": ix.n_fallback_batches,
                          "l0_d": out["stats"]["L0_d"]}
            indexes[name] = out["index"]
            common.log(f"[{name}] {n_docs} docs in {dt:.2f} s -> "
                       f"{n_docs / dt:.1f} psg/s (save {save_s:.2f} s, "
                       f"fallbacks {ix.n_fallback_batches}, L0_d "
                       f"{out['stats']['L0_d']:.1f})")

    def same():
        a, b = indexes["full"], indexes["packed"]
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.doc_rows, b.doc_rows)
        np.testing.assert_allclose(a.values, b.values, rtol=1e-6)

    checks.run("the packed read builds the full read's index (rtol 1e-6)",
               same)
    packed = arms["packed"]["psg_per_s"]
    return common.emit({
        "metric": "indexing_psg_per_s_1b",
        "value": packed,
        "unit": (f"passages/sec through the indexing pipeline (encoder "
                 f"{cfg.num_hidden_layers} layers x {cfg.hidden_size} bf16, "
                 f"seq {SEQ}, batch {BZ}, {L0_DOC} postings a doc, packed "
                 f"top-{T_PACK} read, CSR build, {n_docs} docs, one card; "
                 f"full-read arm {arms['full']['psg_per_s']:.1f})"),
        "vs_baseline": packed / arms["full"]["psg_per_s"],
        "baseline": {"what": "the full [bz, V] read on the same batches",
                     "psg_per_s": arms["full"]["psg_per_s"]},
        "card": card_s, "device": str(dev), "arms": arms,
        "launches": common.since(before),
        "kernels": "none: the path runs the encoder, then torch.topk",
    }, checks, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
