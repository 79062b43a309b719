"""Smoke run of the torch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):
  1. build the CUDA kernels from scaling_retriever_tpu_torch/csrc with nvcc
     for sm_90a;
  2. generate two indexes on the card: an MSMARCO-scale uniform index
     (8,841,823 docs, 128 postings per doc, vocab 128,256: 1,131,730,944
     postings) in the f32, bf16-pair and q8 layouts, and bench_bmx.py's
     clustered corpus (8,849,850 docs in 1,024 topic clusters,
     887,226,368 postings, f32) with its block-max meta; hold each kernel
     against its plain PyTorch version at the main path's shapes (64
     queries x 512 jobs of 1024, or 384 jobs of 2048 for bf16; the
     block-max site on a real pass-1 job table), timing kernel, plain
     version and, where one exists, a single PyTorch call computing the
     same function; B5 also on tied, signed-zero and all -inf blocks and
     over its (m, block) range, and timed on a slab of ties;
  3. run 64-query tiles through SegsortEngine on the three layouts and
     compare the kernel path's top-1000 with the plain path's (tie-equal;
     bf16 also with the f32 engine), a small index against a brute-force
     oracle, and the block-max engine (two passes, staged pipeline)
     against the unpruned engine on the clustered corpus;
  4. serve through RetrievalServer, each path with the launch counts set
     to 0 just before it and read just after it: text through the
     published Llama-3.2-1B architecture (random bf16 weights from --seed)
     with QueryEncoderFrontend on the q8 index (device handoff) plus
     pre-encoded requests on the f32 index; pre-encoded requests on the
     bf16 index; pre-encoded requests on the block-max engine;
  5. the offline evaluation path from host copies of both corpora, each
     engine built, run, checked and freed in turn: SparseRetrieval over a
     Dev-size stream (6,980 pre-encoded 48-term queries) on the f32, bf16
     and q8 layouts (against the plain-ops engine and each other), 64
     texts at Llama-3.2-1B width through the hot doc-major route (against
     retrieve_doc_major, a term-major scorer and the "xla" engine; the
     scan timed beside its earlier gather formulation), the hot route on
     stream queries, fetch="gather", the block-max and maxscore engines
     on the clustered corpus (against "segsort"; B1, B4 and B5 against
     their plain versions at maxscore's prefix slab), eval_sparse's
     retrieval (on a depth-cut copy saved to disk, with --passes 2;
     maxscore, certified there, against it) and evaluate_msmarco (on the
     f32 run.json, against the metrics of the plain path's run), each
     offline path's launch counts read as in 4;
  6. the dense path: 8,841,823 L2-normalized 2048-wide bf16 rows made on
     the card into a DenseFlatIndexer; B5 at its dense shape ([256,
     262,144], block 4096, m 32) against its plain version; a Dev-size
     stream (6,980 noisy copies of docs, k 1000) through search_knn's
     blocked path against the direct path; a forced certificate failure;
     the int8 layout on 1,024 queries against its code-exact direct path;
     128 vectors served (RetrievalServer + DenseTileBackend, then
     serve_http); 64 texts through LlamaBiDense at Llama-3.2-1B width and
     eval_dense's write_doc_embeds, retrieval and evaluate_msmarco over
     2,048 stand-in docs; the server CLI in subprocesses over a
     serialized 65,536-doc cut and over phase 5's sparse cut (C++ hot
     lane), each on the port the system picks, answers against the
     in-process index and engine; then the corpus again as one f32 host
     array through add_batch, as the file-based entry points add it: the
     store stays on the host, the card holds only the bf16 and then the
     int8 layout, and a tile answers as the card-built index did; launch
     counts read as in 4;
  7. the offline pipeline from a checkpoint on disk: phase 4's encoder
     written with save_pretrained (2.47 GB bf16 safetensors) and read back
     with load_pretrained, bit-equal; an r 16 adapter written with
     save_adapter, loaded with load_from_lora and merged (merged reps ==
     unmerged within a stated bf16 tolerance; the merge's source object
     encodes as the merged one); eval_sparse's indexing body over 16,384
     generated docs at doc_max_length 192 (the model's reps kept to their
     top 128 per doc on the card), through the packed top-1024 read and
     the full read (bit-equal indexes), and one batch of the unwrapped
     model through the fallback (== its full read); encode_queries,
     retrieval from the reps file and from text (1,024 doc-prefix
     queries) into run.json through B1, B4 and B5 (launches read as in
     4; == the plain-ops engine), evaluate_msmarco; SparseIndex's host CSR
     build at 1/8 of MSMARCO's depth (141M postings); a 4-chunk dense
     index streamed to disk by serialize (host memory growth under two
     chunks) and read back (a tile bit-equal);
  8. training at Llama-3.2-1B width (phase 4's weights, written to disk
     and trained from there): sparse NCE with LoRA through train_sparse's
     body and the Trainer at the reference recipe's micro batch (8
     queries x 17 contexts, 64 / 128 tokens, r 16, dropout 0.1), timed,
     profiled, and learning on one fixed batch; remat full against none
     (the same LoRA gradients, dropout on); two accumulated optimizer
     steps, a checkpoint and a resumed step against an uninterrupted run
     (bit-equal); the trained adapter written, merged by load_from_lora,
     indexing generated docs and answering queries into run.json through
     B1, B4 and B5 (launches read as in 4; == the plain-ops engine); dense
     NCE through train_dense's body; MNTP through its CLI body at
     configs/mntp/llama3_1b_msmarco.json's batch (32 x 512) under full
     remat;
  9. hybrid retrieval, reranking and the T5 family: LlamaBiHybrid (phase
     8's checkpoint) through HybridIndexer over 4,096 generated docs and
     HybridRetriever (engine "segsort") for 1,024 queries into
     sparse/run.json (== the "xla" engine and the plain-ops engine) and
     dense/run.json (== the direct search); TermEncoderRetriever over
     262,144 32-term codes (== a plain chunked top-k); eval_reranker's
     bi-encoder body for splade, dense_encoder and hybrid_retriever over
     64 x 32 pairs of the sparse run (each score == the dot product of
     the pair's reps); T5 at google/t5-v1_1-base width (random bf16
     weights written as an HF checkpoint) trained with LoRA through
     train_sparse's body (--model_type t5) at the 1B recipe's micro batch,
     learning on one fixed batch, its peft T5 adapter reloaded and merged,
     indexing 4,096 docs and answering 256 right-padded queries into
     run.json through B1, B4 and B5 (== the plain-ops engine); launch
     counts read as in 4;
 10. the sharded entry points, on meshes whose entries repeat the one
     card: (a) after phase 5, over its host index split by
     shard_by_rows into 4 shards, SparseRetrieval(mesh=) on the segsort
     engine over the Dev-size stream (f32; against phase 5's single
     engine: scores bit-equal, ids tie-equal), q8 and bf16 engines from
     the same split on 1,024 queries, one tile of every shard against
     the plain-ops sharded engine, 128 requests served through
     RetrievalServer, the sharded "xla" scan on phase 5's texts, and
     eval_sparse --use_mesh (the one-device path on one card: the same
     run.json); (b) inside phase 6, the bf16 store as 4 row-range views
     through make_sharded_dense_search against the direct search (1,024
     queries, k 1000), the int8 codes on a cut (bit-equal), and
     MeshDenseRetriever against LocalDenseRetriever over 65,536 rows
     written as embedding files; (c) inside phase 8, the Trainer two
     steps at the recipe's micro batch on a (data 4, fsdp) and a (data
     2, model 2) mesh, losses bit-equal to a one-entry mesh; (d) inside
     phase 8 too, the distributed Trainer (torch.distributed, an NCCL
     world of 1 on the card, a file:// rendezvous, a (1, 1) DeviceMesh,
     fsdp on, LoRA dropout 0.1) two optimizer steps of two micro steps at
     the recipe's micro batch: losses and factors bit-equal to the
     single-process Trainer's, micro step time and peak memory beside
     its; the process group destroyed after; launch counts read as in 4;
 11. the power-law index and skewed serving traffic (after the earlier
     phases' memory is freed): bench_zipf.py's index (8,841,823 docs,
     1,064,158,464 postings in 13 dyadic bands) made on the card through
     benches.corpora; bench_serving_zipf.py's server (width rungs 8 to 64,
     a 32,768-slot tile envelope, reorder horizon 8, ZipfHostLane as the
     hot lane over 8,192 jobs a query) serving its mix (a pool calibrated
     to 425,000 matched postings, every 32nd request of a client from the
     hot pool) for 2 s at each of concurrency 8 and 128: cost splits, hot
     queries and a mean batch above 1 at 128 are required, and a sample of
     fast-lane and hot-lane results served after the ladder equals
     ZipfHostLane and the engine (tie-equal); then 2 maxscore tiles (the
     4,096-deep prefix, the rescore and its certificate, the doc-major
     fallback): the certified rows, the results and the scan against the
     full-CSR segsort; launch counts read as in 4;
 12. the routed-expert kernels (csrc/moe.cu: route, the grouped gate/up
     and down products, the combine) at DeepSeek-V2-Lite's widths (hidden
     2,048, 64 experts of width 1,408, top-6) and the text cell's tiles (8
     and 64 texts of 64 positions) under random and pad-like routing, each
     against its plain version (the products also launched twice, bit for
     bit) and timed beside its bound, its plain version and
     torch._grouped_mm (the products' yardstick, never called by the
     port); the same at Kimi-Linear's widths (hidden 2,304, width 1,024,
     top-8 of the router's 256) over a held share (experts 64-127): route
     bit for bit over the present slots, the absent slots counted and
     left out of the combine; then
     DeepSeek-V2-Lite whole at its published widths (15.7B parameters,
     random bf16 weights, ~31 GB) encoding an 8 x 64 and a 64 x 64 tile
     eagerly through DeepseekV2BiSparse.encode: each tile's launch counts
     read from 0 (one of each moe_* kernel per MoE layer, 26 a tile) and
     its expert-load counter (every position's 6 slots in each MoE layer);
 13. the attention kernel (csrc/attention.cu: rope, GQA attention and
     P.V in one launch) at Mistral-7B's text tile (64 x 64, 32 / 8 heads
     of 128), Qwen2-1.5B's (64 x 16 and 8 x 16, 12 / 2 heads of 128) and
     the smoke's Llama-3.2-1B's (TILE x 16 and TILE x 64, 32 / 8 heads of
     64, llama3 rope scaling) under left-padded masks, against its plain
     version (apply_rope then attention), launched twice bit for bit, and
     timed beside its bound, its plain version and
     F.scaled_dot_product_attention over pre-roped inputs (the yardstick,
     never called by the port), all three replayed from CUDA graphs; each
     tile's launches read from 0 over an eager encode of that tile through
     its configuration's whole model (random bf16 weights): once a layer;
 14. the Kimi Delta Attention kernel (csrc/kda.cu: convolutions, norms,
     decay, the gated delta rule's recurrence and the gated output norm in
     one launch a layer) at Kimi-Linear's widths (32 heads of 128) and the
     text tiles (8 and 64 texts of 64 positions, one text left-padded)
     against its plain steps in float32, element by element, launched
     twice bit for bit, and timed beside its bound and its plain version
     (no library computes it); then Kimi-Linear-48B-A3B whole at its
     published widths with 64 of each MoE layer's 256 experts held (13.8B
     parameters, random bf16 weights, ~28 GB) encoding an 8 x 64 and a
     64 x 64 tile eagerly through KimiLinearBiSparse.encode: each tile's
     launch counts read from 0 (the KDA kernel once a KDA layer, 20 a
     tile; one of each moe_* kernel per MoE layer, 26 a tile) and its
     expert counters (every position's 8 slots in each MoE layer, held or
     absent, some of each);
 15. print the card, per-kernel numbers as one JSON line, and last
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from scaling_retriever_tpu_torch.benches import bmx as bmx_bench
from scaling_retriever_tpu_torch.benches import corpora
from scaling_retriever_tpu_torch.benches.common import (BF16_OPS_PER_S,
                                                        StandInTokenizer,
                                                        card, model_flops,
                                                        sparse_encoder)
from scaling_retriever_tpu_torch.benches.corpora import (clustered_index,
                                                         cross_check,
                                                         make_cfg, make_tiles)

N_DOCS = 8_841_823
K_PER_DOC = 128
VOCAB = 128_256
L0_Q = 48
TILE = 64
T_BUDGET = 64
TOPK = 1000
JOBS = 512
JOBS2 = 384                   # bf16 bucket of a 48-term tile (2048-jobs)
CHUNK = 1024
CHUNK2 = 2048
BMX_COVER = 4.0               # block-max pass 1 covers BMX_COVER * TOPK docs
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM data sheet, non-tensor f32
BENCH_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "retrieval_bench", "configs")


MOE_KERNELS = ("moe_route", "moe_expert_up", "moe_expert_down",
               "moe_combine")
# the kernels each serving path (phase 4), offline path (phase 5), dense
# path (phase 6), checkpoint and training path (phases 7, 8), hybrid and
# T5 path (phase 9), sharded path (phase 10a), power-law path (phase 11)
# and DeepSeek-V2 and Kimi-Linear tiles (phases 12, 14) must launch;
# topm_dense is B5 at its
# dense site. The served text tiles replay CUDA graphs, which launch
# nothing from the host: the attention kernel's launches there are those
# of the captures' warm-up ("text tile captures")
PATH_KERNELS = {
    "text q8 + pre-encoded f32": ("fetch_f32", "fetch_q8", "segsum", "topm"),
    "text tile captures": ("rope_attention",),
    "pre-encoded bf16": ("fetch_bf16", "segsum", "topm"),
    "pre-encoded block-max": ("fetch_f32_blockmax", "segsum", "topm"),
    "offline f32": ("fetch_f32", "segsum", "topm"),
    "offline bf16": ("fetch_bf16", "segsum", "topm"),
    "offline q8": ("fetch_q8", "segsum", "topm"),
    "offline block-max": ("fetch_f32_blockmax", "segsum", "topm"),
    "offline maxscore": ("fetch_f32", "segsum", "topm"),
    "dense bf16": ("topm_dense",),
    "dense int8": ("topm_dense",),
    "served dense": ("topm_dense",),
    "checkpoint pipeline": ("fetch_f32", "segsum", "topm"),
    "trained adapter": ("fetch_f32", "segsum", "topm"),
    "hybrid sparse": ("fetch_f32", "segsum", "topm", "rope_attention"),
    "hybrid dense": ("topm_dense",),
    "t5 trained adapter": ("fetch_f32", "segsum", "topm"),
    "sharded f32": ("fetch_f32", "segsum", "topm"),
    "served sharded": ("fetch_f32", "segsum", "topm"),
    "sharded q8": ("fetch_q8", "segsum", "topm"),
    "sharded bf16": ("fetch_bf16", "segsum", "topm"),
    "served zipf": ("fetch_f32", "segsum", "topm"),
    "zipf maxscore": ("fetch_f32", "segsum", "topm"),
    "deepseek 8x64 tile": MOE_KERNELS,
    "deepseek 64x64 tile": MOE_KERNELS,
    "kimi 8x64 tile": MOE_KERNELS + ("kda",),
    "kimi 64x64 tile": MOE_KERNELS + ("kda",),
}


def log(*a) -> None:
    print(*a, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb, to = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def gen_index(dev):
    """bench.py's synthetic CSR at this script's sizes, on the card, padded
    by CHUNK2 so the f32 and bf16 engines share the rows
    (``benches.corpora.gen_index``). Returns (rows i32, valbits i32, bf16
    pairs i32, packed q8 i32, host offsets, host scales, nnz)."""
    return corpora.gen_index(dev, N_DOCS, K_PER_DOC, VOCAB)


def varied_pairs(n_words: int, dev) -> torch.Tensor:
    """bf16 pair words whose two values differ from posting to posting:
    hash(word) -> two bf16 values in [0.5, 2) (half bits 0x3F00 + byte), so
    a swap of the halves would change every word."""
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    step = 1 << 27
    for s in range(0, n_words, step):
        i = torch.arange(s, min(s + step, n_words), dtype=torch.int64,
                         device=dev)
        h = (i * 2654435761) & 0xFFFFFFFF
        h = h ^ (h >> 15)
        lo = 0x3F00 + (h & 0xFF)
        hi = 0x3F00 + ((h >> 8) & 0xFF)
        out[s:s + len(i)] = (lo | (hi << 16)).to(torch.int32)
    return out


def make_bmx(csr, meta, cfg, **kw):
    from scaling_retriever_tpu_torch.ops.blockmax import BlockMaxSegsortEngine

    return BlockMaxSegsortEngine(None, topk=TOPK, query_terms_budget=32,
                                 cover=BMX_COVER, gate=0.85, meta=meta,
                                 device_csr=csr, **kw)


def run_stream(eng, tiles, staged: bool):
    """All tiles through ``eng`` at TOPK (``benches.bmx.run_stream``: the
    staged pipeline for the two-pass engine, depth 2 otherwise), ending in
    a host read. Returns (scores, rows) concatenated."""
    return bmx_bench.run_stream(eng, tiles, TOPK, staged)[:2]


def query_tiles(rng, n):
    out = []
    for _ in range(n):
        qt = rng.integers(0, VOCAB, (TILE, T_BUDGET)).astype(np.int32)
        qv = rng.uniform(0.1, 2.0, (TILE, T_BUDGET)).astype(np.float32)
        qv[:, L0_Q:] = 0.0
        out.append((qt, qv))
    return out


def kernel_phase(dev, eng_f32, eng_q8, eng_bf16, tile, card_s):
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns the per-kernel report entries (launches filled later)."""
    from scaling_retriever_tpu_torch.ops import fetch, segsum, topm

    qt, qv = (torch.from_numpy(a).to(dev) for a in tile)
    qt, order = torch.sort(qt, dim=1, stable=True)
    qv = qv.gather(1, order)
    n_flat = eng_f32.rows_flat.shape[0]
    src, jvs, jve, jqv, total = fetch.job_table(qt, eng_f32.offsets, qv,
                                                JOBS, n_flat)
    scales = torch.from_numpy(eng_q8._host_scales).to(dev)
    qv8 = qv * scales[qt.long()]
    t8 = fetch.job_table(qt, eng_q8.offsets, qv8, JOBS, n_flat)[:4]
    valid = int(total.sum())
    check(int(eng_f32.job_need(*tile).max()) <= JOBS,
          "tile overflows the job table")
    slots = TILE * JOBS * CHUNK
    sent = N_DOCS
    report = []

    # B1 / B2: bit-equal (rows >= 2^23 are on this index: N_DOCS > 2^23)
    f32_args = (eng_f32.rows_flat, eng_f32.valbits_flat, src, jvs, jve, jqv,
                JOBS, sent)
    got = fetch.fetch_jobs(*f32_args)
    want = fetch.fetch_jobs_plain(*f32_args)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "B1 fetch kernel != plain")
    check(N_DOCS <= 1 << 23 or int((got[0][got[0] != sent] >= 1 << 23)
                                   .sum()) > 0,
          "no rows >= 2^23 in the checked tile")
    q8_args = (eng_q8.rows_flat, *t8, JOBS, sent)
    got8 = fetch.fetch_jobs_q8(*q8_args)
    want8 = fetch.fetch_jobs_q8_plain(*q8_args)
    check(torch.equal(got8[0], want8[0]) and torch.equal(got8[1], want8[1]),
          "B2 q8 fetch kernel != plain")
    check(torch.equal(got8[0], got[0]), "q8 rows != f32 rows")
    # B3 at its full shape, on pair words whose values differ per posting
    check(int(eng_bf16.job_need(*tile).max()) <= JOBS2,
          "tile overflows the bf16 job table")
    t2 = fetch.job_table(qt, eng_bf16.offsets, qv, JOBS2, n_flat, CHUNK2)
    valid2 = int(t2[4].sum())
    check(valid2 == valid, "bf16 and f32 job tables cover other postings")
    pairs = varied_pairs(eng_bf16.valbits_flat.shape[0], dev)
    bf16_args = (eng_bf16.rows_flat, pairs, *t2[:4], JOBS2, sent)
    got2 = fetch.fetch_jobs_bf16(*bf16_args)
    want2 = fetch.fetch_jobs_bf16_plain(*bf16_args)
    check(torch.equal(got2[0], want2[0]) and torch.equal(got2[1], want2[1]),
          "B3 bf16 fetch kernel != plain")
    w = pairs[:1 << 20]
    check(float(((w & 0xFFFF) != (w >> 16)).float().mean()) > 0.9,
          "B3 check ran on pairs whose two halves are mostly equal")
    del got2, want2
    for name, fn, plain, args, post_bytes, slots_k, jobs_k, src_file, \
            line in (
            ("fetch_f32", fetch.fetch_jobs, fetch.fetch_jobs_plain, f32_args,
             8, slots, TILE * JOBS, "fetch.cu",
             "scaling_retriever_tpu/ops/pallas_fetch.py:54"),
            ("fetch_q8", fetch.fetch_jobs_q8, fetch.fetch_jobs_q8_plain,
             q8_args, 4, slots, TILE * JOBS, "fetch.cu",
             "scaling_retriever_tpu/ops/pallas_fetch.py:137"),
            ("fetch_bf16", fetch.fetch_jobs_bf16, fetch.fetch_jobs_bf16_plain,
             bf16_args, 6, TILE * JOBS2 * CHUNK2, TILE * JOBS2, "fetch.cu",
             "scaling_retriever_tpu/ops/pallas_fetch.py:94")):
        b_ms, b_by = bound(jobs_k * 20 + valid * post_bytes + slots_k * 8,
                           valid)
        report.append({
            "name": name, "route": "cuda",
            "source": f"scaling_retriever_tpu_torch/csrc/{src_file}",
            "replaces": line, "launches": 0, "max_abs_err": 0.0,
            "ms": time_ms(lambda: fn(*args), 20),
            "plain_ms": time_ms(lambda: plain(*args), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    del pairs, bf16_args

    # B4: the sorted slab of this tile
    rows, contrib = got[0].view(TILE, -1), got[1].view(TILE, -1)
    srow, perm = torch.sort(rows, dim=1)
    sc = contrib.gather(1, perm)
    P = srow.shape[1]
    out = segsum.segsum_mask(srow, sc, sent, T_BUDGET)
    ref = segsum.segsum_mask_plain(srow, sc, sent, T_BUDGET)
    fin = torch.isfinite(ref)
    check(torch.equal(fin, torch.isfinite(out)), "B4 run-end mask differs")
    err = float((out[fin] - ref[fin]).abs().max())
    rel = float(((out[fin] - ref[fin]).abs() / ref[fin].abs()).max())
    check(rel <= 1e-6, f"B4 relative error {rel}")
    g = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randint(-8, 8, sc.shape, generator=g, device=dev).float() / 4
    dy = torch.where(srow == sent, 0.0, dy)
    check(torch.equal(segsum.segsum_mask(srow, dy, sent, T_BUDGET),
                      segsum.segsum_mask_plain(srow, dy, sent, T_BUDGET)),
          "B4 segsum kernel != plain on dyadic input")
    b_ms, b_by = bound(TILE * P * 12, TILE * P)
    report.append({
        "name": "segsum", "route": "cuda",
        "source": "scaling_retriever_tpu_torch/csrc/segsum.cu",
        "replaces": "scaling_retriever_tpu/ops/pallas_segsum.py:62",
        "launches": 0, "max_abs_err": err,
        "ms": time_ms(lambda: segsum.segsum_mask(srow, sc, sent, T_BUDGET),
                      20),
        "plain_ms": time_ms(
            lambda: segsum.segsum_mask_plain(srow, sc, sent, T_BUDGET), 3, 1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # B5: the segsum output, plus blocks with ties and with < m finite
    m, block = 32, 4096
    s = out.clone()
    s[:8, :4 * block] = float("-inf")
    lanes = torch.tensor([5, 9, 17, 33], device=dev)
    for b in range(4):                            # 4 tied finite values
        s[:8, b * block + lanes] = 1.0            # in each of 4 blocks
    s[8:16] = torch.round(s[8:16] * 4) / 4        # many ties
    v, i = topm.block_topm(s, m, block)
    pv, pi = topm.block_topm_plain(s, m, block)
    check(torch.equal(v, pv) and torch.equal(i, pi),
          "B5 top-m kernel != plain")
    check(bool((i[:8, :4, :4] == lanes.int()).all()
               and (i[:8, :4, 4:] == 0).all()),
          "exhausted blocks must return their lanes, then repeat lane 0")
    n_cases = topm_cases(out)
    # the same shape with every block all ties
    nblk = P // block
    ties = torch.full_like(out, 1.5)
    v, i = topm.block_topm(ties, m, block)
    pv, pi = topm.block_topm_plain(ties, m, block)
    check(torch.equal(v, pv) and torch.equal(i, pi)
          and bool((i == torch.arange(m, device=dev)).all()),
          "B5 on the tie slab != plain, or not the lowest m lanes")
    b_ms, b_by = bound(TILE * P * 4 + TILE * nblk * m * 8, TILE * P)
    report.append({
        "name": "topm", "route": "cuda",
        "source": "scaling_retriever_tpu_torch/csrc/topm.cu",
        "replaces": "scaling_retriever_tpu/ops/pallas_topm.py:35",
        "launches": 0, "max_abs_err": 0.0,
        "ms": time_ms(lambda: topm.block_topm(out, m, block), 20),
        "plain_ms": time_ms(lambda: topm.block_topm_plain(out, m, block),
                            3, 1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(
            lambda: torch.topk(out.view(TILE, nblk, block), m), 20),
        "tie_ms": time_ms(lambda: topm.block_topm(ties, m, block), 20)})
    r = report[-1]
    log(f"B5 top-m at [{TILE}, {P}], block {block}, m {m}: engine slab "
        f"{r['ms']:.4f} ms, tie slab {r['tie_ms']:.4f} ms, torch.topk "
        f"{r['library_ms']:.4f} ms, bound {b_ms:.4f} ms; == plain on the "
        f"engine slab, the tie slab and {n_cases} more slabs; card {card_s}")
    return report


def topm_cases(out) -> int:
    """B5 beyond the engine slab, kernel == plain bit for bit: 4 rows x 8
    blocks of 4096 from the engine slab with block 0 all ties (1.5), block
    1 -0.0/+0.0 alternating from lane 0, block 2 all -inf and block 3
    +0.0/-0.0 alternating with five lanes of 1.0, at m 32 and 125 (the
    engine's m at 8 blocks and k = 1000) and at m 128 with block 128 and
    16384; the whole engine slab at m 128 with block 128 and 16384.
    Returns the number of slabs checked."""
    from scaling_retriever_tpu_torch.ops import topm

    dev = out.device
    adv = out[:4, :8 * 4096].clone().view(4, 8, 4096)
    adv[:, 0] = 1.5
    adv[:, 1] = 0.0
    adv[:, 1, 0::2] = -0.0
    adv[:, 2] = float("-inf")
    adv[:, 3] = -0.0
    adv[:, 3, 0::2] = 0.0
    adv[:, 3, torch.tensor([7, 100, 2048, 3001, 4095], device=dev)] = 1.0
    adv = adv.view(4, -1)
    n = 0
    for s, m, block in ((adv, 32, 4096), (adv, 125, 4096), (adv, 128, 128),
                        (adv, 128, 16384), (out, 128, 128),
                        (out, 128, 16384)):
        v, i = topm.block_topm(s, m, block)
        pv, pi = topm.block_topm_plain(s, m, block)
        check(torch.equal(v, pv) and torch.equal(i, pi),
              f"B5 != plain at m {m}, block {block}")
        if block == 4096:
            lanes = torch.arange(m, device=dev, dtype=torch.int32)
            check(bool((i[:, 0] == lanes).all() and (i[:, 1] == lanes).all()
                       and (i[:, 2] == 0).all()
                       and torch.isneginf(v[:, 2]).all()),
                  "B5: tied, signed-zero or -inf blocks out of order")
        n += 1
    return n


def log_kernels(report, card_s) -> None:
    for r in report:
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}) per {TILE}-query tile; card {card_s}")


# an expert layer: hidden H, expert width I, E experts held (the router's
# ids FIRST .. FIRST + E - 1 of its ROUTER), top-K. DeepSeek-V2-Lite's
# holds every expert; Kimi-Linear's as one card of four holds it
MOE = {"H": 2048, "I": 1408, "E": 64, "K": 6, "ROUTER": 64, "FIRST": 0}
MOE_SHARE = {"H": 2304, "I": 1024, "E": 64, "K": 8, "ROUTER": 256,
             "FIRST": 64}
MOE_TILES = ((8, 64), (64, 64))      # (texts, positions) of the text tiles
# the routings phase 12 times: the router's spread, and the text cell's
# tiles, where about a quarter of the positions are pads that all route to
# the same 6 experts (each of them ~1,000 extra slots at 64 x 64); and the
# router's spread over a held share (MOE_SHARE)
MOE_ROUTINGS = ("random", "pad")


def moe_case(dev, n: int, g: torch.Generator, routing: str,
             spec: dict = MOE) -> dict:
    """One MoE layer's inputs for ``n`` tokens: x, a router's top-k of
    random scores over its ``ROUTER`` experts (``pad``: a quarter of the
    tokens on experts 0-5), its weights, the held experts' weights, a
    shared row."""
    h, i, e, k = spec["H"], spec["I"], spec["E"], spec["K"]

    def bf(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(
            torch.bfloat16)

    scores = torch.rand(n, spec["ROUTER"], generator=g, device=dev)
    if routing == "pad":
        scores[:n // 4, :k] += 2.0
    w, ids = torch.topk(scores.softmax(-1), k, dim=1)
    return {"x": bf(n, h), "ids": ids, "w": w.contiguous(),
            "w_gu": bf(e, 2 * i, h, std=0.02), "w_d": bf(e, h, i, std=0.02),
            "shared": bf(n, h, std=0.1)}


def moe_close(got, want, what: str) -> None:
    """bf16 results of float32 sums in another order: within two bf16
    roundings of the largest value."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    check(err <= 2 * 2 ** -8 * top, f"{what}: {err} over {top}")


def grouped_mm_ms(a, b, offs, iters: int):
    """torch._grouped_mm of the sorted rows a against b [E, K, N] (the
    library's yardstick), or its error's name where it does not run."""
    try:
        return time_ms(lambda: torch._grouped_mm(a, b, offs=offs), iters)
    except (RuntimeError, AttributeError, TypeError) as exc:
        return f"not run ({type(exc).__name__})"


def moe_phase(dev, seed: int, card_s: str) -> list:
    """Phase 12: each routed-expert kernel against its plain version at the
    text cell's tiles under each of ``MOE_ROUTINGS`` (DeepSeek-V2-Lite's
    layer) and over Kimi-Linear's held share, timed; returns per-kernel
    report entries."""
    from scaling_retriever_tpu_torch.ops import cuda_lib, moe

    g = torch.Generator(device=dev).manual_seed(seed)
    report = []
    cases = [(tile, routing, "deepseek", MOE) for tile, routing in
             itertools.product(MOE_TILES, MOE_ROUTINGS)]
    cases += [(tile, "share", "kimi", MOE_SHARE) for tile in MOE_TILES]
    for (texts, pos), routing, layout, spec in cases:
        h, i, e, k = spec["H"], spec["I"], spec["E"], spec["K"]
        first = spec["FIRST"]
        n = texts * pos
        c = moe_case(dev, n, g, routing, spec)
        absent = torch.zeros(1, dtype=torch.int64, device=dev)
        want_absent = torch.zeros_like(absent)
        r = moe.route(c["ids"], e, None, first, absent)
        want = moe.route_plain(c["ids"], e, None, first, want_absent)
        present = int(want.offsets[-1])
        check(torch.equal(r.offsets, want.offsets)
              and torch.equal(r.inv, want.inv)
              and torch.equal(r.order[:present], want.order[:present])
              and torch.equal(absent, want_absent),
              f"moe_route at {n} tokens, {routing}, differs from its plain "
              f"version")
        check((int(absent) > 0) == (first > 0 or spec["ROUTER"] > e)
              and int(absent) + present == n * k,
              f"moe_route at {n} tokens, {routing}: {int(absent)} absent "
              f"and {present} present slots of {n * k}")
        # the rows past the present slots' are unused
        hmid = moe.expert_up(c["x"], r, c["w_gu"], k)
        moe_close(hmid[:present],
                  moe.expert_up_plain(c["x"], r, c["w_gu"], k)[:present],
                  f"moe_expert_up at {n} tokens, {routing}")
        check(torch.equal(moe.expert_up(c["x"], r, c["w_gu"], k)[:present],
                          hmid[:present]),
              f"moe_expert_up at {n} tokens: two launches differ")
        y = moe.expert_down(hmid, r, c["w_d"], c["w"])
        moe_close(y[:present],
                  moe.expert_down_plain(hmid, r, c["w_d"], c["w"])[:present],
                  f"moe_expert_down at {n} tokens, {routing}")
        check(torch.equal(moe.expert_down(hmid, r, c["w_d"], c["w"])
                          [:present], y[:present]),
              f"moe_expert_down at {n} tokens: two launches differ")
        check(torch.equal(moe.combine(y, r, c["shared"], k),
                          moe.combine_plain(y, r, c["shared"], k)),
              f"moe_combine at {n} tokens differs from its plain version")
        slots = present
        rows = c["x"][r.order[:present].long() // k]
        offs = r.offsets[1:].contiguous()
        kernels = {
            "moe_route": (
                lambda: moe.route(c["ids"], e, None, first, absent),
                lambda: moe.route_plain(c["ids"], e, None, first, absent),
                None, n * k * (8 + 4) + slots * 4 + (e + 1) * 4, 0.0),
            "moe_expert_up": (
                lambda: moe.expert_up(c["x"], r, c["w_gu"], k),
                lambda: moe.expert_up_plain(c["x"], r, c["w_gu"], k),
                (rows, c["w_gu"].transpose(1, 2)),
                e * 2 * i * h * 2 + slots * (h + i) * 2,
                2.0 * slots * h * 2 * i),
            "moe_expert_down": (
                lambda: moe.expert_down(hmid, r, c["w_d"], c["w"]),
                lambda: moe.expert_down_plain(hmid, r, c["w_d"], c["w"]),
                (hmid[:present], c["w_d"].transpose(1, 2)),
                e * h * i * 2 + slots * (i + h) * 2, 2.0 * slots * i * h),
            "moe_combine": (
                lambda: moe.combine(y, r, c["shared"], k),
                lambda: moe.combine_plain(y, r, c["shared"], k),
                None, slots * h * 2 + n * k * 4 + 2 * n * h * 2, 0.0),
        }
        for name, (fn, plain, lib, nbytes, ops) in kernels.items():
            before = cuda_lib.LAUNCHES[name]
            fn()
            check(cuda_lib.LAUNCHES[name] == before + 1,
                  f"{name} was not launched")
            b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
            report.append({
                "name": name, "tile": f"{texts}x{pos}", "routing": routing,
                "layout": layout,
                "ms": time_ms(fn, 20), "plain_ms": time_ms(plain, 3, 1),
                "library_ms": (None if lib is None else
                               grouped_mm_ms(*lib, offs, 20)),
                "bound_ms": b_ms, "bound_by": b_by})
        del c, r, want, hmid, y, rows, kernels
    free()
    for x in report:
        log(f"kernel {x['name']} at {x['layout']} {x['tile']}, "
            f"{x['routing']} routing: "
            f"{x['ms']:.4f} ms (plain {x['plain_ms']:.4f} ms, library "
            f"{x['library_ms']}, bound {x['bound_ms']:.4f} ms by "
            f"{x['bound_by']}); card {card_s}")
    return report


# the attention kernel's text tiles: (configuration, texts, positions);
# the benchmark's configurations and the smoke's own encoder's, whose
# head dim (64) is another instance
ATTN_TILES = (("mistral-7b", 64, 64), ("qwen2-1.5b", 64, 16),
              ("qwen2-1.5b", 8, 16), ("llama-3.2-1b", TILE, 16),
              ("llama-3.2-1b", TILE, 64))


def attention_config(name: str):
    """The bf16 ``ModelConfig`` of an ``ATTN_TILES`` configuration: the
    benchmark's config.json under retrieval_bench/configs, or
    Llama-3.2-1B's."""
    from scaling_retriever_tpu_torch.models.config import (LLAMA_3_2_1B,
                                                           ModelConfig)

    if name == "llama-3.2-1b":
        hf = LLAMA_3_2_1B
    else:
        with open(os.path.join(BENCH_CONFIGS, f"{name}.json")) as f:
            hf = json.load(f)["model"]
    return ModelConfig.from_hf_config(hf, dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)


def attention_case(dev, cfg, texts: int, pos: int,
                   g: torch.Generator) -> tuple:
    """One layer's bf16 q, k, v (unroped) at ``cfg``'s heads, its rope
    tables and the bias of a left-padded mask (one full row, the rest half
    to full length)."""
    from scaling_retriever_tpu_torch.models import llama

    cos, sin = llama.rope_cos_sin(cfg, pos, dev)
    real = torch.randint(pos // 2, pos + 1, (texts,), generator=g,
                         device=dev)
    real[0] = pos
    mask = (torch.arange(pos, device=dev)[None, :]
            >= pos - real[:, None]).int()

    def bf(heads):
        return torch.randn(texts, pos, heads, cfg.head_dim_, generator=g,
                           device=dev).to(torch.bfloat16)

    return (bf(cfg.num_attention_heads), bf(cfg.num_key_value_heads),
            bf(cfg.num_key_value_heads), cos, sin, llama.padding_bias(mask))


def graph_ms(fn, iters: int) -> float:
    """The device time of one call of ``fn``: ``iters`` calls captured in
    a CUDA graph and replayed, so the host's launch cost is not timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        for _ in range(iters):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    ms = time_ms(graph.replay, 5, 1) / iters
    del graph
    return ms


def sdpa_ms(q, k, v, keep, iters: int):
    """F.scaled_dot_product_attention over the heads-first views (the
    kernel's yardstick), or its error's name where it does not run."""
    import torch.nn.functional as F

    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    try:
        return graph_ms(lambda: F.scaled_dot_product_attention(
            *args, attn_mask=keep, enable_gqa=True), iters)
    except (RuntimeError, TypeError) as exc:
        return f"not run ({type(exc).__name__})"


def attention_tiles(dev, name: str, cfg, seed: int) -> dict:
    """Each ``ATTN_TILES`` tile of configuration ``name``, encoded eagerly
    through the whole model (random bf16 weights from ``seed``) by the
    port's entry point: its launch counts read from 0 over exactly that
    encode, the attention kernel's once a layer."""
    from scaling_retriever_tpu_torch.models import encoder
    from scaling_retriever_tpu_torch.models.weights import random_params
    from scaling_retriever_tpu_torch.ops import cuda_lib

    cls = {"llama": encoder.LlamaBiSparse, "qwen2": encoder.Qwen2BiSparse,
           "mistral": encoder.MistralBiSparse}[cfg.model_type]
    enc = cls(random_params(cfg, seed, dev), cfg)
    rng = np.random.default_rng(seed)
    paths = {}
    for _, texts, pos in (t for t in ATTN_TILES if t[0] == name):
        ids = rng.integers(2, cfg.vocab_size, (texts, pos)).astype(np.int32)
        mask = np.ones((texts, pos), np.int32)
        for i, n in enumerate(rng.integers(pos // 2, pos + 1, texts)):
            ids[i, :pos - n] = 0
            mask[i, :pos - n] = 0
        cuda_lib.reset_launches()
        reps = enc.encode(ids, mask)
        torch.cuda.synchronize()
        counts = dict(cuda_lib.LAUNCHES)
        tile = f"{texts}x{pos}"
        paths[f"{name} {tile} tile"] = counts
        check(counts["rope_attention"] == cfg.num_hidden_layers,
              f"{name} {tile} tile launched the attention kernel "
              f"{counts['rope_attention']} times over "
              f"{cfg.num_hidden_layers} layers")
        check(bool(torch.isfinite(reps).all()),
              f"{name} {tile} tile: reps not finite")
        log(f"{name} {tile} tile, eager: {counts['rope_attention']} "
            f"attention launches over {cfg.num_hidden_layers} layers")
    del enc, reps
    free()
    return paths


def attention_phase(dev, seed: int, card_s: str) -> tuple:
    """Phase 13: the attention kernel against its plain version at the text
    tiles of ``ATTN_TILES``, timed, and each tile's launches in its own
    configuration's eager encode; returns the report entries and those
    launch counts by path."""
    from scaling_retriever_tpu_torch.ops import attention as att
    from scaling_retriever_tpu_torch.ops import cuda_lib

    g = torch.Generator(device=dev).manual_seed(seed)
    report = []
    paths = {}
    for name in dict.fromkeys(t[0] for t in ATTN_TILES):
        cfg = attention_config(name)
        paths.update(attention_tiles(dev, name, cfg, seed))
        for _, texts, pos in (t for t in ATTN_TILES if t[0] == name):
            case = attention_case(dev, cfg, texts, pos, g)
            q, k, v, cos, sin, bias = case
            tile = f"{texts}x{pos}"
            before = cuda_lib.LAUNCHES["rope_attention"]
            got = att.rope_attention(*case)
            check(cuda_lib.LAUNCHES["rope_attention"] == before + 1,
                  f"rope_attention at {name} {tile} was not launched")
            want = att.rope_attention_plain(*case)
            err = (got.float() - want.float()).abs()
            check(err.max().item() <= 2 ** -6 * v.float().abs().max().item()
                  and err.mean().item()
                  <= 2 ** -10 * want.float().abs().mean().item(),
                  f"rope_attention at {name} {tile}: max error "
                  f"{err.max().item()}, mean {err.mean().item()}")
            check(torch.equal(att.rope_attention(*case), got),
                  f"rope_attention at {name} {tile}: two launches differ")
            qr, kr = att.apply_rope(q, cos, sin), att.apply_rope(k, cos, sin)
            nbytes = (2 * (q.numel() + k.numel() + v.numel() + got.numel())
                      + 4 * (cos.numel() + sin.numel() + bias.numel()))
            b_ms, b_by = bound(nbytes, 4.0 * q.numel() * pos, BF16_OPS_PER_S)
            report.append({
                "name": "rope_attention", "tile": tile, "layout": name,
                "head_dim": cfg.head_dim_,
                "ms": graph_ms(lambda: att.rope_attention(*case), 20),
                "plain_ms": graph_ms(
                    lambda: att.rope_attention_plain(*case), 10),
                "library_ms": sdpa_ms(qr, kr, v, bias == 0, 50),
                "bound_ms": b_ms, "bound_by": b_by,
                "max_err": err.max().item(), "mean_err": err.mean().item(),
                "launches": paths[f"{name} {tile} tile"]["rope_attention"]})
            del case, q, k, v, got, want, err, qr, kr
    free()
    for x in report:
        log(f"kernel rope_attention at {x['layout']} {x['tile']} (head dim "
            f"{x['head_dim']}): {x['ms']:.4f} ms (plain {x['plain_ms']:.4f} "
            f"ms, library {x['library_ms']}, all replayed from CUDA graphs; "
            f"bound {x['bound_ms']:.4f} ms by {x['bound_by']}; max error "
            f"{x['max_err']:.3g}, mean {x['mean_err']:.3g}; "
            f"{x['launches']} launches a tile); card {card_s}")
    return report, paths


DSV2_LITE = os.path.join(BENCH_CONFIGS, "deepseek-v2-lite.json")


@torch.no_grad()
def deepseek_phase(dev, seed: int, card_s: str) -> dict:
    """Phase 12, the model: DeepSeek-V2-Lite at its published widths with
    random bf16 weights, an eager encode of each text tile through the
    port's entry point. Returns each tile's launch counts, read from 0
    over exactly that encode."""
    from scaling_retriever_tpu_torch.models import deepseek_v2
    from scaling_retriever_tpu_torch.models.config import ModelConfig
    from scaling_retriever_tpu_torch.models.encoder import DeepseekV2BiSparse
    from scaling_retriever_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    with open(DSV2_LITE) as f:
        hf = json.load(f)["model"]
    cfg = ModelConfig.from_hf_config(hf, dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16)
    model = deepseek_v2.empty_model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for p in model.parameters():
        if p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=g)
    enc = DeepseekV2BiSparse(model, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_moe = sum(layer.is_moe for layer in model.layers)
    log(f"DeepSeek-V2-Lite: {n_params} params bf16, {n_moe} MoE layers, "
        f"random from seed {seed}, on card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB")
    rng = np.random.default_rng(seed)
    paths = {}
    for texts, pos in MOE_TILES:
        lens = rng.integers(pos // 2, pos + 1, texts)
        lens[0] = pos
        ids = np.zeros((texts, pos), np.int32)
        mask = np.zeros((texts, pos), np.int32)
        for i, n in enumerate(lens):
            ids[i, pos - n:] = rng.integers(2, cfg.vocab_size, n)
            mask[i, pos - n:] = 1
        model.reset_expert_load()
        cuda_lib.reset_launches()
        reps = enc.encode(ids, mask)
        torch.cuda.synchronize()
        counts = dict(cuda_lib.LAUNCHES)
        tile = f"{texts}x{pos}"
        paths[f"deepseek {tile} tile"] = counts
        got = {k_: counts[k_] for k_ in MOE_KERNELS}
        check(got == dict.fromkeys(MOE_KERNELS, n_moe),
              f"DeepSeek-V2 {tile} tile launched {got}, expected {n_moe} "
              f"of each")
        slots = int(model.expert_load().sum())
        want = texts * pos * cfg.num_experts_per_tok * n_moe
        check(slots == want, f"DeepSeek-V2 {tile} tile: the load counter "
              f"holds {slots} slots, expected {want}")
        check(tuple(reps.shape) == (texts, cfg.vocab_size)
              and bool(torch.isfinite(reps).all()),
              f"DeepSeek-V2 {tile} tile: reps {tuple(reps.shape)} not "
              f"finite")
        ms = time_ms(lambda: enc.encode(ids, mask), 5, 1)
        log(f"DeepSeek-V2 {tile} tile, eager: {got} launches, {slots} "
            f"slots counted, {ms:.2f} ms an encode; card {card_s}")
    del enc, model, reps
    free()
    return paths

KIMI_LINEAR = os.path.join(BENCH_CONFIGS, "kimi-linear-48b-a3b.json")
KDA_HEADS = 32                     # Kimi-Linear's KDA heads of 128


def kda_inputs(dev, texts: int, pos: int, g: torch.Generator) -> tuple:
    """One KDA layer's kernel inputs at Kimi-Linear's widths: the raw
    projections, f and the gate in bf16, beta from a sigmoid, the first
    text's first half pads, convolutions of PyTorch's default range,
    ``A_log`` as fla initialises it, dt_bias the inverse softplus of
    1e-3 .. 1e-1."""
    w = KDA_HEADS * 128

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q, k, v, f, gate = (rand(texts, pos, w).to(torch.bfloat16)
                        for _ in range(5))
    mask = torch.ones(texts, pos, dtype=torch.int32, device=dev)
    mask[0, :pos // 2] = 0
    beta = torch.sigmoid(rand(texts, pos, KDA_HEADS)) * mask[:, :, None]
    convs = [(rand(w, 1, 4) * 0.3).to(torch.bfloat16) for _ in range(3)]
    a_log = torch.log(1 + 15 * torch.rand(KDA_HEADS, generator=g,
                                          device=dev))
    dt = torch.exp(np.log(1e-3) + torch.rand(w, generator=g, device=dev)
                   * np.log(100.0))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    o_norm = (1 + 0.05 * rand(128)).to(torch.bfloat16)
    return (q, k, v, f, beta, gate, mask, *convs, a_log, dt_bias, o_norm,
            1e-5)


def kda_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of the bf16 ``got`` over its element's limit
    against the float32 ``want`` (tests/test_torch_kda_cuda.py's
    ``excess``): 2**-8 |want| (the most one bf16 rounding moves it) plus
    2**-12 of want's root mean square (float32 sums in another order); at
    most 1 where every element is within its limit."""
    want = want.float()
    floor = 2 ** -12 * want.square().mean().sqrt()
    err = (got.float() - want).abs()
    return (err / (2 ** -8 * want.abs() + floor)).max().item()


def kda_phase(dev, seed: int, card_s: str) -> list:
    """Phase 14, the kernel: the KDA kernel against its plain steps (in
    float32 over the same inputs, TF32 off) at both text tiles, timed;
    returns per-kernel report entries."""
    from retrieval_bench.archs import kimi_linear as kimi_arch
    from scaling_retriever_tpu_torch.ops import cuda_lib, kda

    with open(KIMI_LINEAR) as f:
        m = json.load(f)["model"]
    g = torch.Generator(device=dev).manual_seed(seed)
    report = []
    for texts, pos in MOE_TILES:
        args = kda_inputs(dev, texts, pos, g)
        tile = f"{texts}x{pos}"
        before = cuda_lib.LAUNCHES["kda"]
        got = kda.delta_attention(*args)
        check(cuda_lib.LAUNCHES["kda"] == before + 1,
              f"kda at {tile} was not launched")
        wide = [t.float() if i < 6 else t for i, t in enumerate(args)]
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            want = kda.delta_attention_plain(*wide)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        worst = kda_excess(got, want)
        check(worst <= 1.0, f"kda at {tile}: an element's error is {worst} "
              f"times its limit")
        check(not got[0, :pos // 2].any(), f"kda at {tile}: a left pad's "
              f"output is not 0")
        check(torch.equal(kda.delta_attention(*args), got),
              f"kda at {tile}: two launches differ")
        tokens = texts * pos
        b_ms, b_by = bound(kimi_arch.kda_bytes(m, tokens),
                           kimi_arch.kda_ops(m, tokens), BF16_OPS_PER_S)
        report.append({
            "name": "kda", "tile": tile, "layout": "kimi-linear",
            "ms": graph_ms(lambda: kda.delta_attention(*args), 20),
            "plain_ms": time_ms(lambda: kda.delta_attention_plain(*args),
                                2, 1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "excess": worst})
        del args, got, want, wide
    free()
    for x in report:
        log(f"kernel kda at {x['tile']}: {x['ms']:.4f} ms (plain "
            f"{x['plain_ms']:.4f} ms, library none; bound "
            f"{x['bound_ms']:.4f} ms by {x['bound_by']}; worst element "
            f"{x['excess']:.3g} of its limit); card {card_s}")
    return report


@torch.no_grad()
def kimi_phase(dev, seed: int, card_s: str) -> dict:
    """Phase 14, the model: Kimi-Linear-48B-A3B at its published widths
    holding 64 of each MoE layer's 256 experts, random bf16 weights, an
    eager encode of each text tile through the port's entry point. Returns
    each tile's launch counts, read from 0 over exactly that encode."""
    from scaling_retriever_tpu_torch.models import kimi_linear
    from scaling_retriever_tpu_torch.models.config import ModelConfig
    from scaling_retriever_tpu_torch.models.encoder import KimiLinearBiSparse
    from scaling_retriever_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    with open(KIMI_LINEAR) as f:
        hf = json.load(f)["model"]
    cfg = ModelConfig.from_hf_config(hf, dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16)
    model = kimi_linear.empty_model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() == 1 and not name.endswith("bias"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=g)
    enc = KimiLinearBiSparse(model, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_moe = sum(layer.is_moe for layer in model.layers)
    n_kda = len(hf["linear_attn_config"]["kda_layers"])
    log(f"Kimi-Linear: {n_params} params bf16 ({cfg.experts_here} of "
        f"{cfg.n_routed_experts} experts held), {n_kda} KDA and {n_moe} MoE "
        f"layers, random from seed {seed}, on card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB")
    rng = np.random.default_rng(seed)
    paths = {}
    want_counts = {**dict.fromkeys(MOE_KERNELS, n_moe), "kda": n_kda}
    for texts, pos in MOE_TILES:
        lens = rng.integers(pos // 2, pos + 1, texts)
        lens[0] = pos
        ids = np.zeros((texts, pos), np.int32)
        mask = np.zeros((texts, pos), np.int32)
        for i, n in enumerate(lens):
            ids[i, pos - n:] = rng.integers(2, cfg.vocab_size, n)
            mask[i, pos - n:] = 1
        model.reset_expert_load()
        cuda_lib.reset_launches()
        reps = enc.encode(ids, mask)
        torch.cuda.synchronize()
        counts = dict(cuda_lib.LAUNCHES)
        tile = f"{texts}x{pos}"
        paths[f"kimi {tile} tile"] = counts
        got = {k_: counts[k_] for k_ in want_counts}
        check(got == want_counts, f"Kimi-Linear {tile} tile launched {got}, "
              f"expected {want_counts}")
        held = int(model.expert_load().sum())
        absent = int(model.expert_absent().sum())
        want = texts * pos * cfg.num_experts_per_tok * n_moe
        check(held + absent == want and held > 0 and absent > 0,
              f"Kimi-Linear {tile} tile: {held} held and {absent} absent "
              f"slots counted, expected {want} in all and some of each")
        check(tuple(reps.shape) == (texts, cfg.vocab_size)
              and bool(torch.isfinite(reps).all()),
              f"Kimi-Linear {tile} tile: reps {tuple(reps.shape)} not "
              f"finite")
        ms = time_ms(lambda: enc.encode(ids, mask), 3, 1)
        log(f"Kimi-Linear {tile} tile, eager: {got} launches, {held} held "
            f"and {absent} absent slots counted, {ms:.2f} ms an encode; "
            f"card {card_s}")
    del enc, model, reps
    free()
    return paths


def blockmax_kernel_phase(dev, csr, meta, tile):
    """Phase 2, B1 at its block-max site: the kernel against its plain
    version on a real pass-1 job table of the clustered corpus, bit for
    bit. Returns the report entry."""
    from scaling_retriever_tpu_torch.ops import blockmax as bm
    from scaling_retriever_tpu_torch.ops import fetch
    from scaling_retriever_tpu_torch.ops.segsort_scoring import KERNELS

    rows, bits, offsets, n_docs = csr
    qt, qv = tile
    ov = bm.build_overlay(meta, offsets, qt, qv, n_docs)
    kept = bm.keep_entries(ov, bm.cover_tau(ov, BMX_COVER * TOPK))
    plan = bm.job_table(ov, kept)
    J = plan["jobs_per_query"]
    packed = torch.from_numpy(plan["packed"]).to(dev)
    src, jvs, jve, jqv = bm.fetch_inputs(packed, rows.shape[0])
    args = (rows, bits, src, jvs, jve, jqv, J, n_docs)
    got = KERNELS.fetch_bmx(*args)
    want = fetch.fetch_jobs_plain(*args)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "B1 at the block-max site != plain")
    valid = int((jve - jvs).sum())
    check(valid > 0 and kept.mean() < 1, "pass-1 table is empty or unpruned")
    n_jobs = int(src.shape[0])
    b_ms, b_by = bound(n_jobs * 20 + valid * 8 + n_jobs * CHUNK * 8, valid)
    log(f"block-max site: pass-1 table of {TILE} queries x {J} jobs "
        f"(kept {kept.mean():.4f} of {len(kept)} windows), {valid} postings")
    return {"name": "fetch_f32_blockmax", "route": "cuda",
            "source": "scaling_retriever_tpu_torch/csrc/fetch.cu",
            "replaces": "scaling_retriever_tpu/ops/blockmax.py:378",
            "launches": 0, "max_abs_err": 0.0,
            "ms": time_ms(lambda: KERNELS.fetch_bmx(*args), 20),
            "plain_ms": time_ms(lambda: fetch.fetch_jobs_plain(*args), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def engine_phase(dev, eng_f32, eng_q8, eng_bf16, tiles, card_s):
    """Phase 3: SegsortEngine (kernels) vs the plain path on full tiles,
    bf16 also vs the f32 engine (every value is 1.0, exact in bf16), and
    tile times through the depth-2 pipeline."""
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
    from scaling_retriever_tpu_torch.utils.utils import (
        depth2_pipeline, tie_equal_topk)

    f32_res = []
    for name, eng in (("f32", eng_f32), ("q8", eng_q8), ("bf16", eng_bf16)):
        for i, (qt, qv) in enumerate(tiles[:3]):
            s1, r1 = eng.finalize(eng.retrieve_tile_async(
                None, TOPK, sparsified=(qt, qv)))
            J = ss.bucket_jobs(int(eng.job_need(qt, qv).max()))
            qvf = qv * eng._host_scales[qt] if name == "q8" else qv
            qtd = torch.from_numpy(qt).to(dev)
            qvd = torch.from_numpy(qvf).to(dev)
            if name == "q8":
                s0, r0, _ = ss.segsort_retrieve_dma_q8(
                    eng.rows_flat, eng.offsets, qtd, qvd, TOPK, J, N_DOCS,
                    ops=ss.PLAIN)
            elif name == "bf16":
                s0, r0, _ = ss.segsort_retrieve_dma_bf16(
                    eng.rows_flat, eng.valbits_flat, eng.offsets, qtd, qvd,
                    TOPK, J, N_DOCS, ops=ss.PLAIN)
            else:
                s0, r0, _ = ss.segsort_retrieve_dma(
                    eng.rows_flat, eng.valbits_flat, eng.offsets, qtd, qvd,
                    TOPK, J, N_DOCS, ops=ss.PLAIN)
            s0, r0 = s0.cpu().numpy(), r0.cpu().numpy()
            check(np.isfinite(s1).all() and s1.shape == (TILE, TOPK),
                  f"{name}: non-finite or short top-{TOPK}")
            for q in range(TILE):
                tie_equal_topk(r0[q], s0[q], r1[q], s1[q], rtol=1e-5)
            if name == "f32":
                f32_res.append((s1, r1))
            elif name == "bf16":
                for q in range(TILE):
                    tie_equal_topk(f32_res[i][1][q], f32_res[i][0][q],
                                   r1[q], s1[q], rtol=1e-5)
        n = 8
        t0 = time.perf_counter()
        depth2_pipeline(tiles[:n], lambda t: eng.retrieve_tile_async(
            None, TOPK, sparsified=t), eng.finalize)
        ms = (time.perf_counter() - t0) * 1e3 / n
        log(f"engine {name}: kernel path == plain path (tie-equal, rtol 1e-5)"
            f"{' and == f32 engine' if name == 'bf16' else ''}"
            f" on 3 tiles; {ms:.2f} ms per {TILE}-query tile, "
            f"{TILE * 1e3 / ms:.1f} QPS (depth-2 pipeline, {n} tiles); "
            f"card {card_s}")

    # small index against a brute-force oracle
    from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex

    rng = np.random.default_rng(3)
    V, N = 96, 300
    rows = np.repeat(np.arange(N), 6)
    cols = np.concatenate([rng.choice(V, 6, replace=False) for _ in range(N)])
    vals = rng.uniform(0.1, 3.0, len(rows)).astype(np.float32)
    idx = SparseIndex.from_triples(rows, cols, vals, list(range(N)), V)
    dense = np.zeros((N, V))
    dense[rows, cols] = vals
    qt = np.stack([rng.choice(V, 8, replace=False) for _ in range(4)]
                  ).astype(np.int32)
    qv = rng.uniform(0.2, 2.0, (4, 8)).astype(np.float32)
    want = np.zeros((4, V))
    np.put_along_axis(want, qt.astype(np.int64), qv, axis=1)
    want = want @ dense.T
    small = ss.SegsortEngine(idx, topk=20, query_terms_budget=8, device=dev)
    s, r = small.finalize(small.retrieve_tile_async(None, 20,
                                                    sparsified=(qt, qv)))
    for q in range(4):
        order = np.argsort(-want[q], kind="stable")[:20]
        fin = np.isfinite(s[q])
        tie_equal_topk(order[want[q][order] > 0], want[q][order][
            want[q][order] > 0], r[q][fin], s[q][fin], rtol=1e-5)
    log("engine small index == brute-force oracle (tie-equal, rtol 1e-5)")


def clustered_phase(dev, cfg, csr, meta, base, tiles, card_s):
    """Phase 3 on the clustered corpus: the block-max engine through the
    staged pipeline against the unpruned engine through the depth-2
    pipeline (bench_bmx.py's cross_check), one tile against the plain-ops
    engine, tile times, kept fractions, host-pruning split and the device's
    busy share. Returns the block-max engine of the timed pass."""
    from scaling_retriever_tpu_torch.ops.segsort_scoring import PLAIN
    from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

    n = len(tiles)
    run_stream(base, tiles[:2], staged=False)               # warm
    run_stream(make_bmx(csr, meta, cfg), tiles[:2], staged=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_b, r_b = run_stream(base, tiles, staged=False)
    base_ms = (time.perf_counter() - t0) * 1e3 / n
    bmx = make_bmx(csr, meta, cfg)
    t0 = time.perf_counter()
    s_x, r_x = run_stream(bmx, tiles, staged=True)
    bmx_ms = (time.perf_counter() - t0) * 1e3 / n
    st = bmx.stats()
    check(np.isfinite(s_x).all() and s_x.shape == (n * TILE, TOPK),
          "block-max: non-finite or short top-1000")
    same = cross_check(s_x, r_x, s_b, r_b)
    check(st["pruned_tiles"] > 0 and st["gated_tiles"] < n,
          f"block-max never pruned, or gated every tile: {st}")
    plain = make_bmx(csr, meta, cfg, ops=PLAIN)
    s_p, r_p = plain.finalize(plain.retrieve_tile_async(
        None, TOPK, sparsified=tiles[0]))
    for q in range(TILE):
        tie_equal_topk(r_p[q], s_p[q], r_x[q], s_x[q], rtol=1e-5)
    host = {k_: round(v / n, 2) for k_, v in st["host_ms"].items()}
    log(f"engine bmx (clustered, {cfg['N']} docs, {cfg['NNZ']} postings): "
        f"== unpruned engine on {n} tiles x {TILE} queries (cross_check "
        f"2e-4, {same:.4f} of rows identical), == plain-ops engine on a "
        f"tile (tie-equal, rtol 1e-5); {bmx_ms:.2f} ms per tile staged "
        f"(d1=2, d2=2) vs unpruned {base_ms:.2f} ms per tile (depth-2); "
        f"mean kept {st['mean_kept1_frac']} (pass 1) / "
        f"{st['mean_kept_frac']} (final); host ms per tile {host} (sum "
        f"{sum(host.values()):.2f}); stats {st}; card {card_s}")
    profile_tile(f"bmx staged pipeline ({n} tiles)",
                 lambda: run_stream(make_bmx(csr, meta, cfg), tiles,
                                    staged=True), card_s)
    profile_tile(f"unpruned depth-2 pipeline ({n} tiles)",
                 lambda: run_stream(base, tiles, staged=False), card_s)
    return bmx


def profile_tile(label: str, fn, card_s: str) -> None:
    """torch.profiler over one call of ``fn`` (warmed first): wall time,
    device busy time and its share, and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's entry repeats its kernels' time
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} "
        f"ms ({100 * busy_ms / wall_ms:.0f}%); top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in top) + f"; card {card_s}")


def serve_requests(server, reqs):
    """Submit every request, then wait for all: (results, seconds)."""
    t0 = time.perf_counter()
    futs = [server.submit(r) for r in reqs]
    res = [f.result(timeout=600) for f in futs]
    return res, time.perf_counter() - t0


def check_served(backend, eng, reqs, res, label):
    """Each served result is tie-equal (rtol 1e-5) to the engine's own
    tile over the same queries."""
    from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

    for s0 in range(0, len(reqs), TILE):
        chunk = reqs[s0:s0 + TILE]
        scores, rows = eng.finalize(eng.retrieve_tile_async(
            None, TOPK, sparsified=backend.pack(chunk)))
        for i in range(len(chunk)):
            ids, sc = res[s0 + i]
            check(len(ids) > 0 and np.isfinite(sc).all(),
                  f"{label}: empty or non-finite result")
            fin = np.isfinite(scores[i])
            tie_equal_topk(rows[i][fin], scores[i][fin], ids, sc, rtol=1e-5)


def make_model(dev, seed: int):
    """The published Llama-3.2-1B architecture as LlamaBiSparse, random
    bf16 weights from ``seed``."""
    t0 = time.perf_counter()
    model = sparse_encoder(dev, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"encoder: Llama-3.2-1B architecture, {n_params} params bf16, "
        f"random from seed {seed}, on card in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def serving_phase(dev, model, eng_f32, eng_q8, eng_bf16, bmx, bmx_tiles,
                  seed, card_s):
    """Phase 4: text serving at Llama-3.2-1B width (q8 handoff) plus
    pre-encoded serving (f32), then pre-encoded serving on the bf16 index
    and on the block-max engine. Returns the launch counts of each path,
    each read over exactly that path."""
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.serving.server import (
        RetrievalServer, SparseTileBackend)
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, make_encode_fn_handoff)
    from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

    rng = np.random.default_rng(seed)
    short = [" ".join(f"w{x}" for x in rng.integers(0, VOCAB,
                                                     rng.integers(5, 17)))
             for _ in range(128)]
    long = [" ".join(f"w{x}" for x in rng.integers(0, VOCAB, 64))
            for _ in range(128)]
    tok = StandInTokenizer(VOCAB)
    encode = make_encode_fn_handoff(model, T_BUDGET)

    # per-text reference reps: the same 64-wide tiles at the same rung
    reps = {}
    enc_ms = {}
    for texts, rung in ((short, 16), (long, 64)):
        for s in range(0, len(texts), TILE):
            chunk = texts[s:s + TILE]
            ids, mask = tok(chunk, length=rung)
            terms, vals = encode(ids, mask)
            terms, vals = terms.cpu().numpy(), vals.cpu().numpy()
            for i, t in enumerate(chunk):
                keep = vals[i] > 0
                reps[t] = (terms[i][keep], vals[i][keep])
        enc_ms[rung] = time_ms(lambda: encode(ids, mask), 5, 1)
    check(all(len(r[0]) > 0 for r in reps.values()), "empty query reps")

    servers = []
    paths = {}
    try:
        # 64-term queries need ~620 jobs each (bucket 768): a 64-wide tile
        # is 64 x 768 job slots, so the slot cap is raised to hold it
        cap = TILE * 1024
        b_q8 = SparseTileBackend(eng_q8, None, N_DOCS, width=TILE,
                                 t_budget=T_BUDGET, topk=TOPK,
                                 tile_slots_cap=cap)
        srv_q8 = RetrievalServer(b_q8)
        b_f32 = SparseTileBackend(eng_f32, None, N_DOCS, width=TILE,
                                  t_budget=T_BUDGET, topk=TOPK,
                                  tile_slots_cap=cap)
        srv_f32 = RetrievalServer(b_f32)
        sample = [reps[t] for t in short[:32] + long[:32]]
        srv_q8.warmup(sample, passes=1)
        srv_f32.warmup(sample, passes=1)
        fe = QueryEncoderFrontend(srv_q8, encode, tok, widths=(TILE,),
                                  t_sparse=T_BUDGET)
        # ---- the served tiles' captures: launch counts cover exactly
        # this warm-up, whose graphs the main path replays ----
        n_graphs = len(model.tile_graphs)
        cuda_lib.reset_launches()
        w = fe.warmup(short[:8] + long[:8], passes=2)
        paths["text tile captures"] = dict(cuda_lib.LAUNCHES)
        log(f"frontend warmup: {w}")
        # each new (width, rung) shape runs one eager pass and one capture,
        # each launching the attention kernel once a layer
        captured = len(model.tile_graphs) - n_graphs
        got = paths["text tile captures"]["rope_attention"]
        want = 2 * captured * model.config.num_hidden_layers
        check(captured > 0 and got == want,
              f"the text warm-up captured {captured} tiles and launched "
              f"the attention kernel {got} times, expected {want}")
        handle = encode(*tok(long[:TILE], length=64))
        retr_ms = time_ms(lambda: eng_q8.finalize_handoff(
            eng_q8.retrieve_tile_handoff_async(handle[0], handle[1],
                                               fe.jobs_bucket, TOPK)), 3, 1)

        # ---- the main path: launch counts cover exactly this block ----
        cuda_lib.reset_launches()
        srv_q8.start()
        servers.append(srv_q8)
        fe.start()
        servers.append(fe)
        text_res = {}
        t0 = time.perf_counter()
        for wave in (short, long):
            futs = [(t, fe.submit_text(t)) for t in wave]
            for t, f in futs:
                text_res[t] = f.result(timeout=600)
        text_s = time.perf_counter() - t0
        srv_f32.start()
        servers.append(srv_f32)
        f32_texts = short[:64] + long[:64]
        t0 = time.perf_counter()
        futs = [srv_f32.submit(reps[t]) for t in f32_texts]
        f32_res = [f.result(timeout=600) for f in futs]
        f32_s = time.perf_counter() - t0
        paths["text q8 + pre-encoded f32"] = dict(cuda_lib.LAUNCHES)
        # ---- end of the main path ----

        # ---- the bf16 index: launch counts cover exactly this block ----
        b_bf16 = SparseTileBackend(eng_bf16, None, N_DOCS, width=TILE,
                                   t_budget=T_BUDGET, topk=TOPK,
                                   tile_slots_cap=cap)
        srv_bf16 = RetrievalServer(b_bf16)
        srv_bf16.warmup(sample, passes=1)
        bf16_reqs = [reps[t] for t in f32_texts]
        cuda_lib.reset_launches()
        srv_bf16.start()
        servers.append(srv_bf16)
        bf16_res, bf16_s = serve_requests(srv_bf16, bf16_reqs)
        paths["pre-encoded bf16"] = dict(cuda_lib.LAUNCHES)

        # ---- the block-max engine: launch counts cover exactly this ----
        b_bmx = SparseTileBackend(bmx, None, bmx.n_docs, width=TILE,
                                  t_budget=32, topk=TOPK, tile_slots_cap=cap)
        srv_bmx = RetrievalServer(b_bmx)
        bmx_reqs = [(qt[i][qv[i] > 0], qv[i][qv[i] > 0])
                    for qt, qv in bmx_tiles for i in range(TILE)]
        srv_bmx.warmup(bmx_reqs[:TILE], passes=1)
        before = bmx.stats()
        cuda_lib.reset_launches()
        srv_bmx.start()
        servers.append(srv_bmx)
        bmx_res, bmx_s = serve_requests(srv_bmx, bmx_reqs)
        paths["pre-encoded block-max"] = dict(cuda_lib.LAUNCHES)
        after = bmx.stats()

        log(f"text serving (q8 index, device handoff): {len(text_res)} "
            f"requests in {text_s:.2f} s = {len(text_res) / text_s:.1f} QPS;"
            f" encode {enc_ms[16]:.2f} ms (16-token rung) / {enc_ms[64]:.2f}"
            f" ms (64-token rung) per {TILE}-query tile; handoff retrieve "
            f"{retr_ms:.2f} ms per tile (bucket {fe.jobs_bucket} jobs); "
            f"frontend {fe.stats()}; card {card_s}")
        log(f"pre-encoded serving (f32 index): {len(f32_res)} requests in "
            f"{f32_s:.2f} s = {len(f32_res) / f32_s:.1f} QPS; "
            f"server {srv_f32.stats()}; card {card_s}")
        log(f"pre-encoded serving (bf16 index): {len(bf16_res)} requests in "
            f"{bf16_s:.2f} s = {len(bf16_res) / bf16_s:.1f} QPS; "
            f"server {srv_bf16.stats()}; card {card_s}")
        log(f"pre-encoded serving (block-max engine, clustered corpus): "
            f"{len(bmx_res)} requests in {bmx_s:.2f} s = "
            f"{len(bmx_res) / bmx_s:.1f} QPS; pruned tiles "
            f"{after['pruned_tiles'] - before['pruned_tiles']}, pass-2 tiles "
            f"{after['pass2_tiles'] - before['pass2_tiles']}, gated "
            f"{after['gated_tiles'] - before['gated_tiles']}; server "
            f"{srv_bmx.stats()}; card {card_s}")
        for path, counts in paths.items():
            log(f"launches over the {path} path: {counts}")

        # ---- checks (after the counted block) ----
        for t, (ids, scores) in text_res.items():
            check(len(ids) > 0 and np.isfinite(scores).all(),
                  f"text result empty or non-finite ({len(ids)} ids)")
        futs = [(t, srv_q8.submit(reps[t])) for t in text_res]
        for t, f in futs:
            tie_equal_topk(*f.result(timeout=600), *text_res[t], rtol=1e-5)
        for t, (ids, scores) in zip(f32_texts, f32_res):
            check(len(ids) > 0 and np.isfinite(scores).all(),
                  f"f32 result empty or non-finite ({len(ids)} ids)")
            # q8 codes are lossless on this index (every value 1.0)
            tie_equal_topk(*text_res[t], ids, scores, rtol=2e-5)
        log(f"text results == RetrievalServer.submit of the same reps "
            f"(tie-equal, rtol 1e-5); f32 == q8 (tie-equal, rtol 2e-5)")
        check_served(b_bf16, eng_bf16, bf16_reqs, bf16_res, "bf16")
        check_served(b_bmx, bmx, bmx_reqs, bmx_res, "block-max")
        check(after["pruned_tiles"] > before["pruned_tiles"],
              "the block-max server pruned no tile")
        log(f"bf16 and block-max served results == engine tiles of the same "
            f"queries (tie-equal, rtol 1e-5)")
        text_tile = b_f32.pack([reps[t] for t in long[:TILE]])
        profile_tile("f32 engine tile (64 text reps)",
                     lambda: eng_f32.finalize(eng_f32.retrieve_tile_async(
                         None, TOPK, sparsified=text_tile)), card_s)
        profile_tile("text tile (encode 64-token rung + q8 handoff)",
                     lambda: eng_q8.finalize_handoff(
                         eng_q8.retrieve_tile_handoff_async(
                             *encode(*tok(long[:TILE], length=64)),
                             fe.jobs_bucket, TOPK)), card_s)
    finally:
        for s in reversed(servers):
            s.stop()
    return paths


# ---- phase 5: the offline evaluation path

DEV_QUERIES = 6_980           # MSMARCO Dev's query count
CHECK_Q = 4 * TILE            # the stream's first 4 tiles, checked in full
RUN_Q = 1_024                 # the stream's last queries, written to run.json
N_TEXTS = 64
CLI_CUT = 32                  # the CLI's index keeps docs < N_DOCS // CLI_CUT
BMX_Q = 8 * TILE
MAXSCORE_Q = 1_024


def dev_stream(rng):
    """DEV_QUERIES pre-encoded queries of L0_Q random terms, weights k/64
    (k in 8..128) descending, padded to T_BUDGET. Dyadic weights over the
    all-1.0 index make every f32 and bf16 score exact in any summation
    order, so paths agree bit for bit (q8 folds 1/255 scales: to
    rounding)."""
    qt = np.zeros((DEV_QUERIES, T_BUDGET), np.int32)
    qv = np.zeros((DEV_QUERIES, T_BUDGET), np.float32)
    qt[:, :L0_Q] = rng.integers(0, VOCAB, (DEV_QUERIES, L0_Q))
    qv[:, :L0_Q] = -np.sort(-rng.integers(8, 129, (DEV_QUERIES, L0_Q)),
                            axis=1) / 64.0
    return qt, qv, [f"q{i}" for i in range(DEV_QUERIES)]


def sparse_batches(qt, qv, ids, bz: int = 128) -> list:
    return [{"q_terms": qt[s:s + bz], "q_vals": qv[s:s + bz],
             "ids": ids[s:s + bz]} for s in range(0, len(ids), bz)]


def host_index(rows, bits, offsets, n_docs: int, nnz: int, prefix: str):
    """A host SparseIndex of a corpus generated on the card (one device to
    host copy), doc ids prefix + row."""
    from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex

    t0 = time.perf_counter()
    idx = SparseIndex(np.asarray(offsets, np.int64), rows[:nnz].cpu().numpy(),
                      bits[:nnz].view(torch.float32).cpu().numpy(),
                      [f"{prefix}{i}" for i in range(n_docs)],
                      len(offsets) - 1)
    log(f"host SparseIndex: {idx.nnz} postings, {idx.nb_docs()} docs, "
        f"copied from the card in {time.perf_counter() - t0:.1f} s")
    return idx


def ranked(docs: dict) -> list:
    """A run entry as (doc, score) pairs in the trec_eval order."""
    return sorted(docs.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)


def same_run(got: dict, want: dict, qids, rtol: float, label: str) -> None:
    """Per query: tie-equal top-k lists (tie_equal_topk at ``rtol``)."""
    from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

    for q in qids:
        check(q in got and q in want, f"{label}: query {q} missing")
        g, w = ranked(got[q]), ranked(want[q])
        tie_equal_topk([d for d, _ in w], [s for _, s in w],
                       [d for d, _ in g], [s for _, s in g], rtol=rtol)


def cross_check_runs(got: dict, want: dict, qids, label: str) -> float:
    """bench_bmx.py's cross_check over two runs' lists of the same
    queries; returns the share of identical doc ids."""
    for q in qids:
        check(len(got[q]) == len(want[q]), f"{label}: {q} lengths differ")
    g = [ranked(got[q]) for q in qids]
    w = [ranked(want[q]) for q in qids]
    return cross_check(np.array([[s for _, s in r] for r in g]),
                       np.array([[d for d, _ in r] for r in g]),
                       np.array([[s for _, s in r] for r in w]),
                       np.array([[d for d, _ in r] for r in w]))


def engine_run(eng, qt, qv, ids, doc_ids, n_docs, k=None) -> dict:
    """The engine's TILE-wide tiles over the queries (depth-2 pipeline) as a
    run dict of top-``k`` (default TOPK) lists, thresholded at 0 as the
    driver does."""
    k = k or TOPK
    from scaling_retriever_tpu_torch.utils.run_accum import RunAccumulator
    from scaling_retriever_tpu_torch.utils.utils import depth2_pipeline

    acc = RunAccumulator(ids, doc_ids, n_docs, threshold=0.0)

    def dispatch(s):
        return s, eng.retrieve_tile_async(
            None, k, sparsified=(qt[s:s + TILE], qv[s:s + TILE]))

    def drain(p):
        s, payload = p
        scores, rows = eng.finalize(payload)
        acc.add_tile(np.arange(s, s + len(scores)), rows, scores)

    depth2_pipeline(range(0, len(ids), TILE), dispatch, drain)
    return acc.to_run()


def stream_arrays(eng, qt, qv, k=None) -> tuple[np.ndarray, np.ndarray]:
    """The engine's top-``k`` (default TOPK) over the queries in TILE-wide
    tiles (depth-2 pipeline): (rows int64, scores f32) [nq, k] host
    arrays, as ``same_topk`` takes them."""
    from scaling_retriever_tpu_torch.utils.utils import depth2_pipeline

    k = k or TOPK
    rows = np.empty((len(qt), k), np.int64)
    scores = np.empty((len(qt), k), np.float32)

    def dispatch(s):
        return s, eng.retrieve_tile_async(
            None, k, sparsified=(qt[s:s + TILE], qv[s:s + TILE]))

    def drain(p):
        s, payload = p
        sc, r = eng.finalize(payload)
        scores[s:s + len(sc)] = sc
        rows[s:s + len(sc)] = r

    depth2_pipeline(range(0, len(qt), TILE), dispatch, drain)
    return rows, scores


def log_stats(label: str, st: dict, card_s: str) -> None:
    spans = {k: (v["count"], v["total_s"], v["max_s"])
             for k, v in st["spans"].items()}
    log(f"offline {label}: setup_s {st['setup_s']}, encode_s "
        f"{st['encode_s']}, retrieval_s {st['retrieval_s']}, retrieval_qps "
        f"{st['retrieval_qps']}, steady_qps {st.get('steady_qps')}, warmup "
        f"{st.get('warmup_tiles')} tiles / {st.get('warmup_s')} s, hot "
        f"{st.get('hot_queries')}, L0_q {st['L0_q']}; spans (count, total_s,"
        f" max_s) {spans}; card {card_s}")


def free() -> None:
    """Return the card memory of objects the caller has deleted."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def topm_at_prefix(seg, qt, qv, k: int, card_s: str) -> None:
    """B1, B4 and B5 at the shapes maxscore's prefix engine gives them (a
    top-C over its slab), each against its plain version on the same
    inputs; B5 also timed."""
    from scaling_retriever_tpu_torch.ops import fetch, segsum, topm
    from scaling_retriever_tpu_torch.ops.segsort_scoring import bucket_jobs

    dev = seg.device
    jobs = bucket_jobs(int(seg.job_need(qt, qv).max()))
    qtd, order = torch.sort(torch.from_numpy(qt).to(dev), dim=1, stable=True)
    qvd = torch.from_numpy(qv).to(dev).gather(1, order)
    args = (seg.rows_flat, seg.valbits_flat, qtd, seg.offsets, qvd, jobs,
            seg.n_docs)
    rows, contrib, _ = fetch.fetch_postings_dma(*args)
    prow, pcon, _ = fetch.fetch_postings_dma(*args,
                                             fetch=fetch.fetch_jobs_plain)
    check(torch.equal(rows, prow) and torch.equal(contrib, pcon),
          f"B1 != plain at maxscore's prefix slab ({jobs} jobs per query)")
    del prow, pcon
    srow, perm = torch.sort(rows, dim=1)
    sc = contrib.gather(1, perm)
    score = segsum.segsum_mask(srow, sc, seg.n_docs, qt.shape[1])
    ref = segsum.segsum_mask_plain(srow, sc, seg.n_docs, qt.shape[1])
    fin = torch.isfinite(ref)
    check(torch.equal(fin, torch.isfinite(score)) and bool(fin.any()),
          "B4 run-end mask differs at maxscore's prefix slab")
    rel = float(((score[fin] - ref[fin]).abs()
                 / ref[fin].abs().clamp_min(1e-30)).max())
    check(rel <= 1e-6, f"B4 relative error {rel} at maxscore's prefix slab")
    nq, P = score.shape
    block = 4096
    B = P // block
    m = max(32, -(-k // B))
    check(B >= 4 and m <= 128, f"prefix slab [{nq}, {P}] takes no B5 "
          f"(m {m})")
    v, i = topm.block_topm(score, m, block)
    pv, pi = topm.block_topm_plain(score, m, block)
    check(torch.equal(v, pv) and torch.equal(i, pi),
          f"B5 != plain at maxscore's m {m}")
    b_ms, b_by = bound(nq * P * 4 + nq * B * m * 8, nq * P)
    log(f"maxscore's prefix slab [{nq}, {P}] ({jobs} jobs per query): B1 == "
        f"plain, B4 == plain (max relative error {rel:.2e}); B5 at block "
        f"{block}, m {m} (k = C = {k}): "
        f"{time_ms(lambda: topm.block_topm(score, m, block), 20):.4f}"
        f" ms, plain {time_ms(lambda: topm.block_topm_plain(score, m, block), 3, 1):.4f}"
        f" ms, torch.topk "
        f"{time_ms(lambda: torch.topk(score.view(nq, B, block), m), 20):.4f} ms,"
        f" bound {b_ms:.4f} ms ({b_by}); == plain; card {card_s}")


def gather_scan(terms, vals, q_t, k: int, block: int,
                step_bytes: int = 1 << 30):
    """The doc-major scan in its earlier formulation, timed beside the CSR
    product (ops/sparse_scoring.py) and nowhere used: per step of whole
    blocks, a [rows, K, nq] row gather of Q^T, a batched [1, K] x [K, nq]
    product per doc, and the top-k merge."""
    n, kk = terms.shape
    nq = q_t.shape[1]
    step = min(n, max(block, (step_bytes // (kk * nq * 4)) // block * block))
    top_s = torch.full((nq, k), float("-inf"), device=q_t.device)
    top_i = torch.full((nq, k), -1, dtype=torch.int64, device=q_t.device)
    for s0 in range(0, n, step):
        tb, vb = terms[s0:s0 + step], vals[s0:s0 + step]
        g = q_t.index_select(0, tb.reshape(-1).long()).view(tb.shape[0], kk,
                                                            nq)
        s = torch.bmm(vb.float().unsqueeze(1), g).squeeze(1).T
        rows = torch.arange(s0, s0 + s.shape[1],
                            device=q_t.device).expand(nq, -1)
        top_s, sel = torch.topk(torch.cat([top_s, s], 1), k, dim=1)
        top_i = torch.cat([top_i, rows], 1).gather(1, sel)
    return top_s, top_i


def term_major_topk(seg, q_t, k: int, chunk: int = 1 << 23):
    """Top-k of Q @ index from the term-major postings that ``seg`` (an f32
    SegsortEngine) holds on the card, by ``index_add_`` over chunks of
    postings: plain PyTorch, independent of the doc-major arrays and of
    the kernels."""
    nnz = int(seg._host_offsets[-1])
    vals = seg.valbits_flat[:nnz].view(torch.float32)
    scores = torch.zeros((seg.n_docs, q_t.shape[1]), device=q_t.device)
    for s0 in range(0, nnz, chunk):
        e = min(s0 + chunk, nnz)
        pos = torch.arange(s0, e, device=q_t.device)
        term = torch.searchsorted(seg.offsets, pos, right=True) - 1
        scores.index_add_(0, seg.rows_flat[s0:e].long(),
                          q_t[term] * vals[s0:e, None])
    return torch.topk(scores.T, k, dim=1)


def as_run(ids, rows, scores, doc_ids, n_docs) -> dict:
    """Device (rows, scores) [nq, k] as a run dict, thresholded at 0."""
    from scaling_retriever_tpu_torch.utils.run_accum import RunAccumulator

    acc = RunAccumulator(ids, doc_ids, n_docs)
    acc.add_tile(np.arange(len(ids)), rows.cpu().numpy(),
                 scores.cpu().numpy())
    return acc.to_run()


def offline_phase(dev, model, index, cindex, cfg, seed, card_s,
                  tmp: str) -> dict:
    """Phase 5: eval_sparse's path (SparseRetrieval over a query stream,
    run.json, evaluate_msmarco) at MSMARCO scale. Its files go under
    ``tmp``; the CLI's index cut stays there (``tmp/index_cut``) for phase
    6. Returns (the launch counts of each offline path, each read over
    exactly that path; the single engines' results phase 10a holds the
    sharded paths against)."""
    from scaling_retriever_tpu_torch.data.collators import \
        LlamaSparseCollectionCollator
    from scaling_retriever_tpu_torch.data.loader import DataLoader
    from scaling_retriever_tpu_torch.evaluation import eval_sparse, metrics
    from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
    from scaling_retriever_tpu_torch.index.sparse_retrieval import \
        SparseRetrieval
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
    from scaling_retriever_tpu_torch.ops.sparse_scoring import \
        retrieve_doc_major
    from scaling_retriever_tpu_torch.utils.profiling import reset_timings

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)

    def lap(step: str) -> None:
        log(f"phase 5 at {time.perf_counter() - t_phase:.1f} s: {step}")
    peaks = []

    def added_gb(fn):
        """fn()'s result and the card memory it added at its peak (GB);
        the phase's peak so far is kept in ``peaks``."""
        peaks.append(torch.cuda.max_memory_allocated(dev))
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        return out, (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    paths = {}
    rng = np.random.default_rng(seed + 1)
    qt, qv, ids = dev_stream(rng)
    chk = slice(0, CHECK_Q)
    fin = slice(DEV_QUERIES - RUN_Q, DEV_QUERIES)
    per_term = int(index.offsets[1] - index.offsets[0])

    def retrieve(ret, batches, **kw):
        reset_timings()
        return ret.retrieve(batches, **kw)

    # ---- 1. the Dev-size stream on the f32 layout ----
    ret = SparseRetrieval(model, index, topk=TOPK, engine="auto",
                          query_tile=TILE, device=dev)
    check(ret.engine == "segsort" and ret._seg.fetch == "dma",
          f"resolve_engine picked {ret.engine} on the card")
    cuda_lib.reset_launches()
    _, st = retrieve(ret, sparse_batches(qt, qv, ids), return_run=False,
                     write_run=False)
    paths["offline f32"] = dict(cuda_lib.LAUNCHES)
    log_stats(f"f32, {DEV_QUERIES} queries (engine {ret.engine})", st, card_s)
    # what phase 10a holds the sharded paths against
    seg = ret._seg
    refs = {"qt": qt, "qv": qv, "ids": ids, "f32": stream_arrays(seg, qt, qv),
            "f32_qps": st["steady_qps"],
            "f32_bytes": seg.rows_flat.nbytes + seg.valbits_flat.nbytes
            + seg.offsets.nbytes}
    del seg
    run_f32, _ = retrieve(ret, sparse_batches(qt[chk], qv[chk], ids[chk]))
    plain = ss.SegsortEngine(topk=TOPK, ops=ss.PLAIN, device_csr=(
        ret._seg.rows_flat, ret._seg.valbits_flat, index.offsets, N_DOCS))
    run_plain = engine_run(plain, qt[chk], qv[chk], ids[chk], index.doc_ids,
                           N_DOCS)
    same_run(run_f32, run_plain, ids[chk], 1e-5, "f32 vs plain")
    check(all(len(run_f32[q]) == TOPK for q in ids[chk]), "short top-1000")
    ret.out_dir = os.path.join(tmp, "run_f32")
    t0 = time.perf_counter()
    run_fin, st_fin = retrieve(ret, sparse_batches(qt[fin], qv[fin], ids[fin]))
    wall = time.perf_counter() - t0
    ret.out_dir = None
    log_stats(f"f32, the last {RUN_Q} queries with run.json", st_fin, card_s)
    log(f"offline f32 run.json of {RUN_Q} queries: retrieve() wall "
        f"{wall:.3f} s = encode {st_fin['encode_s']} s + retrieval "
        f"{st_fin['retrieval_s']} s + run build and dump "
        f"{wall - st_fin['encode_s'] - st_fin['retrieval_s']:.3f} s")
    run_plain_fin = engine_run(plain, qt[fin], qv[fin], ids[fin],
                               index.doc_ids, N_DOCS)
    same_run(run_fin, run_plain_fin, ids[fin], 1e-5, "f32 run.json vs plain")
    refs["run_fin"] = run_fin
    log(f"offline f32 == plain-ops engine on the first {CHECK_Q} and the "
        f"last {RUN_Q} queries (tie-equal, rtol 1e-5)")

    # ---- 2. text in, through the hot route ----
    lap("text in, through the hot route")
    tok = StandInTokenizer(VOCAB)
    texts = [(f"t{i}", " ".join(f"w{x}" for x in rng.integers(
        0, VOCAB, int(rng.integers(5, 65))))) for i in range(N_TEXTS)]
    loader = DataLoader(texts, TILE, LlamaSparseCollectionCollator(tok, 64))
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    (run_text, st_text), hot_gb = added_gb(lambda: retrieve(ret, loader))
    log_stats(f"text ({N_TEXTS} texts, Llama-3.2-1B width)", st_text, card_s)
    check(st_text["hot_queries"] == N_TEXTS,
          f"text queries not hot: {st_text['hot_queries']}")
    batch = next(iter(loader))
    q_t = model.encode(batch["input_ids"], batch["attention_mask"]).T
    q_t = q_t.float().contiguous()
    terms_d, vals_d = ret._hot_terms, ret._hot_vals
    (s, r), dm_gb = added_gb(lambda: retrieve_doc_major(
        terms_d, vals_d, q_t, k=TOPK, block=ret.block))
    text_ids = batch["ids"]
    same_run(run_text, as_run(text_ids, r, s, index.doc_ids, N_DOCS),
             text_ids, 1e-6, "text vs retrieve_doc_major")
    # an independent scorer: the term-major postings, index_add_ in chunks
    (ts, tr), tm_gb = added_gb(lambda: term_major_topk(ret._seg, q_t, TOPK))
    same_run(run_text, as_run(text_ids, tr, ts, index.doc_ids, N_DOCS),
             text_ids, 1e-5, "text vs the term-major scorer")
    del ts, tr
    log(f"doc-major arrays {tuple(terms_d.shape)} int32 + {vals_d.dtype}; "
        f"text run == retrieve_doc_major on the same reps (tie-equal, rtol "
        f"1e-6) and == a term-major index_add_ scorer over the f32 "
        f"engine's postings (tie-equal, rtol 1e-5)")
    # the scan alone: each doc-major entry read once, a multiply-add per
    # (entry, query), the top-k written once; beside it the earlier
    # formulation (a [rows, K, nq] gather per step), on the same inputs
    n_pad, kk = terms_d.shape
    dm_ms = time_ms(lambda: retrieve_doc_major(
        terms_d, vals_d, q_t, k=TOPK, block=ret.block), 3, 1)
    (gs, gr), g_gb = added_gb(lambda: gather_scan(terms_d, vals_d, q_t,
                                                  TOPK, ret.block))
    same_run(as_run(text_ids, gr, gs, index.doc_ids, N_DOCS), run_text,
             text_ids, 1e-5, "the earlier scan vs the CSR scan")
    del gs, gr
    g_ms = time_ms(lambda: gather_scan(terms_d, vals_d, q_t, TOPK,
                                       ret.block), 1, 0)
    b_ms, b_by = bound(n_pad * kk * (4 + vals_d.element_size())
                       + q_t.numel() * 4 + N_TEXTS * TOPK * 12,
                       2 * n_pad * kk * N_TEXTS)
    log(f"doc-major scan, {N_TEXTS} queries over [{n_pad}, {kk}]: CSR "
        f"product {dm_ms:.1f} ms, the earlier [rows, K, nq] gather "
        f"{g_ms:.1f} ms (== the CSR scan, tie-equal, rtol 1e-5), bound "
        f"{b_ms:.2f} ms ({b_by}); card {card_s}")
    log(f"card memory added at each step's peak over the {held_gb:.2f} GB "
        f"held before the text run: the text run with the doc-major build "
        f"{hot_gb:.2f} GB; then, over what is held with the arrays, the "
        f"CSR scan {dm_gb:.2f} GB, "
        f"the term-major check {tm_gb:.2f} GB, the earlier gather scan "
        f"{g_gb:.2f} GB")
    ret.hot_postings = L0_Q * per_term - 1        # every stream query is hot
    run_hot, st_hot = retrieve(ret, sparse_batches(qt[chk], qv[chk],
                                                   ids[chk]))
    ret.hot_postings = 8 * 1024 * 1024
    check(st_hot["hot_queries"] == CHECK_Q, f"hot: {st_hot['hot_queries']}")
    same_run(run_hot, run_f32, ids[chk], 1e-6, "hot route vs segsort")
    log_stats(f"hot route, {CHECK_Q} stream queries", st_hot, card_s)
    ret._hot_terms = ret._hot_vals = terms_d = vals_d = None
    free()
    xla = SparseRetrieval(model, index, topk=TOPK, engine="xla",
                          query_tile=TILE, device=dev)
    run_xla, st_xla = retrieve(xla, loader)
    same_run(run_text, run_xla, batch["ids"], 1e-6, "text vs xla")
    log_stats("xla engine, the same texts", st_xla, card_s)
    refs["texts"] = (loader, run_xla, batch["ids"])
    del xla
    free()

    # ---- 3. the gather fetch on a few tiles ----
    lap("the gather fetch")
    g = ss.SegsortEngine(index, topk=TOPK, fetch="gather", device=dev)
    t0 = time.perf_counter()
    run_g = engine_run(g, qt[:2 * TILE], qv[:2 * TILE], ids[:2 * TILE],
                       index.doc_ids, N_DOCS)
    g_ms = (time.perf_counter() - t0) * 1e3 / 2
    same_run(run_g, run_f32, ids[:2 * TILE], 1e-6, "gather vs dma")
    log(f"fetch='gather': == the DMA engine on 2 tiles (tie-equal, rtol "
        f"1e-6); {g_ms:.1f} ms per tile incl. the run build; card {card_s}")
    del g, plain, ret
    free()

    # ---- 1 (cont.). the bf16 and q8 layouts ----
    lap("the bf16 and q8 layouts")
    for vd, rtol in (("bf16", 1e-6), ("q8", 2e-5)):
        r2 = SparseRetrieval(None, index, topk=TOPK, engine="auto",
                             query_tile=TILE, index_val_dtype=vd, device=dev)
        cuda_lib.reset_launches()
        _, st = retrieve(r2, sparse_batches(qt, qv, ids), return_run=False,
                         write_run=False)
        paths[f"offline {vd}"] = dict(cuda_lib.LAUNCHES)
        log_stats(f"{vd}, {DEV_QUERIES} queries", st, card_s)
        refs[vd] = stream_arrays(r2._seg, qt[:MESH_Q], qv[:MESH_Q])
        run_v, _ = retrieve(r2, sparse_batches(qt[chk], qv[chk], ids[chk]))
        same_run(run_v, run_f32, ids[chk], rtol, f"{vd} vs f32")
        log(f"offline {vd} == f32 on the first {CHECK_Q} queries "
            f"(tie-equal, rtol {rtol})")
        del r2
        free()

    # ---- 4-5. block-max and maxscore on the clustered corpus ----
    lap("block-max and maxscore")
    tiles = make_tiles(cfg, np.random.default_rng(seed + 2),
                       MAXSCORE_Q // TILE)
    cqt = np.concatenate([t[0] for t in tiles])
    cqv = np.concatenate([t[1] for t in tiles])
    cids = [f"c{i}" for i in range(len(cqt))]
    seg = SparseRetrieval(None, cindex, topk=TOPK, engine="segsort",
                          query_tile=TILE, device=dev)
    run_seg, st = retrieve(seg, sparse_batches(cqt, cqv, cids))
    log_stats(f"segsort, clustered, {len(cids)} queries", st, card_s)
    del seg
    free()
    bmx = SparseRetrieval(None, cindex, topk=TOPK, engine="bmx",
                          query_tile=TILE, device=dev)
    cuda_lib.reset_launches()
    run_bmx, st = retrieve(bmx, sparse_batches(cqt[:BMX_Q], cqv[:BMX_Q],
                                               cids[:BMX_Q]))
    paths["offline block-max"] = dict(cuda_lib.LAUNCHES)
    bst = bmx._seg.stats()
    check(bst["pruned_tiles"] > 0, f"block-max pruned no tile: {bst}")
    same = cross_check_runs(run_bmx, run_seg, cids[:BMX_Q], "bmx")
    log_stats(f"block-max, clustered, {BMX_Q} queries (staged pipeline)", st,
              card_s)
    log(f"offline block-max == segsort within cross_check 2e-4 ({same:.4f} "
        f"of ids identical); engine stats {bst}")
    del bmx
    free()
    t0 = time.perf_counter()
    ms = SparseRetrieval(None, cindex, topk=TOPK, engine="maxscore",
                         query_tile=TILE, device=dev)
    log(f"maxscore engine built in {time.perf_counter() - t0:.1f} s (impact "
        f"prefix {int(ms._seg._seg._host_offsets[-1])} postings, doc-major "
        f"{tuple(ms._seg.doc_terms.shape)}); full depth, no cut")
    cuda_lib.reset_launches()
    run_ms, st = retrieve(ms, sparse_batches(cqt, cqv, cids))
    paths["offline maxscore"] = dict(cuda_lib.LAUNCHES)
    eng = ms._seg
    same = cross_check_runs(run_ms, run_seg, cids, "maxscore")
    log_stats(f"maxscore, clustered, {len(cids)} queries", st, card_s)
    log(f"offline maxscore == segsort within cross_check 2e-4 ({same:.4f} "
        f"of ids identical); fallback tiles {eng.fallbacks} of {eng.tiles} "
        f"pruned tiles ({eng.fallbacks / max(eng.tiles, 1):.4f})")
    qt0, qv0 = eng.sparsify_queries(ms._densify((cqt[:TILE], cqv[:TILE])))
    topm_at_prefix(eng._seg, qt0, qv0, eng.C, card_s)
    del ms, eng
    free()

    # ---- 6. the CLI ----
    lap("the CLI")
    cut_n = N_DOCS // CLI_CUT
    keep = index.doc_rows < cut_n
    counts = keep.reshape(VOCAB, per_term).sum(axis=1)
    off = np.zeros(VOCAB + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    cut = SparseIndex(off, index.doc_rows[keep], index.values[keep],
                      index.doc_ids[:cut_n], VOCAB)
    cut_dir = os.path.join(tmp, "index_cut")
    cut.save(cut_dir)
    log(f"CLI index: the uniform index cut to docs < {cut_n} (1/{CLI_CUT} "
        f"of the depth): {cut.nnz} postings, saved to a temporary dir")
    del keep, cut
    reps_path = os.path.join(tmp, "query_reps.npz")
    np.savez(reps_path, ids=np.asarray(ids[fin], dtype=object),
             q_terms=qt[fin], q_vals=qv[fin])
    outs = {}
    for name, extra in (("one pass", []), ("two passes", ["--passes", "2"])):
        outs[name] = os.path.join(tmp, name.replace(" ", "_"))
        t0 = time.perf_counter()
        eval_sparse.main(["--task_name", "retrieval", "--query_reps_path",
                          reps_path, "--index_dir", cut_dir, "--out_dir",
                          outs[name], "--top_k", str(TOPK), "--query_tile",
                          str(TILE), "--device", str(dev)] + extra)
        with open(os.path.join(outs[name], "q_stats.json")) as f:
            qs = json.load(f)
        log(f"CLI retrieval, {name}: {time.perf_counter() - t0:.1f} s; "
            f"q_stats {({k: qs[k] for k in ('setup_s', 'retrieval_qps', 'steady_qps', 'warmup_tiles')})}"
            f"{'; passes ' + str(qs['passes']) if 'passes' in qs else ''}")
    runs = []
    for name in outs:
        with open(os.path.join(outs[name], "run.json")) as f:
            runs.append(json.load(f))
    check(len(runs[0]) == RUN_Q, f"CLI run has {len(runs[0])} queries")
    same_run(runs[1], runs[0], ids[fin], 1e-6, "CLI two passes vs one")
    check(qs["passes"][1]["warmup_tiles"] == 0, "pass 2 ran warmup tiles")
    refs["cli"] = (reps_path, cut_dir, outs["one pass"])
    # maxscore where its certificate holds: every list of the cut is inside
    # the prefix, so the bound is 0 and each tile's result is the prefix
    # engine's top-C rescored exactly (rescore_candidates), held against
    # the CLI's segsort run of the same queries
    ms = SparseRetrieval(None, cut_dir, topk=TOPK, engine="maxscore",
                         query_tile=TILE, device=dev)
    eng = ms._seg
    check(not eng.u_arr.any(), "a list of the cut is longer than the prefix")
    run_msc, st = retrieve(ms, sparse_batches(qt[fin], qv[fin], ids[fin]))
    check(eng.fallbacks == 0 and eng.tiles == RUN_Q // TILE,
          f"certified maxscore: {eng.fallbacks} fallbacks of {eng.tiles}")
    same_run(run_msc, runs[0], ids[fin], 1e-6, "certified maxscore vs CLI")
    log_stats(f"maxscore on the cut, {RUN_Q} queries (longest list "
              f"{int(np.diff(ms.index.offsets).max())} postings)", st, card_s)
    log(f"certified maxscore == the CLI's segsort run (tie-equal, rtol "
        f"1e-6); fallback tiles 0 of {eng.tiles}")
    del ms, eng
    free()
    # evaluate_msmarco on step 1's full-scale run.json: one relevant doc per
    # query, strictly above the query's 10th score, so ties cannot move it
    run_path = os.path.join(tmp, "run_f32", "run.json")
    qrel = {}
    for q in ids[fin]:
        top = ranked(run_fin[q])[:10]
        above = [d for d, s_ in top if s_ > top[-1][1]]
        if above:
            qrel[q] = {above[int(rng.integers(len(above)))]: 1}
    qrel_path = os.path.join(tmp, "qrel.json")
    with open(qrel_path, "w") as f:
        json.dump(qrel, f)
    eval_sparse.main(["--task_name", "evaluate_msmarco", "--eval_qrel_path",
                      qrel_path, "--eval_run_path", run_path,
                      "--eval_metric", "['mrr_10','recall']", "--out_dir",
                      os.path.join(tmp, "perf")])
    with open(os.path.join(tmp, "perf", "perf.json")) as f:
        perf = json.load(f)
    want = {"mrr_10": {"mrr_10": metrics.mrr_k(run_plain_fin, qrel, 10)},
            "recall": metrics.evaluate(run_plain_fin, qrel, "recall")}
    check(perf == want, f"perf.json {perf} != the plain-path metrics {want}")
    log(f"evaluate_msmarco on the {RUN_Q}-query run.json ({len(qrel)} "
        f"queries with a qrel): MRR@10 {perf['mrr_10']['mrr_10']:.6f}, "
        f"recall_10 {perf['recall']['recall_10']:.6f}, recall_1000 "
        f"{perf['recall']['recall_1000']:.6f}; == the metrics of the "
        f"plain-path run")
    log(f"phase 5 (offline path): {time.perf_counter() - t_phase:.1f} s, "
        f"peak card memory "
        f"{max(peaks + [torch.cuda.max_memory_allocated(dev)]) / 1e9:.2f} "
        f"GB allocated; card {card_s}")
    return paths, refs


# ---- phase 10a: the sharded sparse entry points, on four shards of the
# card (between phases 5 and 6, over phase 5's host corpus)

MESH_SHARDS = 4
MESH_Q = 1_024                # the q8 and bf16 sharded runs
MESH_SERVED = 128


def plain_twin(eng):
    """The sharded engine ``eng`` over the same device arrays, each shard
    on the plain versions of the kernels."""
    import copy

    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss

    twin = copy.copy(eng)
    twin.shards = [ss.SegsortEngine(
        topk=e.topk, query_terms_budget=e.T, ops=ss.PLAIN, device_csr=(
            e.rows_flat, e.valbits_flat, e._host_offsets, e.n_docs))
        for e in eng.shards]
    return twin


def mesh_sparse_phase(dev, model, index, refs: dict, card_s: str,
                      tmp: str) -> dict:
    """Phase 10a: SparseRetrieval over a mesh of MESH_SHARDS entries of
    ``dev`` (the ShardedSegsortEngine; its split of phase 5's index kept
    for the q8 and bf16 engines), the Dev-size stream against phase 5's
    single engine, q8 and bf16, the sharded "xla" scan on phase 5's texts,
    served requests, one tile against the plain kernels, and eval_sparse
    --use_mesh. Returns the launch counts of each sharded path."""
    from scaling_retriever_tpu_torch.evaluation import eval_sparse
    from scaling_retriever_tpu_torch.index.sparse_retrieval import \
        SparseRetrieval
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
    from scaling_retriever_tpu_torch.parallel.mesh import make_mesh
    from scaling_retriever_tpu_torch.serving.server import (
        RetrievalServer, SparseTileBackend)
    from scaling_retriever_tpu_torch.utils.profiling import reset_timings

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)

    def lap(step: str) -> None:
        log(f"phase 10a at {time.perf_counter() - t_phase:.1f} s: {step}")

    def retrieve(ret, batches, **kw):
        reset_timings()
        return ret.retrieve(batches, **kw)
    paths = {}
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    qt, qv, ids = refs["qt"], refs["qv"], refs["ids"]
    fin = slice(DEV_QUERIES - RUN_Q, DEV_QUERIES)

    # ---- 1. SparseRetrieval over the mesh, f32, the Dev-size stream ----
    lap("sharded f32 SparseRetrieval")
    split = {}

    def keep_split(n, _split=index.shard_by_rows):
        t0 = time.perf_counter()
        base = rss_bytes()
        split["shards"] = _split(n)
        split["s"] = time.perf_counter() - t0
        split["rss"] = rss_bytes() - base
        return split["shards"]

    index.shard_by_rows = keep_split      # SparseRetrieval's split, kept
    try:
        t0 = time.perf_counter()
        ret = SparseRetrieval(None, index, topk=TOPK, engine="segsort",
                              query_tile=TILE, mesh=mesh)
        build_s = time.perf_counter() - t0
    finally:
        del index.shard_by_rows
    eng = ret._seg
    check(isinstance(eng, ss.ShardedSegsortEngine)
          and len(eng.shards) == MESH_SHARDS
          and all(e.device == dev and e.fetch == "dma" for e in eng.shards),
          f"SparseRetrieval over {mesh.devices} built "
          f"{type(eng).__name__}")
    card_bytes = sum(e.rows_flat.nbytes + e.valbits_flat.nbytes
                     + e.offsets.nbytes for e in eng.shards)
    log(f"sharded f32: {MESH_SHARDS} shards on {dev} of "
        f"{[e.n_docs for e in eng.shards]} docs, "
        f"{[int(e._host_offsets[-1]) for e in eng.shards]} postings; "
        f"shard_by_rows {split['s']:.1f} s, host memory +"
        f"{split['rss'] / 1e9:.2f} GB; SparseRetrieval built in "
        f"{build_s:.1f} s; on the card {card_bytes / 1e9:.3f} GB against "
        f"the single engine's {refs['f32_bytes'] / 1e9:.3f} GB "
        f"({100 * (card_bytes / refs['f32_bytes'] - 1):+.2f}%); card "
        f"{card_s}")
    cuda_lib.reset_launches()
    _, st = retrieve(ret, sparse_batches(qt, qv, ids), return_run=False,
                     write_run=False)
    paths["sharded f32"] = dict(cuda_lib.LAUNCHES)
    log_stats(f"sharded f32, {MESH_SHARDS} shards, {DEV_QUERIES} queries",
              st, card_s)
    log(f"sharded f32 steady_qps {st['steady_qps']} against the single "
        f"engine's {refs['f32_qps']} ("
        f"{st['steady_qps'] / refs['f32_qps']:.3f}x); card {card_s}")
    got = stream_arrays(eng, qt, qv)
    same_topk(got, refs["f32"], "sharded f32 vs the single engine")
    run_m, _ = retrieve(ret, sparse_batches(qt[fin], qv[fin], ids[fin]))
    same_run(run_m, refs["run_fin"], ids[fin], 0.0,
             "sharded f32 run vs the single engine's")
    log(f"sharded f32 == phase 5's single engine over all {DEV_QUERIES} "
        f"queries (scores bit-equal, ids equal above each boundary score) "
        f"and the last {RUN_Q} queries' run (tie-equal, rtol 0)")

    # ---- 2. one tile against the plain kernels, each shard ----
    lap("one tile against the plain versions")
    tile = (qt[:TILE], qv[:TILE])
    cuda_lib.reset_launches()
    k_s, k_r = eng.finalize(eng.retrieve_tile_async(None, TOPK,
                                                    sparsified=tile))
    tile_counts = dict(cuda_lib.LAUNCHES)
    check(all(tile_counts[k_] == MESH_SHARDS
              for k_ in ("fetch_f32", "segsum", "topm")),
          f"one sharded tile launched {tile_counts}")
    plain = plain_twin(eng)
    p_s, p_r = plain.finalize(plain.retrieve_tile_async(None, TOPK,
                                                        sparsified=tile))
    check(sum(cuda_lib.LAUNCHES.values()) == sum(tile_counts.values()),
          "the plain twin launched a kernel")
    same_topk((k_r, k_s), (p_r, p_s),
                    "sharded kernels vs the plain versions")
    log(f"one tile: each of the {MESH_SHARDS} shards launched B1, B4 and B5 "
        f"once ({tile_counts}); == the plain-ops sharded engine (scores "
        f"bit-equal)")
    del plain

    # ---- 3. served: pre-encoded requests through the broker ----
    lap("served")
    reqs = [(qt[i][:L0_Q], qv[i][:L0_Q]) for i in range(MESH_SERVED)]
    backend = SparseTileBackend(eng, None, N_DOCS, width=TILE,
                                t_budget=T_BUDGET, topk=TOPK)
    check(backend.request_cost(reqs[0]) == 0, "the sharded engine has a "
          "cost model")
    server = RetrievalServer(backend)
    server.warmup(reqs[:TILE], passes=1)
    cuda_lib.reset_launches()
    with server:
        res, wall = serve_requests(server, reqs)
    paths["served sharded"] = dict(cuda_lib.LAUNCHES)
    srows = np.array([r[0] for r in res], np.int64)
    sscores = np.array([r[1] for r in res], np.float32)
    same_topk((srows, sscores), (refs["f32"][0][:MESH_SERVED],
                                       refs["f32"][1][:MESH_SERVED]),
                    "served sharded vs the single engine")
    log(f"served sharded: {MESH_SERVED} pre-encoded requests in "
        f"{wall:.3f} s ({MESH_SERVED / wall:.1f} req/s) == the single "
        f"engine (scores bit-equal); stats {server.stats()}; card {card_s}")
    del server, backend

    # ---- 4. q8 and bf16 from the same split ----
    lap("q8 and bf16")
    for vd in ("q8", "bf16"):
        t0 = time.perf_counter()
        e2 = ss.ShardedSegsortEngine(split["shards"], mesh.devices,
                                     topk=TOPK, val_dtype=vd)
        up_s = time.perf_counter() - t0
        stream_arrays(e2, qt[:TILE], qv[:TILE])          # warm
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = stream_arrays(e2, qt[:MESH_Q], qv[:MESH_Q])
        wall = time.perf_counter() - t0
        paths[f"sharded {vd}"] = dict(cuda_lib.LAUNCHES)
        # q8 folds 1/255 scales into the weights, so a doc's sum rounds by
        # its order, which the slab's unstable sort sets (as in the
        # reference): tie-equal at phase 5's q8 tolerance
        rtol = 2e-5 if vd == "q8" else 0.0
        same_topk(got, refs[vd], f"sharded {vd} vs the single engine", rtol)
        bit = np.array_equal(got[1], refs[vd][1])
        nbytes = sum(e.rows_flat.nbytes + (0 if e.valbits_flat is None
                                           else e.valbits_flat.nbytes)
                     for e in e2.shards)
        log(f"sharded {vd}: built from the split in {up_s:.1f} s "
            f"({nbytes / 1e9:.3f} GB on the card); {MESH_Q} queries in "
            f"{wall:.3f} s ({MESH_Q / wall:.1f} QPS, engine tiles); == the "
            f"single {vd} engine (tie-equal, rtol {rtol}; scores "
            f"{'' if bit else 'not '}bit-equal); card {card_s}")
        del e2
        free()
    del split

    # ---- 5. the sharded doc-major scan on phase 5's texts ----
    lap("the sharded xla scan")
    loader, run_xla, text_ids = refs["texts"]
    del ret, eng
    free()
    t0 = time.perf_counter()
    xs = SparseRetrieval(model, index, topk=TOPK, engine="xla",
                         query_tile=TILE, mesh=mesh)
    xs_build = time.perf_counter() - t0
    check(len(xs.terms) == MESH_SHARDS, "the xla engine did not shard")
    run_xs, st = retrieve(xs, loader)
    same_run(run_xs, run_xla, text_ids, 1e-6, "sharded xla vs xla")
    log_stats(f"sharded xla, {N_TEXTS} texts (arrays built in "
              f"{xs_build:.1f} s, {[tuple(t.shape) for t in xs.terms]})",
              st, card_s)
    log(f"sharded xla == phase 5's unsharded xla on the {N_TEXTS} texts "
        f"(tie-equal, rtol 1e-6)")
    del xs
    free()

    # ---- 6. eval_sparse --use_mesh on one card ----
    lap("eval_sparse --use_mesh")
    reps_path, cut_dir, one_pass = refs["cli"]
    out = os.path.join(tmp, "use_mesh")
    t0 = time.perf_counter()
    eval_sparse.main(["--task_name", "retrieval", "--query_reps_path",
                      reps_path, "--index_dir", cut_dir, "--out_dir", out,
                      "--top_k", str(TOPK), "--query_tile", str(TILE),
                      "--device", str(dev), "--use_mesh"])
    cli_s = time.perf_counter() - t0
    runs = []
    for d in (out, one_pass):
        with open(os.path.join(d, "run.json")) as f:
            runs.append(json.load(f))
    check(runs[0] == runs[1], "eval_sparse --use_mesh's run.json differs "
          "from the run without it")
    log(f"eval_sparse --use_mesh over {torch.cuda.device_count()} card(s): "
        f"the one-device path, run.json == the run without the flag "
        f"({cli_s:.1f} s)")
    log(f"phase 10a (sharded sparse): {time.perf_counter() - t_phase:.1f} "
        f"s, peak card memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB allocated; "
        f"card {card_s}")
    return paths


# ---- phase 6: the dense path

DENSE_DIM = 2048              # Llama-3.2-1B's hidden size
DENSE_CHUNK = 262_144
DENSE_TILE = 256
DENSE_M, DENSE_BLOCK = 32, 4096
INT8_Q = 1_024
SERVED_Q = 128
DOC_TEXTS = 2_048
CLI_DENSE_DOCS = 65_536
CLI_Q = 16


def corpus_chunks(dev, seed: int, n_rows=None):
    """``n_rows`` (N_DOCS) DENSE_DIM-wide rows of the dense corpus, made on
    the card by DENSE_CHUNK-row chunks (``benches.corpora.corpus_chunks``):
    yields (first row, bf16 [n, DENSE_DIM])."""
    return corpora.corpus_chunks(dev, seed, N_DOCS if n_rows is None
                                 else n_rows, DENSE_DIM, DENSE_CHUNK)


def empty_dense_index(dev):
    """A bf16 DenseFlatIndexer of phase 6's shape on ``dev``."""
    from scaling_retriever_tpu_torch.index.dense_index import \
        DenseFlatIndexer

    idx = DenseFlatIndexer(device=dev, chunk=DENSE_CHUNK,
                           query_tile=DENSE_TILE, block_m=DENSE_M,
                           sel_block=DENSE_BLOCK)
    idx.init_index(DENSE_DIM)
    return idx


def dense_corpus(dev, seed: int):
    """The corpus added to a bf16 DenseFlatIndexer as tensors on the card
    (ids = rows): its store is the bf16 layout."""
    return corpora.dense_corpus(empty_dense_index(dev),
                                corpus_chunks(dev, seed))


def meminfo_bytes(key: str) -> int:
    """A /proc/meminfo entry (e.g. MemAvailable)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(key)


def host_peak_bytes() -> int:
    """This process's peak resident memory."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def host_corpus(dev, seed: int) -> np.ndarray:
    """The same corpus as one f32 host array [N_DOCS, DENSE_DIM], what
    ``deserialize`` reads from an index_srt.npz or eval_dense from its
    embedding files, copied off the card chunk by chunk."""
    need = N_DOCS * DENSE_DIM * 4
    avail = meminfo_bytes("MemAvailable")
    check(avail > 1.15 * need, f"host memory: {avail / 1e9:.1f} GB "
          f"available, the f32 corpus needs {need / 1e9:.1f} GB")
    import mmap

    # pages mapped in one call up front: first touches of fresh pages
    # fault one by one, several times slower on the card's host
    buf = mmap.mmap(-1, need, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                    | mmap.MAP_POPULATE)
    out = np.frombuffer(buf, np.float32).reshape(N_DOCS, DENSE_DIM)
    for s0, v in corpus_chunks(dev, seed):
        torch.from_numpy(out[s0:s0 + len(v)]).copy_(v)
    return out


def dense_rows(idx, rows: torch.Tensor) -> torch.Tensor:
    """The stored vectors of ``rows`` (f32), gathered from the chunks."""
    rows = rows.cpu()
    out = torch.empty(len(rows), idx.vector_sz, device=idx.device)
    for c, blk in enumerate(idx._store):
        sel = torch.nonzero(rows // idx.chunk == c).flatten()
        if len(sel):
            out[sel.to(idx.device)] = blk[(rows[sel] % idx.chunk).to(
                idx.device)].float()
    return out


def noisy_queries(idx, n: int, g) -> tuple[torch.Tensor, torch.Tensor]:
    """n queries, each a stored doc plus noise of 0.7 its norm,
    normalized (its source doc scores ~0.82): (queries f32, source rows)."""
    dev = idx.device
    src = torch.randint(0, idx.ntotal, (n,), generator=g, device=dev)
    noise = torch.nn.functional.normalize(
        torch.randn(n, idx.vector_sz, generator=g, device=dev), dim=1)
    q = dense_rows(idx, src) + 0.7 * noise
    return torch.nn.functional.normalize(q, dim=1), src


def result_arrays(res) -> tuple[np.ndarray, np.ndarray]:
    """search_knn's [(ids, scores)] of equal lengths → (ids, scores)."""
    ids = np.array([r[0] for r in res])
    scores = np.array([r[1] for r in res], np.float32)
    check(ids.ndim == 2 and ids.shape == scores.shape,
          "ragged dense results")
    return ids, scores


def same_topk(a, b, label: str, rtol: float = 0.0) -> None:
    """Two (ids, scores) arrays of top-k lists, tie-equal row by row. At
    rtol 0 in one array compare: scores bit-equal, ids equal wherever the
    score is above the row's last (boundary) score, each row in (score
    desc, id) order. Otherwise ``tie_equal_topk`` per row."""
    from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

    (ia, sa), (ib, sb) = a, b
    check(ia.shape == ib.shape, f"{label}: shapes {ia.shape} {ib.shape}")
    if rtol:
        for i in range(len(ia)):
            tie_equal_topk(ia[i], sa[i], ib[i], sb[i], rtol=rtol)
        return
    check(np.array_equal(sa, sb), f"{label}: scores differ")
    oa = np.lexsort((ia, -sa))
    ob = np.lexsort((ib, -sb))
    ia, sa = np.take_along_axis(ia, oa, 1), np.take_along_axis(sa, oa, 1)
    ib = np.take_along_axis(ib, ob, 1)
    clear = sa > sa[:, -1:]
    check(np.array_equal(ia[clear], ib[clear]),
          f"{label}: ids above the boundary score differ")


def dense_kernel_check(idx, q, card_s) -> dict:
    """B5 at the dense site's shape on two real slabs (the first chunk and
    the last, whose zero tail ties whole blocks at 0), bit-equal to the
    plain loop; timed beside its bound and torch.topk. Returns the report
    entry (launches filled later)."""
    from scaling_retriever_tpu_torch.index import dense_index as di
    from scaling_retriever_tpu_torch.ops import topm

    docs = idx._materialize()
    q16 = q.bfloat16()
    nblk = DENSE_CHUNK // DENSE_BLOCK
    zero_blocks = (N_DOCS % DENSE_CHUNK and
                   (DENSE_CHUNK - N_DOCS % DENSE_CHUNK) // DENSE_BLOCK)
    s = None
    for c in (len(docs) - 1, 0):
        s = di._score_slab(q16, docs[c], None, None)
        v, i = topm.block_topm(s, DENSE_M, DENSE_BLOCK, site="topm_dense")
        pv, pi = topm.block_topm_plain(s, DENSE_M, DENSE_BLOCK)
        check(torch.equal(v, pv) and torch.equal(i, pi),
              f"B5 != plain at the dense shape (chunk {c})")
        if c == len(docs) - 1 and zero_blocks:
            lanes = torch.arange(DENSE_M, device=s.device, dtype=torch.int32)
            z = i[:, nblk - zero_blocks:]
            check(bool((z == lanes).all()) and bool(
                (v[:, nblk - zero_blocks:] == 0).all()),
                "B5: the zero tail's tied blocks must return lanes 0..m-1")
    nq = s.shape[0]
    b_ms, b_by = bound(nq * DENSE_CHUNK * 4 + nq * nblk * DENSE_M * 8,
                       nq * DENSE_CHUNK)
    entry = {
        "name": "topm_dense", "route": "cuda",
        "source": "scaling_retriever_tpu_torch/csrc/topm.cu",
        "replaces": "scaling_retriever_tpu/ops/pallas_topm.py:35 (third "
                    "call site scaling_retriever_tpu/index/dense_index.py:"
                    "115)",
        "launches": 0, "max_abs_err": 0.0,
        "ms": time_ms(lambda: topm.block_topm(s, DENSE_M, DENSE_BLOCK,
                                              site="topm_dense"), 20),
        "plain_ms": time_ms(lambda: topm.block_topm_plain(
            s, DENSE_M, DENSE_BLOCK), 2, 1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.topk(
            s.view(nq, nblk, DENSE_BLOCK), DENSE_M), 20)}
    log(f"B5 top-m dense at [{nq}, {DENSE_CHUNK}], block {DENSE_BLOCK}, m "
        f"{DENSE_M}: {entry['ms']:.4f} ms, plain {entry['plain_ms']:.2f} ms,"
        f" torch.topk {entry['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); == plain on the first chunk's slab and the last's "
        f"({zero_blocks} all-zero blocks: lanes 0..{DENSE_M - 1}); card "
        f"{card_s}")
    return entry


def http_json(url: str, body=None, timeout: float = 120):
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def start_cli(args: list, log_path: str):
    """The server CLI in a subprocess of this interpreter, from the
    repository root, on a port the system picks (``--port 0``); its output
    goes to ``log_path``."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "scaling_retriever_tpu_torch.serving.server",
             *args, "--port", "0"], cwd=root, stdout=f,
            stderr=subprocess.STDOUT)


def wait_healthy(proc, log_path: str, timeout: float = 240):
    """Wait for the CLI's ``serving on http://host:PORT`` line (printed
    once the port is bound) and then for its /healthz. Returns (port,
    seconds since the call)."""
    import re
    import urllib.error

    t0 = time.perf_counter()
    port = None
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            break
        if port is None:
            with open(log_path) as f:
                m = re.search(r"serving on http://[^\s]+:(\d+)", f.read())
            if m is None:
                time.sleep(0.5)
                continue
            port = int(m.group(1))
        try:
            if http_json(f"http://127.0.0.1:{port}/healthz", timeout=5)["ok"]:
                return port, time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.5)
    with open(log_path) as f:
        tail = f.read()[-3000:]
    raise RuntimeError(f"server CLI (port {port}) not healthy (exit "
                       f"{proc.poll()}):\n{tail}")


def stop_cli(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


def host_load(dev, seed: int, q, head: dict, bf16_bytes: int,
              int8_bytes: int, card_s: str) -> int:
    """The corpus as the file-based entry points add it (``deserialize``,
    ``LocalDenseRetriever``): one f32 host array through ``add_batch``. The
    store must stay on the host (its full chunks views of the array), the
    card must hold the bf16 layout and then the int8 one and nothing else,
    and the first tile ``q`` must answer as the card-built index did
    (``head``: scores bit-equal, ids tie-equal). Returns the card's peak
    allocation while the layouts were built."""
    t0 = time.perf_counter()
    host = host_corpus(dev, seed)
    made_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated(dev)
    idx = empty_dense_index(dev)
    t0 = time.perf_counter()
    idx.add_batch(range(N_DOCS), host)
    add_s = time.perf_counter() - t0
    check(all(b.device.type == "cpu" for b in idx._store),
          "numpy rows must stay in a host store")
    views = sum(b.data_ptr() == host[c * DENSE_CHUNK:].ctypes.data
                for c, b in enumerate(idx._store))
    check(views == N_DOCS // DENSE_CHUNK,
          f"{views} of the store's chunks are views of the added array")
    log(f"host-array load at full depth: {N_DOCS} x {DENSE_DIM} f32 "
        f"({host.nbytes / 1e9:.2f} GB) copied off the card in {made_s:.1f} s,"
        f" added in {add_s:.2f} s ({views} chunks kept as views); host peak "
        f"RSS {host_peak_bytes() / 1e9:.1f} GB; the card held "
        f"{base / 1e9:.2f} GB before")
    peaks = []
    for quant, want_b in ((None, bf16_bytes), ("int8", int8_bytes)):
        idx.quantize = quant
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        idx._materialize()
        built_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated(dev) - base
        peaks.append(torch.cuda.max_memory_allocated(dev))
        peak = peaks[-1] - base
        # an f32 copy of the store on the card would add twice the bf16
        # layout's bytes
        check(want_b <= held < want_b + 2**26, f"card holds {held} B over "
              f"the layout's {want_b} B ({quant or 'bf16'})")
        label = quant or "bf16"
        same_topk(result_arrays(idx.search_knn(q, TOPK)), head[label],
                  f"host-array load ({label}) vs the card-built index")
        log(f"host-array load, {label} layout: built from the host store in "
            f"{built_s:.1f} s ({host.nbytes / built_s / 1e9:.1f} GB/s of f32 "
            f"moved), the card holds {held / 1e9:.2f} GB over what it held "
            f"before (peak {peak / 1e9:.2f} GB while built); a tile's answers"
            f" == the card-built index's (scores bit-equal, ids tie-equal); "
            f"card {card_s}")
    del idx, host
    return max(peaks)


MESH_DENSE_Q = 1_024
MESH_INT8_CHUNKS = 8          # the int8 cut: 2,097,152 rows
MESH_FILE_ROWS = 65_536       # MeshDenseRetriever's cut, from files


def mesh_dense_phase(dev, idx, codes, q_all, card_s: str, tmp: str) -> None:
    """Phase 10b, inside phase 6 while its int8 layout exists: the bf16
    store as MESH_SHARDS row-range views (chunk lists, no copy) through
    make_sharded_dense_search against the direct search over the whole
    store; the int8 codes on a cut, bit-equal; MeshDenseRetriever over
    MESH_FILE_ROWS rows written as embedding files against
    LocalDenseRetriever over the same files."""
    from scaling_retriever_tpu_torch.evaluation.eval_dense import (
        LocalDenseRetriever, MeshDenseRetriever)
    from scaling_retriever_tpu_torch.index import dense_index as di
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)

    def shards_of(chunks, n_chunks):
        """Row-range views of the first ``n_chunks`` chunks, one chunk list
        per shard, and each shard's global row ids (-1 past N_DOCS)."""
        docs, ids = [], []
        for part in np.array_split(np.arange(n_chunks), MESH_SHARDS):
            docs.append([chunks[c] for c in part])
            r = torch.arange(int(part[0]) * DENSE_CHUNK,
                             (int(part[-1]) + 1) * DENSE_CHUNK, device=dev)
            ids.append(torch.where(r < N_DOCS, r, -1))
        return docs, ids

    def tiles(fn, n):
        """fn over the DENSE_TILE-query tiles of n queries → (rows,
        scores) host arrays, and the seconds it took."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [fn(slice(s0, min(s0 + DENSE_TILE, n)))
               for s0 in range(0, n, DENSE_TILE)]
        rows = np.concatenate([r.cpu().numpy() for _, r in out])
        scores = np.concatenate([s.cpu().numpy() for s, _ in out])
        return (rows.astype(np.int64), scores), time.perf_counter() - t0

    # bf16: the whole store over four shards against the direct search
    store = idx._store
    docs, row_ids = shards_of(store, len(store))
    check(all(c.data_ptr() == store[i].data_ptr() for i, c in enumerate(
        itertools.chain(*docs))), "a shard copied the store")
    q = q_all[:MESH_DENSE_Q].to(torch.bfloat16)
    fn = di.make_sharded_dense_search(mesh, "data", k=TOPK,
                                      chunk=DENSE_CHUNK)
    cuda_lib.reset_launches()
    got, sh_s = tiles(lambda t: fn(docs, row_ids, q[t]), MESH_DENSE_Q)
    check(not any(cuda_lib.LAUNCHES.values()),
          f"the sharded dense search launched {cuda_lib.LAUNCHES}")
    want, di_s = tiles(lambda t: di._search_chunked(store, q[t], TOPK,
                                                    DENSE_CHUNK),
                       MESH_DENSE_Q)
    check(not (got[0] >= N_DOCS).any(), "a padding row in the top-k")
    same_topk(got, want, "dense sharded vs direct", rtol=1e-5)
    bit = np.array_equal(got[1], want[1])
    rel = float(np.max(np.abs(got[1] - want[1])
                       / np.maximum(np.abs(want[1]), 1e-30)))
    log(f"dense sharded, bf16: the store as {MESH_SHARDS} views of "
        f"{[len(d) for d in docs]} chunks, {MESH_DENSE_Q} queries, k {TOPK}:"
        f" {sh_s:.3f} s against {di_s:.3f} s for the direct search over the "
        f"whole store; ids tie-equal, scores "
        f"{'bit-equal' if bit else f'within {rel:.2e} relative'} (limit "
        f"1e-5); no kernel launched (B5's dense site is not on this path); "
        f"card {card_s}")

    # int8 on a cut: codes exact, so bit-equal
    qc, qs = di._quantize_queries_int8(q_all[:MESH_DENSE_Q].float())
    scales = idx._layout[2]
    cdocs, cids = shards_of(codes, MESH_INT8_CHUNKS)
    cscales, _ = shards_of(scales, MESH_INT8_CHUNKS)
    fn8 = di.make_sharded_dense_search(mesh, "data", k=TOPK,
                                       chunk=DENSE_CHUNK, quantize="int8")
    got8, sh8_s = tiles(lambda t: fn8(cdocs, cids, cscales, qc[t], qs[t]),
                        MESH_DENSE_Q)
    want8, di8_s = tiles(lambda t: di._search_chunked(
        codes[:MESH_INT8_CHUNKS], qc[t], TOPK, DENSE_CHUNK,
        doc_scales=scales[:MESH_INT8_CHUNKS], q_scale=qs[t]), MESH_DENSE_Q)
    same_topk(got8, want8, "dense sharded int8 vs direct")
    log(f"dense sharded, int8 on a cut of {MESH_INT8_CHUNKS * DENSE_CHUNK} "
        f"rows: {sh8_s:.3f} s against {di8_s:.3f} s direct; == the direct "
        f"search (scores bit-equal, ids tie-equal); card {card_s}")

    # MeshDenseRetriever from embedding files against LocalDenseRetriever
    fdir = os.path.join(tmp, "mesh_embs")
    os.makedirs(fdir)
    rows = store[0][:MESH_FILE_ROWS].float().cpu().numpy()
    half = MESH_FILE_ROWS // 2
    for c in range(2):
        np.save(os.path.join(fdir, f"embs_0_{c}.npy"),
                rows[c * half:(c + 1) * half])
        np.save(os.path.join(fdir, f"ids_0_{c}.npy"), np.array(
            [f"d{i}" for i in range(c * half, (c + 1) * half)], dtype=object))
    with open(os.path.join(fdir, "plan.json"), "w") as f:
        json.dump({"nranks": 1, "num_chunks": 2}, f)
    qf = q_all[:DENSE_TILE].float().cpu().numpy()
    res = {}
    for name, r in (("mesh", MeshDenseRetriever(DENSE_DIM, mesh)),
                    ("local", LocalDenseRetriever(DENSE_DIM, device=dev))):
        t0 = time.perf_counter()
        r.index_encoded_data(fdir)
        res[name] = result_arrays(r.get_top_docs(qf, TOPK))
        res[name + "_s"] = time.perf_counter() - t0
        del r
    same_topk(res["mesh"], res["local"],
              "MeshDenseRetriever vs LocalDenseRetriever", rtol=1e-5)
    log(f"MeshDenseRetriever over {MESH_FILE_ROWS} rows in 2 embedding "
        f"files, {MESH_SHARDS} shards of one card, {DENSE_TILE} queries: "
        f"{res['mesh_s']:.2f} s (load + search) against "
        f"LocalDenseRetriever's {res['local_s']:.2f} s; tie-equal (rtol "
        f"1e-5)")
    shutil.rmtree(fdir)
    log(f"phase 10b (dense sharded): {time.perf_counter() - t_phase:.1f} s;"
        f" card {card_s}")


def dense_phase(dev, model, seed: int, card_s: str, tmp: str):
    """Phase 6: the dense path at 8,841,823 x 2048 (bf16, then int8),
    served in process, over HTTP and through the server CLI, and
    eval_dense's task bodies with LlamaBiDense at Llama-3.2-1B width.
    Returns (launch counts per dense path, B5's dense report entry)."""
    from scaling_retriever_tpu_torch.data.collators import \
        LlamaDenseCollectionCollator
    from scaling_retriever_tpu_torch.data.loader import DataLoader
    from scaling_retriever_tpu_torch.evaluation import eval_dense, metrics
    from scaling_retriever_tpu_torch.index.dense_index import \
        DenseFlatIndexer
    from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiDense
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine
    from scaling_retriever_tpu_torch.serving.server import (
        DenseTileBackend, RetrievalServer, serve_http)
    from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 products must not run in TF32")

    def lap(step: str) -> None:
        log(f"phase 6 at {time.perf_counter() - t_phase:.1f} s: {step}")
    paths = {}
    procs = []
    try:
        # ---- 1. the corpus ----
        t0 = time.perf_counter()
        idx = dense_corpus(dev, seed + 3)
        nbytes = sum(b.nbytes for b in idx._store)
        log(f"dense corpus: {idx.ntotal} x {DENSE_DIM} bf16 rows in "
            f"{len(idx._store)} chunks of {DENSE_CHUNK} ({nbytes / 1e9:.2f} "
            f"GB on the card, {DENSE_CHUNK * len(idx._store) - N_DOCS} zero "
            f"rows) made and added in {time.perf_counter() - t0:.1f} s")
        check(idx._materialize()[0] is idx._store[0],
              "the bf16 layout must be the store itself")
        g = torch.Generator(device=dev).manual_seed(seed + 4)
        q_all, src = noisy_queries(idx, DEV_QUERIES, g)

        # ---- 2. B5 at the dense shape ----
        lap("B5 at the dense shape")
        entry = dense_kernel_check(idx, q_all[:DENSE_TILE], card_s)

        # ---- 3. the Dev-size stream, blocked (B5) against direct ----
        lap("the Dev-size stream")
        idx.search_knn(q_all[:DENSE_TILE], TOPK)          # warm
        cuda_lib.reset_launches()
        f0 = idx.fallbacks
        t0 = time.perf_counter()
        res = idx.search_knn(q_all, TOPK)
        wall = time.perf_counter() - t0
        paths["dense bf16"] = dict(cuda_lib.LAUNCHES)
        blocked = result_arrays(res)
        del res
        n_tiles = -(-DEV_QUERIES // DENSE_TILE)
        check(paths["dense bf16"]["topm_dense"] == n_tiles * len(idx._store),
              f"B5 launches {paths['dense bf16']['topm_dense']} != "
              f"{n_tiles} tiles x {len(idx._store)} chunks")
        q_tile = q_all[:DENSE_TILE]
        tile_ms = time_ms(lambda: idx.drain_tile(
            idx.dispatch_tile(q_tile, TOPK), DENSE_TILE), 3, 1)
        idx.selection = "direct"
        t0 = time.perf_counter()
        direct = result_arrays(idx.search_knn(q_all, TOPK))
        wall_d = time.perf_counter() - t0
        direct_ms = time_ms(lambda: idx.drain_tile(
            idx.dispatch_tile(q_tile, TOPK), DENSE_TILE), 2, 1)
        idx.selection = "auto"
        same_topk(blocked, direct, "dense bf16 blocked vs direct")
        hit = float((blocked[0][:, 0] == src.cpu().numpy()).mean())
        check(hit > 0.99, f"the source doc tops only {hit:.4f} of queries")
        # the tile's bound: every doc read once against the bf16 products;
        # this design also writes each chunk's f32 slab and B5 reads it
        flops = 2 * DENSE_TILE * DENSE_DIM * N_DOCS
        b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
        slab_ms, _ = bound(nbytes + 2 * DENSE_TILE * DENSE_CHUNK
                           * len(idx._store) * 4, flops, BF16_OPS_PER_S)
        log(f"dense bf16 stream: {DEV_QUERIES} queries, k {TOPK}, "
            f"search_knn {wall:.3f} s = {DEV_QUERIES / wall:.1f} QPS "
            f"(direct path {wall_d:.3f} s); a {DENSE_TILE}-query tile "
            f"{tile_ms:.2f} ms blocked ({DENSE_TILE / tile_ms * 1e3:.0f} QPS "
            f"device), {direct_ms:.2f} ms direct, bound {b_ms:.2f} ms "
            f"({b_by}; {slab_ms:.2f} ms with the slabs' traffic); fallbacks "
            f"{idx.fallbacks - f0}; == the direct path (scores bit-equal, ids"
            f" tie-equal); source doc first for {hit:.4f}; card {card_s}")
        profile_tile(f"dense bf16 tile ({DENSE_TILE} queries x {N_DOCS} "
                     f"docs)", lambda: idx.drain_tile(
                         idx.dispatch_tile(q_tile, TOPK), DENSE_TILE), card_s)
        del direct

        # ---- 4. a forced certificate failure ----
        lap("a forced certificate failure")
        c, b = len(idx._store) // 2, DENSE_CHUNK // DENSE_BLOCK // 2
        rows = slice(b * DENSE_BLOCK, (b + 1) * DENSE_BLOCK)
        saved = idx._store[c][rows].clone()
        near = q_all[:1] + 0.05 * torch.nn.functional.normalize(torch.randn(
            DENSE_BLOCK, DENSE_DIM, generator=g, device=dev), dim=1)
        idx._store[c][rows] = torch.nn.functional.normalize(
            near, dim=1).bfloat16()
        f0 = idx.fallbacks
        forced = result_arrays(idx.search_knn(q_tile, TOPK))
        check(idx.fallbacks == f0 + 1, "the forced tile did not rerun")
        idx.selection = "direct"
        same_topk(forced, result_arrays(idx.search_knn(q_tile, TOPK)),
                  "forced fallback vs direct")
        idx.selection = "auto"
        lo = c * DENSE_CHUNK + b * DENSE_BLOCK
        in_blk = int(((forced[0][0] >= lo)
                      & (forced[0][0] < lo + DENSE_BLOCK)).sum())
        check(in_blk == TOPK, f"{in_blk} of the top-{TOPK} in the block")
        idx._store[c][rows] = saved
        del saved, forced
        log(f"forced certificate failure: a {DENSE_BLOCK}-doc block of "
            f"near-copies of query 0 (m-th value above the merged k-th); the "
            f"tile reran on the direct path and equals it; all {TOPK} hits "
            f"of query 0 in the block")

        # ---- 5. the int8 layout ----
        lap("the int8 layout")
        t0 = time.perf_counter()
        idx.quantize = "int8"
        codes = idx._materialize()
        q8_s = time.perf_counter() - t0
        q8_bytes = (sum(x.nbytes for x in codes)
                    + sum(x.nbytes for x in idx._layout[2]))
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        got8 = result_arrays(idx.search_knn(q_all[:INT8_Q], TOPK))
        wall8 = time.perf_counter() - t0
        paths["dense int8"] = dict(cuda_lib.LAUNCHES)
        tile8_ms = time_ms(lambda: idx.drain_tile(
            idx.dispatch_tile(q_tile, TOPK), DENSE_TILE), 3, 1)
        idx.selection = "direct"
        same_topk(got8, result_arrays(idx.search_knn(q_all[:INT8_Q], TOPK)),
                  "dense int8 blocked vs the code-exact direct path")
        idx.selection = "auto"
        agree = float(np.mean([len(set(a[:10]) & set(b_[:10])) / 10 for a, b_
                               in zip(got8[0], blocked[0][:INT8_Q])]))
        log(f"dense int8: codes + scales {q8_bytes / 1e9:.2f} GB (bf16 "
            f"{nbytes / 1e9:.2f} GB), quantized on the card in {q8_s:.1f} s; "
            f"{INT8_Q} queries in {wall8:.3f} s = {INT8_Q / wall8:.1f} QPS; "
            f"a tile {tile8_ms:.2f} ms (bf16 {tile_ms:.2f} ms); == the "
            f"code-exact direct path (scores bit-equal, ids tie-equal); top-10"
            f" overlap with bf16 {agree:.4f}; card {card_s}")
        peak_int8 = torch.cuda.max_memory_allocated(dev)
        # the first tile's answers, for the host-array load in step 9
        head = {"bf16": (blocked[0][:DENSE_TILE], blocked[1][:DENSE_TILE]),
                "int8": (got8[0][:DENSE_TILE], got8[1][:DENSE_TILE])}

        # ---- 5b. the doc-sharded search (phase 10b) ----
        lap("phase 10b, the doc-sharded search")
        mesh_dense_phase(dev, idx, codes, q_all, card_s, tmp)
        idx.quantize = None
        del codes, got8
        idx._materialize()
        free()

        # ---- 6. served: in process and over HTTP ----
        lap("served")
        reqs = list(q_all[:SERVED_Q].cpu().numpy())
        want = result_arrays(idx.search_knn(q_all[:SERVED_Q], TOPK))
        backend = DenseTileBackend(idx, topk=TOPK, widths=(8, 64))
        server = RetrievalServer(backend)
        server.warmup(reqs[:64], passes=1)
        cuda_lib.reset_launches()
        server.start()
        try:
            res, s_served = serve_requests(server, reqs)
            paths["served dense"] = dict(cuda_lib.LAUNCHES)
            lone = server.search(reqs[0])
            same_topk(result_arrays(res), want, "served vs search_knn",
                      rtol=1e-5)
            same_topk(result_arrays([lone]), (want[0][:1], want[1][:1]),
                      "a lone request (8-wide rung) vs search_knn",
                      rtol=1e-5)
            httpd = serve_http(server, "127.0.0.1", 0, block=False)
            import threading
            th = threading.Thread(target=httpd.serve_forever, daemon=True)
            th.start()
            try:
                base = f"http://127.0.0.1:{httpd.server_address[1]}"
                check(http_json(f"{base}/healthz")["ok"], "healthz")
                body = {"queries": [{"id": f"q{i}", "vector": reqs[i].tolist()}
                                    for i in range(8)], "topk": 100}
                got = http_json(f"{base}/search", body)["results"]
                for i in range(8):
                    ids, sc = server.search(reqs[i], topk=100)
                    tie_equal_topk(list(map(int, got[f"q{i}"])),
                                   list(got[f"q{i}"].values()), ids, sc,
                                   rtol=1e-6)
                st = http_json(f"{base}/stats")
                check(st["n_requests"] >= SERVED_Q + 9, f"stats {st}")
            finally:
                httpd.shutdown()
                httpd.server_close()
        finally:
            server.stop()
        log(f"served dense: {SERVED_Q} requests in {s_served:.3f} s = "
            f"{SERVED_Q / s_served:.1f} QPS (widths 8, 64) == search_knn "
            f"(tie-equal, rtol 1e-5); HTTP POST of 8 vectors == "
            f"server.search, /healthz, /stats; server {server.stats()}; "
            f"card {card_s}")

        # ---- 7. text: LlamaBiDense at Llama-3.2-1B width ----
        lap("text through LlamaBiDense")
        dense_model = LlamaBiDense(model.params, model.config)
        tok = StandInTokenizer(VOCAB)
        rng = np.random.default_rng(seed + 5)
        texts = [(f"t{i}", " ".join(f"w{x}" for x in rng.integers(
            0, VOCAB, int(rng.integers(5, 33))))) for i in range(N_TEXTS)]
        loader = DataLoader(texts, TILE, LlamaDenseCollectionCollator(tok, 64))
        t0 = time.perf_counter()
        q_text = torch.cat([dense_model.encode(b["input_ids"],
                                               b["attention_mask"])
                            for b in loader])
        enc_s = time.perf_counter() - t0
        check(q_text.shape == (N_TEXTS, DENSE_DIM)
              and bool(torch.isfinite(q_text).all()), "text reps")
        text_res = result_arrays(idx.search_knn(q_text, TOPK))
        idx.selection = "direct"
        same_topk(text_res, result_arrays(idx.search_knn(q_text, TOPK)),
                  "text blocked vs direct")
        idx.selection = "auto"
        # eval_dense's task bodies over stand-in documents
        corpus = os.path.join(tmp, "dense_corpus.tsv")
        with open(corpus, "w") as f:
            for d in range(DOC_TEXTS):
                words = rng.integers(0, VOCAB, int(rng.integers(40, 200)))
                f.write(f"p{d}\t{' '.join(f'w{x}' for x in words)}\n")
        qpath = os.path.join(tmp, "dense_queries.tsv")
        with open(qpath, "w") as f:
            for qid, text in texts:
                f.write(f"{qid}\t{text}\n")
        emb_dir = os.path.join(tmp, "dense_embeds")
        out_dir = os.path.join(tmp, "dense_out")
        common = ["--data_source", "msmarco", "--eval_batch_size", "128",
                  "--device", str(dev)]
        t0 = time.perf_counter()
        eval_dense.write_doc_embeds(eval_dense.build_parser().parse_args(
            ["--task_name", "write_doc_embeds", "--corpus_path", corpus,
             "--doc_embed_dir", emb_dir, "--doc_max_length", "192"]
            + common), model=dense_model, tokenizer=tok)
        emb_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_dense.dense_retrieval(eval_dense.build_parser().parse_args(
            ["--task_name", "retrieval", "--query_path", qpath,
             "--doc_embed_dir", emb_dir, "--out_dir", out_dir,
             "--query_max_length", "64", "--top_k", str(TOPK)] + common),
            model=dense_model, tokenizer=tok)
        ret_s = time.perf_counter() - t0
        with open(os.path.join(out_dir, "run.json")) as f:
            run = json.load(f)
        check(len(run) == N_TEXTS, f"dense run.json has {len(run)} queries")
        local = eval_dense.LocalDenseRetriever(DENSE_DIM, device=dev)
        local.index_encoded_data(emb_dir)
        check(local.indexer.ntotal == DOC_TEXTS, "LocalDenseRetriever size")
        res_l = local.get_top_docs(q_text, TOPK)
        for (qid, _), (ids, sc) in zip(texts, res_l):
            w = ranked(run[qid])
            tie_equal_topk([d for d, _ in w], [s_ for _, s_ in w],
                           list(map(str, ids)), sc, rtol=1e-4, atol=1e-6)
        qrel = {}
        for qid, _ in texts:
            top = ranked(run[qid])[:10]
            above = [d for d, s_ in top if s_ > top[-1][1]]
            if above:
                qrel[qid] = {above[int(rng.integers(len(above)))]: 1}
        qrel_path = os.path.join(tmp, "dense_qrel.json")
        with open(qrel_path, "w") as f:
            json.dump(qrel, f)
        eval_dense.main(["--task_name", "evaluate_msmarco",
                         "--eval_qrel_path", qrel_path, "--eval_run_path",
                         os.path.join(out_dir, "run.json"), "--eval_metric",
                         "['mrr_10','recall']", "--out_dir", out_dir])
        with open(os.path.join(out_dir, "perf.json")) as f:
            perf = json.load(f)
        want_perf = {"mrr_10": {"mrr_10": metrics.mrr_k(run, qrel, 10)},
                     "recall": metrics.evaluate(run, qrel, "recall")}
        check(perf == want_perf, f"perf.json {perf} != {want_perf}")
        log(f"dense text: {N_TEXTS} texts encoded by LlamaBiDense (Llama-"
            f"3.2-1B width, random bf16 weights) in {enc_s:.2f} s, searched "
            f"== the direct path; write_doc_embeds over {DOC_TEXTS} stand-in"
            f" docs (doc_max_length 192) {emb_s:.1f} s; retrieval to run.json"
            f" {ret_s:.1f} s, == LocalDenseRetriever over plan.json (tie-"
            f"equal, rtol 1e-4); evaluate_msmarco perf.json == the metrics "
            f"of the run (MRR@10 {perf['mrr_10']['mrr_10']:.4f}, {len(qrel)}"
            f" queries with a qrel); card {card_s}")

        # ---- 8. the server CLI as users start it ----
        lap("the server CLI")
        cut = DenseFlatIndexer(device=dev, chunk=DENSE_CHUNK)
        cut.init_index(DENSE_DIM)
        cut.add_batch(range(CLI_DENSE_DOCS), idx._store[0][:CLI_DENSE_DOCS])
        dense_dir = os.path.join(tmp, "dense_cut")
        cut.serialize(dense_dir)
        # emptied, not only dropped: the served backend and the HTTP
        # handler still reference it
        idx.init_index(DENSE_DIM)
        del idx
        free()
        logs = (os.path.join(tmp, "cli_dense.log"),
                os.path.join(tmp, "cli_sparse.log"))
        t0 = time.perf_counter()
        procs.append(start_cli(["--dense_index_dir", dense_dir, "--topk",
                                str(TOPK), "--widths", "8,64"], logs[0]))
        cut_dir = os.path.join(tmp, "index_cut")
        procs.append(start_cli(["--index_dir", cut_dir, "--topk", str(TOPK),
                                "--max_need_jobs", "32"], logs[1]))
        ports, up = zip(*[wait_healthy(p, lg) for p, lg in zip(procs, logs)])
        up_s = time.perf_counter() - t0
        qd = q_all[:CLI_Q]
        body = {"queries": [{"id": f"q{i}", "vector": v.tolist()}
                            for i, v in enumerate(qd.cpu().numpy())]}
        got = http_json(f"http://127.0.0.1:{ports[0]}/search", body)["results"]
        for i, (ids, sc) in enumerate(cut.search_knn(qd, TOPK)):
            tie_equal_topk(list(map(int, got[f"q{i}"])),
                           list(got[f"q{i}"].values()), ids, sc, rtol=1e-5)
        del cut
        # sparse: 48-term stream queries need 48 jobs on the cut (> 32: the
        # C++ hot lane), 16-term ones 16 (the device lane)
        sidx = SparseIndex.load(cut_dir)
        eng = SegsortEngine(sidx, topk=TOPK, device=dev)
        qt, qv, _ = dev_stream(np.random.default_rng(seed + 6))
        qt, qv = qt[:2 * CLI_Q], qv[:2 * CLI_Q].copy()
        qv[CLI_Q:, 16:] = 0.0
        need = eng.job_need(qt, qv)
        check(int((need > 32).sum()) == CLI_Q, f"job needs {need}")
        body = {"queries": [{"id": f"s{i}", "terms": qt[i][qv[i] > 0].tolist(),
                             "vals": qv[i][qv[i] > 0].tolist()}
                            for i in range(2 * CLI_Q)]}
        got = http_json(f"http://127.0.0.1:{ports[1]}/search", body)["results"]
        st = http_json(f"http://127.0.0.1:{ports[1]}/stats")
        check(st["n_hot"] == CLI_Q, f"hot lane took {st['n_hot']} queries")
        scores, rows = eng.finalize(eng.retrieve_tile_async(
            None, TOPK, sparsified=(qt, qv)))
        for i in range(2 * CLI_Q):
            fin = np.isfinite(scores[i]) & (rows[i] < eng.n_docs)
            g_ = ranked(got[f"s{i}"])
            tie_equal_topk([sidx.doc_ids[r] for r in rows[i][fin]],
                           scores[i][fin], [d for d, _ in g_],
                           [s_ for _, s_ in g_], rtol=1e-6)
        log(f"server CLI: --dense_index_dir over a serialized cut of "
            f"{CLI_DENSE_DOCS} docs and --index_dir over phase 5's cut "
            f"(default --hot_lane cpp, --max_need_jobs 32), both healthy "
            f"{up_s:.1f} s after launch ({up[0]:.1f} / {up[1]:.1f} s); "
            f"{CLI_Q} vector POSTs == the in-process index (tie-equal, rtol "
            f"1e-5); {2 * CLI_Q} sparse POSTs == the device engine (tie-"
            f"equal, rtol 1e-6), {st['n_hot']} of them on the C++ hot lane "
            f"(hot p50 {st.get('hot_latency_p50_ms')} ms)")
        del eng, sidx
        stop_cli(procs)
        free()

        # ---- 9. the file-based load at full depth ----
        lap("a host-array load at full depth")
        peak_steps = torch.cuda.max_memory_allocated(dev)
        peak_host = host_load(dev, seed + 3, q_all[:DENSE_TILE], head,
                              nbytes, q8_bytes, card_s)
    finally:
        stop_cli(procs)
    peak = max(torch.cuda.max_memory_allocated(dev), peak_int8, peak_steps,
               peak_host)
    check(peak < 70e9, f"phase 6 peak card memory {peak / 1e9:.2f} GB")
    log(f"phase 6 (dense path): {time.perf_counter() - t_phase:.1f} s, peak "
        f"card memory {peak / 1e9:.2f} GB allocated; card {card_s}")
    free()
    return paths, entry


# ---- phase 7: the offline pipeline from a checkpoint on disk

CKPT_DOCS = 16_384            # docs indexed through eval_sparse's body
CKPT_DOC_LEN = 192            # doc_max_length
CKPT_L0_D = 128               # postings kept per doc (MSMARCO's 1.13B / 8.8M)
CKPT_T = 1024                 # --index_sparsify_t of the packed read
CKPT_QUERIES = 1_024
CKPT_QUERY_WORDS = 16         # a query is the first words of its doc
CSR_DOCS = 1_105_228          # 1/8 of MSMARCO's 8,841,823 docs
C3_CHUNKS = 4                 # dense chunks serialized (1,048,576 x 2048)
LORA_R, LORA_ALPHA = 16, 32
# merged vs unmerged reps, relative L2: folding the delta in rounds each
# of the 112 projection matrices to bf16 once more (2^-9 relative), which
# adds up over the layers as a random walk to ~sqrt(112) * 2^-9 = 0.02
MERGE_RTOL = 0.05


class TopKReps:
    """An encoder that keeps each rep's top ``k`` entries on the device:
    random weights give reps about half dense, which no trained model
    gives; ``k`` sets the postings per doc (or terms per query)."""

    def __init__(self, model, k: int):
        self.model = model
        self.k = k
        self.vocab_size = model.vocab_size

    def encode(self, input_ids, attention_mask):
        """The reps kept to their top ``k``; of a hybrid model's (sparse,
        dense) pair, the sparse head's, the dense passed through."""
        out = self.model.encode(input_ids, attention_mask)
        reps = out[0] if isinstance(out, tuple) else out
        vals, terms = torch.topk(reps, self.k, dim=1)
        kept = torch.zeros_like(reps).scatter_(1, terms, vals)
        return (kept, *out[1:]) if isinstance(out, tuple) else kept


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def rss_bytes() -> int:
    """This process's resident memory now."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise KeyError("VmRSS")


def rss_growth(fn) -> tuple:
    """(fn(), the most the resident memory grew while it ran), sampled
    every 20 ms on a thread."""
    import threading

    base = rss_bytes()
    peak = [base]
    done = threading.Event()

    def sample():
        while not done.wait(0.02):
            peak[0] = max(peak[0], rss_bytes())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join(timeout=5)
    return out, max(peak[0], rss_bytes()) - base


def same_index(a, b, label: str) -> None:
    check(np.array_equal(a.offsets, b.offsets)
          and np.array_equal(a.doc_rows, b.doc_rows)
          and a.values.tobytes() == b.values.tobytes()
          and a.doc_ids == b.doc_ids and a.dim == b.dim,
          f"{label}: the indexes differ")


def checkpoint_phase(dev, model, seed: int, card_s: str, tmp: str) -> dict:
    """Phase 7: the offline pipeline from a checkpoint on disk: the
    Llama-3.2-1B architecture written and read back, an adapter merged,
    eval_sparse's indexing body over generated docs (packed read, full
    read, fallback), encode_queries and retrieval (from reps and from
    text) into run.json through B1, B4 and B5, evaluate_msmarco, the host
    CSR build at 1/8 of MSMARCO's depth, and a dense index streamed to
    disk and back. Returns the launch counts of the retrieval path."""
    from scaling_retriever_tpu_torch.evaluation import eval_sparse, metrics
    from scaling_retriever_tpu_torch.index.dense_index import \
        DenseFlatIndexer
    from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
    from scaling_retriever_tpu_torch.models import lora as lora_io
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
    from scaling_retriever_tpu_torch.models.hf_loader import (
        load_pretrained, save_pretrained)
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)

    def lap(step: str) -> None:
        log(f"phase 7 at {time.perf_counter() - t_phase:.1f} s: {step}")
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    rng = np.random.default_rng(seed + 7)
    tok = StandInTokenizer(VOCAB)

    # ---- 1. the checkpoint round trip at Llama-3.2-1B width ----
    lap("checkpoint round trip")
    ckpt = os.path.join(tmp, "ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_pretrained(model.params, model.config, ckpt)
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(ckpt, f))
               for f in os.listdir(ckpt))
    t0 = time.perf_counter()
    loaded, cfg = load_pretrained(ckpt, device=dev, **bf16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    src = dict(model.params.named_parameters())
    got = dict(loaded.named_parameters())
    check(src.keys() == got.keys() and all(
        got[k].dtype == src[k].dtype and torch.equal(got[k], src[k])
        for k in src), "the loaded parameters differ from those written")
    check(cfg.to_hf_config() == model.config.to_hf_config(),
          "the loaded config differs")
    log(f"checkpoint: Llama-3.2-1B architecture, {len(src)} tensors, "
        f"{size / 1e9:.2f} GB bf16 (model.safetensors + config.json); "
        f"save_pretrained {save_s:.2f} s ({size / save_s / 1e9:.2f} GB/s), "
        f"load_pretrained onto the card {load_s:.2f} s ({size / load_s / 1e9:.2f}"
        f" GB/s); every parameter bit-equal; card {card_s}")
    del loaded, got

    # ---- 2. an adapter over the checkpoint, merged ----
    lap("adapter")
    lcfg = lora_io.LoraConfig(r=LORA_R, lora_alpha=LORA_ALPHA,
                              base_model_name_or_path=ckpt)
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    lora = lora_io.init_lora_params(model.config, lcfg, g, device=dev)
    for group in lora["layers"].values():
        for fac in group.values():
            fac["b"].copy_(torch.randn(fac["b"].shape, generator=g,
                                       device=dev) * 0.01)
    adapter = os.path.join(tmp, "adapter")
    lora_io.save_adapter(lora, lcfg, adapter)
    del lora
    t0 = time.perf_counter()
    unmerged = LlamaBiSparse.load_from_lora(adapter, merge_peft=False,
                                            device=dev, **bf16)
    torch.cuda.synchronize()
    lora_s = time.perf_counter() - t0
    probe = [" ".join(f"w{x}" for x in rng.integers(0, VOCAB, 48))
             for _ in range(TILE)]
    ids, mask = tok(probe, length=64)
    base_reps = model.encode(ids, mask)
    before = unmerged.encode(ids, mask)
    t0 = time.perf_counter()
    merged = unmerged.merge_and_unload()
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    after = merged.encode(ids, mask)
    again = unmerged.encode(ids, mask)
    d_adapter, d_merge = rel_l2(before, base_reps), rel_l2(after, before)
    d_source = rel_l2(again, after)
    check(d_merge <= MERGE_RTOL, f"merged reps differ from the unmerged "
          f"model's by {d_merge:.4f} (relative L2) > {MERGE_RTOL}")
    check(d_adapter >= 4 * d_merge, f"the adapter moves the reps by only "
          f"{d_adapter:.4f} against a merge error of {d_merge:.4f}")
    check(unmerged.lora is None and d_source <= MERGE_RTOL / 10,
          f"the merge's source encodes {d_source:.4f} away from the merged "
          f"model")
    log(f"adapter: r {LORA_R}, alpha {LORA_ALPHA} over the 7 projections "
        f"(B ~ N(0, 0.01) from the seed), written by save_adapter, loaded by"
        f" load_from_lora with its base in {lora_s:.2f} s, merged in place "
        f"in {merge_s:.3f} s; relative L2 of {TILE} reps: adapter vs base "
        f"{d_adapter:.4f}, merged vs unmerged {d_merge:.4f} (limit "
        f"{MERGE_RTOL}: each bf16 weight rounded once more), the source "
        f"after the merge vs merged {d_source:.6f}; card {card_s}")
    del unmerged, base_reps, before, after, again
    free()

    # ---- 3. indexing through eval_sparse's body ----
    lap("indexing")
    corpus = os.path.join(tmp, "corpus.tsv")
    doc_words = []
    with open(corpus, "w") as f:
        for d in range(CKPT_DOCS):
            words = [f"w{x}" for x in rng.integers(
                0, VOCAB, int(rng.integers(40, 2 * CKPT_DOC_LEN)))]
            doc_words.append(words)
            f.write(f"p{d}\t{' '.join(words)}\n")
    docs_model = TopKReps(merged, CKPT_L0_D)

    def index_args(index_dir, t, path=corpus):
        return eval_sparse.build_parser().parse_args(
            ["--task_name", "indexing", "--corpus_path", path,
             "--index_dir", index_dir, "--eval_batch_size", str(TILE),
             "--doc_max_length", str(CKPT_DOC_LEN), "--data_source",
             "msmarco", "--index_sparsify_t", str(t), "--device", str(dev)])

    arms = {}
    for arm, t in (("packed", CKPT_T), ("full", 0)):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = eval_sparse.sparse_index(
            index_args(os.path.join(tmp, f"index_{arm}"), t),
            model=docs_model, tokenizer=tok)
        wall = time.perf_counter() - t0
        arms[arm] = out
        log(f"indexing ({arm} read, --index_sparsify_t {t}): {CKPT_DOCS} "
            f"docs in {wall:.1f} s, {CKPT_DOCS / wall:.1f} docs/s, "
            f"fallback batches {out['indexer'].n_fallback_batches}, L0_d "
            f"{out['stats']['L0_d']:.2f}, {out['index'].nnz} postings, peak "
            f"card memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} "
            f"GB; card {card_s}")
    index = arms["packed"]["index"]
    same_index(index, arms["full"]["index"], "packed vs full read")
    check(arms["packed"]["indexer"].n_fallback_batches == 0
          and index.nb_docs() == CKPT_DOCS
          and index.nnz <= CKPT_DOCS * CKPT_L0_D, "the packed arm")
    t0 = time.perf_counter()
    index.save(os.path.join(tmp, "index_copy"))
    save_idx_s = time.perf_counter() - t0
    same_index(SparseIndex.load(os.path.join(tmp, "index_packed")), index,
               "the saved index")
    # the unwrapped model (reps about half dense) over one batch: the
    # packed read falls back to the full read
    one = os.path.join(tmp, "one_batch.tsv")
    with open(one, "w") as f:
        for d in range(TILE):
            f.write(f"p{d}\t{' '.join(doc_words[d])}\n")
    fb = eval_sparse.sparse_index(index_args(os.path.join(tmp, "fb"),
                                             CKPT_T, one),
                                  model=merged, tokenizer=tok)
    fb_full = eval_sparse.sparse_index(
        index_args(os.path.join(tmp, "fb_full"), 0, one), model=merged,
        tokenizer=tok)
    check(fb["indexer"].n_fallback_batches >= 1,
          "the unwrapped batch did not fall back")
    same_index(fb["index"], fb_full["index"], "fallback vs full read")
    n_fb = fb["indexer"].n_fallback_batches
    log(f"indexing: packed == full read (bit-equal); index.save "
        f"{save_idx_s:.2f} s; one unwrapped batch: {n_fb} fallback, L0_d "
        f"{fb['stats']['L0_d']:.0f}, index == the full read's")
    del arms, fb, fb_full
    free()

    # ---- 4. queries to run.json through B1, B4 and B5 ----
    lap("queries to run.json")
    picks = rng.choice(CKPT_DOCS, CKPT_QUERIES, replace=False)
    qpath = os.path.join(tmp, "queries.tsv")
    with open(qpath, "w") as f:
        for i, d in enumerate(picks):
            f.write(f"q{i}\t{' '.join(doc_words[d][:CKPT_QUERY_WORDS])}\n")
    qrel_path = os.path.join(tmp, "qrel.json")
    qrel = {f"q{i}": {f"p{d}": 1} for i, d in enumerate(picks)}
    with open(qrel_path, "w") as f:
        json.dump(qrel, f)
    q_model = TopKReps(merged, L0_Q)
    idx_dir = os.path.join(tmp, "index_packed")

    def args(task, out_dir, *extra):
        return eval_sparse.build_parser().parse_args(
            ["--task_name", task, "--index_dir", idx_dir, "--out_dir",
             out_dir, "--query_path", qpath, "--data_source", "msmarco",
             "--eval_batch_size", "128", "--query_max_length", "64",
             "--top_k", str(TOPK), "--device", str(dev), *extra])

    reps_path = os.path.join(tmp, "query_reps.npz")
    t0 = time.perf_counter()
    eval_sparse.encode_queries(args("encode_queries", tmp,
                                    "--query_reps_path", reps_path,
                                    "--reps_format", "sparse"),
                               model=q_model, tokenizer=tok)
    enc_s = time.perf_counter() - t0
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    eval_sparse.sparse_retrieval(args("retrieval", os.path.join(tmp, "r1"),
                                      "--query_reps_path", reps_path))
    ret_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    t0 = time.perf_counter()
    eval_sparse.sparse_retrieval(args("retrieval", os.path.join(tmp, "r2")),
                                 model=q_model, tokenizer=tok)
    text_s = time.perf_counter() - t0
    runs = []
    for r in ("r1", "r2"):
        with open(os.path.join(tmp, r, "run.json")) as f:
            runs.append(json.load(f))
    qids = [f"q{i}" for i in range(CKPT_QUERIES)]
    same_run(runs[1], runs[0], qids, 1e-5, "run.json from text vs from reps")
    z = np.load(reps_path, allow_pickle=True)
    check(z["ids"].tolist() == qids, "query_reps ids")
    plain = ss.SegsortEngine(index, topk=TOPK, ops=ss.PLAIN, device=dev)
    run_plain = engine_run(plain, z["q_terms"], z["q_vals"], qids,
                           index.doc_ids, index.nb_docs())
    same_run(runs[0], run_plain, qids, 1e-5, "kernel path vs plain path")
    eval_sparse.evaluate_msmarco(eval_sparse.build_parser().parse_args(
        ["--task_name", "evaluate_msmarco", "--eval_qrel_path", qrel_path,
         "--eval_run_path", os.path.join(tmp, "r1", "run.json"),
         "--eval_metric", "['mrr_10','recall']", "--out_dir",
         os.path.join(tmp, "r1")]))
    with open(os.path.join(tmp, "r1", "perf.json")) as f:
        perf = json.load(f)
    want_perf = {"mrr_10": {"mrr_10": metrics.mrr_k(runs[0], qrel, 10)},
                 "recall": metrics.evaluate(runs[0], qrel, "recall")}
    check(perf == want_perf, f"perf.json {perf} != {want_perf}")
    lens = [len(runs[0][q]) for q in qids]
    log(f"queries: {CKPT_QUERIES} doc-prefix texts ({CKPT_QUERY_WORDS} "
        f"words, top {L0_Q} terms kept); encode_queries {enc_s:.2f} s; "
        f"retrieval from the reps file {ret_s:.2f} s, from text {text_s:.2f}"
        f" s; the two run.json tie-equal (rtol 1e-5), == the plain-ops "
        f"engine (tie-equal, rtol 1e-5); {min(lens)}-{max(lens)} docs per "
        f"query; MRR@10 {perf['mrr_10']['mrr_10']:.4f}, recall@1000 "
        f"{perf['recall']['recall_1000']:.4f}; launches {launches}; card "
        f"{card_s}")
    del plain, q_model, docs_model
    free()

    # ---- 5. the host CSR build at 1/8 of MSMARCO's depth ----
    lap("host CSR build")
    order = np.argsort(index.doc_rows, kind="stable")
    base_rows = index.doc_rows[order].astype(np.int64)
    term_of = np.repeat(np.arange(index.dim, dtype=np.int64),
                        np.diff(index.offsets))[order]
    vals_of = index.values[order]
    reps_n = -(-CSR_DOCS // index.nb_docs())
    rows = (base_rows[None, :] + (np.arange(reps_n, dtype=np.int64)
                                  * index.nb_docs())[:, None]).ravel()
    keep = rows < CSR_DOCS
    rows = rows[keep].astype(np.int32)
    cols = np.tile(term_of, reps_n)[keep]
    vals = np.tile(vals_of, reps_n)[keep]
    del keep
    t0 = time.perf_counter()
    big = SparseIndex.from_triples(rows, cols, vals,
                                   [f"p{d}" for d in range(CSR_DOCS)],
                                   index.dim)
    csr_s = time.perf_counter() - t0
    check(big.nnz == len(rows) and big.nb_docs() == CSR_DOCS,
          "the replicated CSR")
    n_full = N_DOCS * K_PER_DOC
    log(f"host CSR build: SparseIndex.from_triples over {big.nnz} postings "
        f"({CSR_DOCS} docs, step 3's card reps replicated with shifted "
        f"rows) in {csr_s:.2f} s ({big.nnz / csr_s / 1e6:.1f} M postings/s);"
        f" at MSMARCO's depth ({n_full} postings) that rate gives "
        f"{csr_s * n_full / big.nnz:.1f} s (extrapolated, linear; the sort "
        f"is n log n)")
    del big, rows, cols, vals, base_rows, order, term_of, vals_of

    # ---- 6. a dense index streamed to disk and back ----
    lap("dense serialize")
    import shutil

    free_disk = shutil.disk_usage(tmp).free
    need = C3_CHUNKS * DENSE_CHUNK * DENSE_DIM * 4
    check(free_disk > 1.2 * need, f"disk: {free_disk / 1e9:.1f} GB free, "
          f"the file needs {need / 1e9:.1f} GB")
    ix = empty_dense_index(dev)
    for s0, v in corpus_chunks(dev, seed + 9, C3_CHUNKS * DENSE_CHUNK):
        ix.add_batch(range(s0, s0 + len(v)), v)
    torch.cuda.synchronize()
    ddir = os.path.join(tmp, "dense_index")
    t0 = time.perf_counter()
    _, grew = rss_growth(lambda: ix.serialize(ddir))
    ser_s = time.perf_counter() - t0
    fsize = os.path.getsize(os.path.join(ddir, DenseFlatIndexer.INDEX_FILE))
    chunk_bytes = DENSE_CHUNK * DENSE_DIM * 4
    check(grew < 2 * chunk_bytes, f"serialize grew the host memory by "
          f"{grew / 1e9:.2f} GB >= two f32 chunks ({2 * chunk_bytes / 1e9:.2f}"
          f" GB)")
    back = empty_dense_index(dev)
    t0 = time.perf_counter()
    back.deserialize(ddir)
    des_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    q, _ = noisy_queries(ix, DENSE_TILE, g)
    same_topk(result_arrays(back.search_knn(q, TOPK)),
              result_arrays(ix.search_knn(q, TOPK)), "deserialized tile")
    limit_gb = 2 * chunk_bytes / 1e9
    log(f"dense serialize: {ix.ntotal} x {DENSE_DIM} ({C3_CHUNKS} chunks, "
        f"bf16 on the card) streamed to a {fsize / 1e9:.2f} GB f32 npz in "
        f"{ser_s:.1f} s ({fsize / ser_s / 1e9:.2f} GB/s), host memory grew "
        f"{grew / 1e9:.2f} GB (limit two f32 chunks, {limit_gb:.2f} GB); "
        f"deserialize {des_s:.1f} s; a {DENSE_TILE}-query tile bit-equal "
        f"after the round trip; card {card_s}")
    del ix, back, q
    free()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase 7 (checkpoint pipeline): {time.perf_counter() - t_phase:.1f}"
        f" s, peak card memory {peak / 1e9:.2f} GB allocated; card {card_s}")
    return {"checkpoint pipeline": launches}


# ---- phase 8: training on the card

TRAIN_Q, TRAIN_NEGS = 8, 16   # the recipe's micro batch (bench_train.py:3-10)
TRAIN_QLEN, TRAIN_DLEN = 64, 128
TRAIN_QUERIES = 64            # train.jsonl examples: 8 micro batches an epoch
TRAIN_DOCS = 2_048
TRAIN_STEPS = 8               # timed: the median of the last 6
FIXED_STEPS = 6               # then one fixed batch, which the loss must fit
# 10x the recipe's 1e-4: six steps of the recipe's rate move the loss less
# than the dropout's noise does
TRAIN_LR = 1e-3
REG_T = 1000 // 3             # the recipe's ramp horizon (max_steps // 3)
SERVE_DOCS = 4_096
SERVE_QUERIES = 256
DENSE_STEPS = 5
MNTP_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "mntp", "llama3_1b_msmarco.json")
MNTP_STEPS = 5
MNTP_EVAL_ROWS = 64
# remat full against none, relative L2 per LoRA gradient: the recompute
# runs the same kernels on the same inputs (bit-equal expected); the limit
# is bf16's unit roundoff, 2^-8
REMAT_RTOL = 2.0 ** -8


@contextlib.contextmanager
def step_times():
    """The wall time of every Trainer micro step in ms, the card
    synchronized before and after each."""
    from scaling_retriever_tpu_torch.training import trainer as tm

    orig = tm.Trainer._train_step
    out = []

    def timed(self, batch, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = orig(self, batch, step)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return metrics

    tm.Trainer._train_step = timed
    try:
        yield out
    finally:
        tm.Trainer._train_step = orig


def read_log(out: str) -> list:
    with open(os.path.join(out, "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def step_report(label, ms, flops, tokens, peak, card_s) -> float:
    """Log the median step after two warm-up steps; returns it."""
    med = float(np.median(ms[2:]))
    log(f"{label}: {med:.1f} ms per micro step (median of {len(ms) - 2} "
        f"after 2 warm-up; all {[round(x, 1) for x in ms]}), "
        f"{tokens / med * 1e3:.0f} tokens/s, {flops / 1e12:.1f} TFLOP per "
        f"step, {flops / med / 1e9:.1f} TFLOP/s = "
        f"{100 * flops / med * 1e3 / BF16_OPS_PER_S:.1f}% of the "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak, peak card "
        f"memory {peak / 1e9:.2f} GB; card {card_s}")
    return med


MESH_TRAIN_STEPS = 2
# name: (data, model, entries of the card, fsdp)
TRAIN_MESHES = {"one entry": (1, 1, 1, False),
                "data 4, fsdp": (4, 1, 4, True),
                "data 2, model 2": (2, 2, 4, False)}


def mesh_training(dev, enc, base_cfg, base_args, lc, batches, seed: int,
                  card_s: str, tmp: str) -> None:
    """Phase 10c: MESH_TRAIN_STEPS optimizer steps of the Trainer at the
    recipe's micro batch (LoRA dropout on) on each of TRAIN_MESHES over
    one card, from the same factors: the losses bit-equal across meshes
    (one global step on one card); the share of parameter bytes whose
    spec shards."""
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
    from scaling_retriever_tpu_torch.models.lora import init_lora_params
    from scaling_retriever_tpu_torch.parallel import partitioning
    from scaling_retriever_tpu_torch.parallel.mesh import make_mesh
    from scaling_retriever_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    losses, notes = {}, []
    for name, (data, model, n, fsdp) in TRAIN_MESHES.items():
        g = torch.Generator(device=dev).manual_seed(seed + 82)
        e = LlamaBiSparse(enc.params, base_cfg,
                          init_lora_params(base_cfg, lc, g, device=dev), lc)
        out = os.path.join(tmp, "mesh_" + name.replace(" ", "_")
                           .replace(",", ""))
        args = dataclasses.replace(
            base_args, output_dir=out, lora_dropout=lc.lora_dropout,
            gradient_accumulation_steps=1, max_steps=MESH_TRAIN_STEPS,
            save_steps=None, resume_from_checkpoint=None, fsdp=fsdp,
            logging_steps=1)
        tr = Trainer(e, args, list(batches[:MESH_TRAIN_STEPS]),
                     mesh=make_mesh(data, model, devices=[dev] * n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        losses[name] = [x["loss"] for x in read_log(out)]
        audit = partitioning.shard_audit(enc.params, tr.param_shardings)
        share = audit["param_bytes_sharded"] / audit["param_bytes_total"]
        notes.append(f"{name}: losses {losses[name]}, {secs:.2f} s, "
                     f"{100 * share:.2f}% of {audit['param_bytes_total']} "
                     f"parameter bytes under a sharding spec")
        del tr, e
        free()
    first = next(iter(losses.values()))
    check(len(first) == MESH_TRAIN_STEPS
          and all(v == first for v in losses.values()),
          f"the Trainer's losses differ across meshes: {losses}")
    log(f"phase 10c, the Trainer at {TRAIN_Q} x (1 + {TRAIN_NEGS}), "
        f"{TRAIN_QLEN}/{TRAIN_DLEN} tokens, LoRA dropout {lc.lora_dropout}, "
        f"{MESH_TRAIN_STEPS} steps on meshes of one card: "
        f"{'; '.join(notes)}; bit-equal across meshes; "
        f"{time.perf_counter() - t_phase:.1f} s; card {card_s}")


DIST_GAS = 2          # 2 optimizer steps of 2 micro steps each


def distributed_training(dev, enc, base_cfg, base_args, lc, batches,
                         seed: int, card_s: str, tmp: str) -> None:
    """Phase 10d: the Trainer through torch.distributed (an NCCL world of
    one on ``dev``: the rank's rows of every batch, the reps gathered over
    the data group, the gradients all-reduced) against the single-process
    Trainer on the same batches and factors, fsdp on (replicated at data
    1, as the reference chooses), LoRA dropout on: losses and factors
    bit-equal; each arm's micro step time and peak memory."""
    import torch.distributed as dist

    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
    from scaling_retriever_tpu_torch.models.lora import init_lora_params
    from scaling_retriever_tpu_torch.parallel.mesh import make_mesh
    from scaling_retriever_tpu_torch.training.trainer import (Trainer,
                                                             tree_leaves)

    t_phase = time.perf_counter()

    def arm(name, mesh):
        g = torch.Generator(device=dev).manual_seed(seed + 83)
        e = LlamaBiSparse(enc.params, base_cfg,
                          init_lora_params(base_cfg, lc, g, device=dev), lc)
        out = os.path.join(tmp, "dist_" + name)
        args = dataclasses.replace(
            base_args, output_dir=out, lora_dropout=lc.lora_dropout,
            gradient_accumulation_steps=DIST_GAS, max_steps=2,
            save_steps=None, resume_from_checkpoint=None, fsdp=True,
            logging_steps=1)
        tr = Trainer(e, args, list(batches[:2 * DIST_GAS]), mesh=mesh)
        free()
        torch.cuda.reset_peak_memory_stats(dev)
        with step_times() as ms:
            tr.train()
        peak = torch.cuda.max_memory_allocated(dev)
        res = ([x["loss"] for x in read_log(out)],
               [t.detach().clone() for _, t in tree_leaves(tr.trainable)],
               ms, peak)
        del tr, e
        free()
        return res

    one = arm("one_process", make_mesh(devices=[dev]))
    cuda = dev.type == "cuda"      # gloo on the CPU, for a rehearsal
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method="file://" + os.path.join(
            tmp, "nccl_rendezvous"), rank=0, world_size=1,
        device_id=dev if cuda else None)
    try:
        mesh = make_mesh(1, 1, device=dev.type)
        check(mesh.distributed and mesh.device == dev, f"the distributed "
              f"mesh {mesh} is not over {dev}")
        world = arm("world_1", mesh)
    finally:
        dist.destroy_process_group()
    check(world[0] == one[0] and len(one[0]) == 2,
          f"the distributed Trainer's losses {world[0]} differ from the "
          f"single-process Trainer's {one[0]}")
    check(all(torch.equal(a, b) for a, b in zip(world[1], one[1])),
          "the distributed Trainer's LoRA factors differ from the "
          "single-process Trainer's")
    report = "; ".join(
        f"{name}: micro steps {[round(x, 1) for x in ms]} ms (the last "
        f"{ms[-1]:.1f} ms), peak card memory {peak / 1e9:.2f} GB"
        for name, (_, _, ms, peak) in (("single process", one),
                                       ("NCCL world of 1", world)))
    log(f"phase 10d, the Trainer through torch.distributed at {TRAIN_Q} x "
        f"(1 + {TRAIN_NEGS}), {TRAIN_QLEN}/{TRAIN_DLEN} tokens, fsdp, LoRA "
        f"dropout {lc.lora_dropout}, 2 optimizer steps of {DIST_GAS} micro "
        f"steps: losses {world[0]} and {len(world[1])} LoRA factors "
        f"bit-equal to the single-process Trainer's; {report}; "
        f"{time.perf_counter() - t_phase:.1f} s; card {card_s}")


def training_phase(dev, ckpt: str, seed: int, card_s: str, tmp: str) -> dict:
    """Phase 8: training at Llama-3.2-1B width from the checkpoint at
    ``ckpt``: sparse NCE timed, profiled and fitting one batch; remat full
    against none; accumulation and resume against an uninterrupted run;
    the trained adapter merged and served back into run.json through B1,
    B4 and B5; dense NCE; MNTP. Returns the launch counts of the adapter's
    retrieval path."""
    from scaling_retriever_tpu_torch.evaluation import eval_sparse
    from scaling_retriever_tpu_torch.models.config import ModelConfig
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
    from scaling_retriever_tpu_torch.models.lora import (LoraConfig,
                                                        init_lora_params)
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
    from scaling_retriever_tpu_torch.ops.pooling import sparse_pool
    from scaling_retriever_tpu_torch.parallel.mesh import shard_batch
    from scaling_retriever_tpu_torch.training import mntp, train_sparse
    from scaling_retriever_tpu_torch.training.trainer import (Trainer,
                                                             tree_leaves)

    t_phase = time.perf_counter()

    def lap(step: str) -> None:
        log(f"phase 8 at {time.perf_counter() - t_phase:.1f} s: {step}")
    log(f"phase 8 starts with {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        f" GB allocated on the card")
    rng = np.random.default_rng(seed + 80)
    tok = StandInTokenizer(VOCAB)
    cfg = ModelConfig.from_pretrained(ckpt)
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)

    # generated text: query i is the start of doc i (its positive), with
    # 24 other docs as its negatives
    corpus = os.path.join(tmp, "train_corpus.tsv")
    doc_words = []
    with open(corpus, "w") as f:
        for d in range(max(TRAIN_DOCS, SERVE_DOCS)):
            words = [f"w{x}" for x in rng.integers(0, VOCAB, 160)]
            doc_words.append(words)
            f.write(f"p{d}\t{' '.join(words)}\n")
    train_path = os.path.join(tmp, "train.jsonl")
    with open(train_path, "w") as f:
        for i in range(TRAIN_QUERIES):
            negs = [int(x) for x in rng.choice(TRAIN_DOCS, 25, replace=False)
                    if x != i][:24]
            f.write(json.dumps({
                "question": " ".join(doc_words[i][:80]), "pos_pid": f"p{i}",
                "neg_pids": [f"p{x}" for x in negs]}) + "\n")

    def argv(out, *extra):
        return ["--model_name_or_path", ckpt, "--corpus_path", corpus,
                "--train_path", train_path, "--output_dir", out,
                "--data_source", "msmarco", "--per_device_train_batch_size",
                str(TRAIN_Q), "--n_negs", str(TRAIN_NEGS),
                "--query_max_length", str(TRAIN_QLEN), "--doc_max_length",
                str(TRAIN_DLEN), "--fixed_length", "--bf16", "--lora_r", "16",
                "--lora_alpha", "32", "--lora_dropout", "0.1",
                "--learning_rate", str(TRAIN_LR), "--warmup_ratio", "0",
                "--max_steps", "1000", "--logging_steps", "1", "--device",
                str(dev), *extra]

    def stop_at(trainer, steps: int) -> None:
        # the recipe's 1000-step schedule and ramp, stopped early
        trainer.args = dataclasses.replace(trainer.args, max_steps=steps,
                                           reg_T=REG_T)

    groups = [(TRAIN_Q, TRAIN_QLEN), (TRAIN_Q * (1 + TRAIN_NEGS), TRAIN_DLEN)]
    tokens = sum(r * t for r, t in groups)

    # ---- 1. sparse NCE with LoRA at the recipe's micro batch ----
    lap("sparse NCE")
    out1 = os.path.join(tmp, "sparse")
    torch.cuda.reset_peak_memory_stats(dev)
    trainer, _ = train_sparse.build_training(argv(out1), "sparse",
                                             tokenizer=tok)
    stop_at(trainer, TRAIN_STEPS)
    with step_times() as ms:
        trainer.train()
    peak = torch.cuda.max_memory_allocated(dev)
    flops = model_flops(cfg, groups, lm_head=True, remat=False)
    step_ms = step_report(
        f"sparse NCE, LoRA r 16, dropout 0.1, bf16, remat none, "
        f"{TRAIN_Q} x (1 + {TRAIN_NEGS}) at {TRAIN_QLEN}/{TRAIN_DLEN} "
        f"tokens ({tokens} tokens)", ms, flops, tokens, peak, card_s)
    logs = read_log(out1)
    check(len(logs) == TRAIN_STEPS and all(
        np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
        and np.isfinite(e["rank"]) for e in logs), f"sparse NCE logs {logs}")
    real_loader = trainer.train_loader
    fixed = shard_batch(next(iter(real_loader)), trainer.mesh)
    trainer.train_loader = [fixed] * FIXED_STEPS
    stop_at(trainer, TRAIN_STEPS + FIXED_STEPS)
    trainer.train()
    fit = [e["loss"] for e in read_log(out1)[TRAIN_STEPS:]]
    check(all(np.isfinite(fit)) and fit[-1] < fit[0],
          f"the loss on one fixed batch did not fall: {fit}")
    log(f"sparse NCE on one fixed batch, learning rate {TRAIN_LR}: loss "
        f"{[round(x, 4) for x in fit]}; every loss and grad_norm finite")

    def one_step():
        trainer.micro_step += 1
        trainer.step += 1
        trainer._train_step(fixed, trainer.micro_step)

    profile_tile("sparse NCE micro step", one_step, card_s)
    # the sparse head alone, forward and backward, at the step's shapes
    free()
    pool_ms = 0.0
    for rows, seq in groups:
        lg = torch.randn(rows, seq, VOCAB, device=dev, dtype=torch.bfloat16,
                         requires_grad=True)
        mask = torch.ones(rows, seq, dtype=torch.int32, device=dev)
        g = torch.randn(rows, VOCAB, device=dev)
        pool_ms += time_ms(lambda: sparse_pool(lg, mask, cfg.hidden_size)
                           .backward(g), 5)
        del lg, g
        free()
    log(f"sparse_pool forward + backward over the step's logits "
        f"([{groups[1][0]}, {TRAIN_DLEN}, {VOCAB}] and [{TRAIN_Q}, "
        f"{TRAIN_QLEN}, {VOCAB}], bf16): {pool_ms:.2f} ms, "
        f"{100 * pool_ms / step_ms:.1f}% of the {step_ms:.1f} ms step; card "
        f"{card_s}")

    # ---- 2. remat full against none, dropout on ----
    lap("remat")
    enc = trainer.encoder
    base_cfg = enc.params.config

    def arm(remat):
        enc.params.config = dataclasses.replace(base_cfg, remat=remat)
        for _ in range(2):          # the second is reported
            free()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, _ = trainer._combined_loss(fixed, 1)
            grads = torch.autograd.grad(total, trainer._leaves)
            torch.cuda.synchronize()
            arm_ms = (time.perf_counter() - t0) * 1e3
        return grads, arm_ms, torch.cuda.max_memory_allocated(dev)

    g_none, none_ms, none_peak = arm(False)
    g_full, full_ms, full_peak = arm(True)
    enc.params.config = base_cfg
    rel = max(float((a.float() - b.float()).norm()
                    / b.float().norm().clamp_min(1e-30))
              for a, b in zip(g_full, g_none))
    same = all(torch.equal(a, b) for a, b in zip(g_full, g_none))
    check(rel <= REMAT_RTOL, f"remat full's LoRA gradients differ from "
          f"none's by {rel:.3e} (relative L2) > {REMAT_RTOL:.3e}")
    log(f"remat: {len(g_none)} LoRA gradients, dropout 0.1, one seed: full "
        f"vs none {'bit-equal' if same else f'relative L2 {rel:.3e}'} "
        f"(limit {REMAT_RTOL:.3e}); forward + backward {none_ms:.1f} ms, "
        f"peak {none_peak / 1e9:.2f} GB (none) against {full_ms:.1f} ms, "
        f"peak {full_peak / 1e9:.2f} GB (full); card {card_s}")
    del g_none, g_full

    # ---- 3. accumulation and resume, dropout 0 ----
    lap("accumulation and resume")
    lc0 = LoraConfig(r=16, lora_alpha=32, lora_dropout=0.0,
                     base_model_name_or_path=ckpt)
    batches = list(itertools.islice(iter(real_loader), 6))

    def run(out, stop=None, resume=None):
        g = torch.Generator(device=dev).manual_seed(seed + 81)
        e = LlamaBiSparse(enc.params, base_cfg,
                          init_lora_params(base_cfg, lc0, g, device=dev), lc0)
        args = dataclasses.replace(
            trainer.args, output_dir=out, lora_dropout=0.0,
            gradient_accumulation_steps=2, max_steps=3, save_steps=None,
            resume_from_checkpoint=resume)
        tr = Trainer(e, args, list(batches), mesh=trainer.mesh)
        if stop is not None:
            tr.args = dataclasses.replace(args, max_steps=stop)
        tr.train()
        return tr

    straight = run(os.path.join(tmp, "straight"))
    cut = run(os.path.join(tmp, "cut"), stop=2)
    ckpt_dir = cut.save_checkpoint()
    resumed = run(os.path.join(tmp, "cut"), resume=ckpt_dir)
    a, b = tree_leaves(straight.trainable), tree_leaves(resumed.trainable)
    check(resumed.step == straight.step == 3
          and resumed.micro_step == straight.micro_step == 6
          and all(pa == pb and torch.equal(ta, tb)
                  for (pa, ta), (pb, tb) in zip(a, b)),
          "the resumed run's trainable differs from the uninterrupted run's")
    size = sum(os.path.getsize(os.path.join(ckpt_dir, f))
               for f in os.listdir(ckpt_dir))
    log(f"accumulation and resume: gas 2, 2 optimizer steps, "
        f"save_checkpoint ({size / 1e6:.1f} MB), a fresh Trainer resumed "
        f"for step 3: {len(a)} factors bit-equal to the uninterrupted run's "
        f"(dropout 0)")
    del straight, cut, resumed, a, b
    free()

    # ---- 3b. the Trainer over meshes of the card (phase 10c) ----
    lap("phase 10c, the Trainer over meshes")
    mesh_training(dev, enc, base_cfg, trainer.args,
                  dataclasses.replace(lc0, lora_dropout=0.1), batches, seed,
                  card_s, tmp)
    free()

    # ---- 3c. the Trainer through torch.distributed (phase 10d) ----
    lap("phase 10d, the distributed Trainer")
    distributed_training(dev, enc, base_cfg, trainer.args,
                         dataclasses.replace(lc0, lora_dropout=0.1), batches,
                         seed, card_s, tmp)
    free()

    # ---- 4. the trained adapter served back through B1, B4 and B5 ----
    lap("trained adapter")
    adapter = os.path.join(tmp, "adapter")
    trainer.save_model(adapter)
    b_max = max(float(t.detach().abs().max())
                for p_, t in tree_leaves(trainer.trainable)
                if p_.endswith(".b"))
    check(b_max > 0, "training left every B factor at zero")
    merged = LlamaBiSparse.load_from_lora(adapter, device=dev, **bf16)
    base = LlamaBiSparse.load(ckpt, device=dev, **bf16)
    probe = [" ".join(doc_words[d][:48]) for d in range(TILE)]
    ids, mask = tok(probe, length=64)
    unmerged = enc.encode(ids, mask)
    d_merge = rel_l2(merged.encode(ids, mask), unmerged)
    d_adapter = rel_l2(unmerged, base.encode(ids, mask))
    del base
    check(d_merge <= MERGE_RTOL, f"merged reps differ from the trained "
          f"model's by {d_merge:.4f} (relative L2) > {MERGE_RTOL}")
    log(f"trained adapter: save_model, load_from_lora merged; relative L2 "
        f"of {TILE} reps: merged vs the unmerged trained model {d_merge:.4f}"
        f" (limit {MERGE_RTOL}), trained vs base {d_adapter:.4f}; largest "
        f"|B| {b_max:.4f}")
    del trainer, enc, fixed, batches, real_loader, unmerged
    free()
    idx_dir = os.path.join(tmp, "trained_index")
    serve_corpus = os.path.join(tmp, "serve_corpus.tsv")
    with open(serve_corpus, "w") as f:
        for d in range(SERVE_DOCS):
            f.write(f"p{d}\t{' '.join(doc_words[d])}\n")
    t0 = time.perf_counter()
    out = eval_sparse.sparse_index(eval_sparse.build_parser().parse_args(
        ["--task_name", "indexing", "--corpus_path", serve_corpus,
         "--index_dir", idx_dir, "--eval_batch_size", str(TILE),
         "--doc_max_length", str(TRAIN_DLEN), "--data_source", "msmarco",
         "--index_sparsify_t", str(CKPT_T), "--device", str(dev)]),
        model=TopKReps(merged, CKPT_L0_D), tokenizer=tok)
    index_s = time.perf_counter() - t0
    index = out["index"]
    qpath = os.path.join(tmp, "trained_queries.tsv")
    picks = rng.choice(SERVE_DOCS, SERVE_QUERIES, replace=False)
    with open(qpath, "w") as f:
        for i, d in enumerate(picks):
            f.write(f"q{i}\t{' '.join(doc_words[d][:CKPT_QUERY_WORDS])}\n")
    reps_path = os.path.join(tmp, "trained_reps.npz")

    def args(task, out_dir, *extra):
        return eval_sparse.build_parser().parse_args(
            ["--task_name", task, "--index_dir", idx_dir, "--out_dir",
             out_dir, "--query_path", qpath, "--data_source", "msmarco",
             "--eval_batch_size", "128", "--query_max_length", "64",
             "--top_k", str(TOPK), "--device", str(dev), *extra])

    eval_sparse.encode_queries(args("encode_queries", tmp,
                                    "--query_reps_path", reps_path,
                                    "--reps_format", "sparse"),
                               model=TopKReps(merged, L0_Q), tokenizer=tok)
    cuda_lib.reset_launches()
    run_dir = os.path.join(tmp, "trained_run")
    t0 = time.perf_counter()
    eval_sparse.sparse_retrieval(args("retrieval", run_dir,
                                      "--query_reps_path", reps_path))
    ret_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    with open(os.path.join(run_dir, "run.json")) as f:
        run_kernels = json.load(f)
    z = np.load(reps_path, allow_pickle=True)
    qids = [f"q{i}" for i in range(SERVE_QUERIES)]
    check(z["ids"].tolist() == qids, "query_reps ids")
    plain = ss.SegsortEngine(index, topk=TOPK, ops=ss.PLAIN, device=dev)
    same_run(run_kernels, engine_run(plain, z["q_terms"], z["q_vals"], qids,
                                     index.doc_ids, index.nb_docs()),
             qids, 1e-5, "the trained adapter's run: kernel vs plain path")
    log(f"trained adapter served: {SERVE_DOCS} docs indexed through "
        f"eval_sparse's body in {index_s:.1f} s ({index.nnz} postings), "
        f"{SERVE_QUERIES} doc-prefix queries into run.json in {ret_s:.2f} s "
        f"== the plain-ops engine (tie-equal, rtol 1e-5); launches "
        f"{launches}; card {card_s}")
    del merged, plain, index, out
    free()

    # ---- 5. dense NCE ----
    lap("dense NCE")
    out5 = os.path.join(tmp, "dense")
    torch.cuda.reset_peak_memory_stats(dev)
    # train_dense's body: train_sparse's with the dense pooling
    trainer, _ = train_sparse.build_training(
        argv(out5, "--T", "0.01"), "dense", tokenizer=tok)
    stop_at(trainer, DENSE_STEPS)
    with step_times() as ms:
        trainer.train()
    peak = torch.cuda.max_memory_allocated(dev)
    logs = read_log(out5)
    check(trainer.encoder.T == 0.01 and len(logs) == DENSE_STEPS and all(
        np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
        for e in logs), f"dense NCE logs {logs}")
    step_report("dense NCE, T 0.01, LoRA r 16, dropout 0.1, bf16, remat "
                "none, the same micro batch", ms,
                model_flops(cfg, groups, lm_head=False, remat=False), tokens,
                peak, card_s)
    del trainer
    free()

    # ---- 6. MNTP at the 1B recipe's batch, full remat ----
    lap("MNTP")
    with open(MNTP_CONFIG) as f:
        mcfg = json.load(f)
    rows, seq = mcfg["per_device_train_batch_size"], mcfg["max_seq_length"]
    files = {}
    for name, n_rows in (("train", MNTP_STEPS * rows),
                         ("dev", MNTP_EVAL_ROWS)):
        files[name] = os.path.join(tmp, f"mntp_{name}.tsv")
        n_docs = -(-n_rows * seq // 200) + 1
        with open(files[name], "w") as f:
            for d in range(n_docs):
                words = rng.integers(0, VOCAB - 1, 200)
                f.write(f"m{d}\t{' '.join(f'w{x}' for x in words)}\n")
    out6 = os.path.join(tmp, "mntp")
    torch.cuda.reset_peak_memory_stats(dev)
    with step_times() as ms:
        mtrainer = mntp.main(
            ["--config_json", MNTP_CONFIG, "--model_name_or_path", ckpt,
             "--train_file", files["train"], "--validation_file",
             files["dev"], "--output_dir", out6, "--stop_after_n_steps",
             str(MNTP_STEPS), "--logging_steps", "1", "--remat", "full",
             "--device", str(dev)], tokenizer=tok)
    peak = torch.cuda.max_memory_allocated(dev)
    logs = read_log(out6)
    with open(os.path.join(out6, "eval_results.json")) as f:
        ev = json.load(f)
    check(mtrainer.step == MNTP_STEPS and mtrainer.encoder.config.remat
          is True and mtrainer.encoder.params.final_norm.dtype
          == torch.bfloat16 and all(np.isfinite(e["loss"]) for e in logs
                                    if "loss" in e)
          and np.isfinite(ev["eval_loss"]), f"MNTP logs {logs}, eval {ev}")
    step_report(f"MNTP ({os.path.basename(MNTP_CONFIG)}: {rows} x {seq}, mlm "
                f"{mcfg['mlm_probability']}, mask {mcfg['mask_token_type']}, "
                f"r {mcfg['lora_r']}, bf16), remat full", ms[:MNTP_STEPS],
                model_flops(cfg, [(rows, seq)], lm_head=True, remat=True),
                rows * seq, peak, card_s)
    log(f"MNTP eval over {MNTP_EVAL_ROWS} rows: loss {ev['eval_loss']:.4f},"
        f" accuracy {ev['eval_accuracy']:.4f}")
    del mtrainer
    free()
    log(f"phase 8 (training): {time.perf_counter() - t_phase:.1f} s; card "
        f"{card_s}")
    return {"trained adapter": launches}


# ---- phase 9: hybrid retrieval, the term-encoder retriever, reranking and
# the T5 family

HYB_DOCS = 4_096
HYB_DOC_LEN = 128
HYB_QUERIES = 1_024
HYB_QLEN = 64
# k of the hybrid runs: a 4,096-doc corpus fills one block of the dense
# index's default 4,096-row selection blocks, so the per-block top-32 could
# never certify a top-1000; 128-row blocks (B5's smallest) leave 32 blocks
# of real docs and certify a top-100
HYB_K = 100
HYB_SEL_BLOCK = 128
XLA_RTOL = 2.0 ** -8          # the "xla" engine's doc-major values are bf16
TERM_DOCS = 262_144
TERM_LEN = 32
TERM_QUERIES = 256
TERM_CHUNK = 16_384
RERANK_Q, RERANK_D = 64, 32
RERANK_RTOL = 1e-3
# google/t5-v1_1-base's config.json
T5_V1_1_BASE = {"vocab_size": 32128, "d_model": 768, "d_kv": 64,
                "d_ff": 2048, "num_layers": 12, "num_decoder_layers": 12,
                "num_heads": 12, "feed_forward_proj": "gated-gelu",
                "tie_word_embeddings": False,
                "relative_attention_num_buckets": 32,
                "relative_attention_max_distance": 128}
T5_STEPS = 6                  # timed: the median of the last 4
T5_FIXED_STEPS = 6
# the recipe's 1e-4, not phase 8's 1e-3: T5's forward has no LoRA dropout
# whose noise a fixed batch must beat, and random T5 reps are dense (scores
# near 25,000), so 1e-3 throws the fixed batch's loss back up (on the card:
# 130.3, 0.05, 0.07, 73.4, 131.8, 0.09)
T5_LR = 1e-4
# merged vs unmerged T5 reps in float32 (both reloaded from the files):
# each merged weight rounds once more at 2^-24; random T5-base amplifies a
# weight rounding ~100x into its reps (bf16, 2^-9: 0.065-0.077 measured)
MERGE_F32_RTOL = 1e-4


def t5_flops(cfg, groups) -> float:
    """Model FLOPs of one T5 micro step over ``groups`` of (rows, tokens),
    the decoder fed the same tokens: the projections, the attention
    products (self, and the decoder's cross) and the LM head, forward and
    backward to the activations (the base is frozen)."""
    d, inner, V = cfg.d_model, cfg.inner_dim, cfg.vocab_size
    ffn = (3 if cfg.is_gated else 2) * d * cfg.d_ff
    fwd = 0
    for rows, seq in groups:
        enc = cfg.num_layers * (4 * d * inner + ffn + 2 * seq * inner)
        dec = cfg.num_decoder_layers * (8 * d * inner + ffn
                                        + 4 * seq * inner)
        fwd += 2 * rows * seq * (enc + dec + d * V)
    return 2 * fwd


def split_launches(counts: dict, keys) -> tuple[dict, dict]:
    """One run's launch counts split into (the counts of ``keys``, the
    rest), each keyed by every kernel."""
    a = {k: (v if k in keys else 0) for k, v in counts.items()}
    return a, {k: counts[k] - a[k] for k in counts}


def token_batches(ids: np.ndarray, names, bz: int = TILE) -> list:
    """Unpadded [n, L] token rows as the collators' batches."""
    return [{"input_ids": ids[s:s + bz],
             "attention_mask": np.ones_like(ids[s:s + bz]),
             "ids": list(names[s:s + bz])} for s in range(0, len(ids), bz)]


def write_tsv(path: str, names, rows) -> None:
    with open(path, "w") as f:
        for name, row in zip(names, rows):
            f.write(f"{name}\t{' '.join(f'w{t}' for t in row)}\n")


def hybrid_phase(dev, ckpt: str, seed: int, card_s: str, tmp: str) -> dict:
    """Phase 9 (a)-(c): the hybrid encoder at Llama-3.2-1B width (the
    checkpoint at ``ckpt``) indexing and retrieving, the term-encoder
    retriever over its sparse head, and the reranker's bi-encoder body.
    Returns the launch counts of the hybrid sparse and dense paths."""
    from scaling_retriever_tpu_torch.evaluation import eval_reranker
    from scaling_retriever_tpu_torch.index.hybrid import (HybridIndexer,
                                                          HybridRetriever,
                                                          LlamaBiHybrid)
    from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
    from scaling_retriever_tpu_torch.index.term_encoder import \
        TermEncoderRetriever
    from scaling_retriever_tpu_torch.models.encoder import (LlamaBiDense,
                                                            LlamaBiSparse)
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
    from scaling_retriever_tpu_torch.utils.run_accum import RunAccumulator

    t_phase = time.perf_counter()

    def lap(step: str) -> None:
        log(f"phase 9 at {time.perf_counter() - t_phase:.1f} s: {step}")

    rng = np.random.default_rng(seed + 90)
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = LlamaBiHybrid.load(ckpt, device=dev, **bf16)
    tok = StandInTokenizer(VOCAB)

    # ---- (a) HybridIndexer, then HybridRetriever on segsort and xla ----
    lap("hybrid indexing")
    docs = rng.integers(0, VOCAB, (HYB_DOCS, HYB_DOC_LEN))
    doc_names = [f"h{d}" for d in range(HYB_DOCS)]
    picks = rng.choice(HYB_DOCS, HYB_QUERIES, replace=False)
    queries = docs[picks, :HYB_QLEN]
    q_names = [f"q{i}" for i in range(HYB_QUERIES)]
    sp_dir, de_dir = os.path.join(tmp, "hyb_sparse"), os.path.join(
        tmp, "hyb_dense")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = HybridIndexer(TopKReps(model, CKPT_L0_D), sp_dir, de_dir).index(
        token_batches(docs, doc_names))
    index_s = time.perf_counter() - t0
    index = out["index"]
    check(index.nb_docs() == HYB_DOCS
          and index.nnz == HYB_DOCS * CKPT_L0_D,
          f"hybrid index: {index.nb_docs()} docs, {index.nnz} postings")
    embs = np.load(os.path.join(de_dir, "embs_0_0.npy"))
    check(embs.shape == (HYB_DOCS, model.hidden_size)
          and np.isfinite(embs).all(), f"dense chunk {embs.shape}")
    log(f"hybrid indexing at Llama-3.2-1B width: {HYB_DOCS} docs of "
        f"{HYB_DOC_LEN} tokens in {index_s:.2f} s "
        f"({HYB_DOCS / index_s:.0f} docs/s; sparse reps kept to their top "
        f"{CKPT_L0_D}, {index.nnz} postings; dense {embs.shape} f32); card "
        f"{card_s}")

    lap("hybrid retrieval")
    q_model = TopKReps(model, L0_Q)
    q_batches = token_batches(queries, q_names)

    def retriever(engine: str, name: str):
        r = HybridRetriever(q_model, sp_dir, de_dir, os.path.join(tmp, name),
                            topk=HYB_K, engine=engine, device=dev)
        r.dense_indexer.sel_block = HYB_SEL_BLOCK
        return r

    seg = retriever("segsort", "hyb_runs")
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = seg.retrieve(q_batches)
    torch.cuda.synchronize()
    ret_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    for head in ("sparse", "dense"):
        with open(os.path.join(tmp, "hyb_runs", head, "run.json")) as f:
            check(json.load(f) == runs[head], f"{head}/run.json")
        check(len(runs[head]) == HYB_QUERIES and all(
            len(v) == HYB_K for v in runs[head].values()),
            f"hybrid {head} run sizes")
    dense_fallbacks = seg.dense_indexer.fallbacks
    # the sparse run against the same retriever on the doc-major scan, and
    # against the plain-ops engine on the same sparsified queries
    xla = retriever("xla", "hyb_runs_xla")
    runs_xla = xla.retrieve(q_batches)
    same_run(runs["sparse"], runs_xla["sparse"], q_names, XLA_RTOL,
             "hybrid sparse: segsort vs xla")
    check(runs_xla["dense"] == runs["dense"], "hybrid dense: the two "
          "retrievers' dense runs differ")
    del xla
    plain = ss.SegsortEngine(SparseIndex.load(sp_dir), topk=HYB_K,
                             ops=ss.PLAIN, device=dev)
    qt, qv = [], []
    for b in q_batches:
        t_, v_ = ss.sparsify_reps_device(
            q_model.encode(b["input_ids"], b["attention_mask"])[0], plain.T)
        qt.append(t_)
        qv.append(v_)
    w = max(t_.shape[1] for t_ in qt)
    qt = np.concatenate([np.pad(t_, ((0, 0), (0, w - t_.shape[1])))
                         for t_ in qt])
    qv = np.concatenate([np.pad(v_, ((0, 0), (0, w - v_.shape[1])))
                         for v_ in qv])
    same_run(runs["sparse"], engine_run(plain, qt, qv, q_names,
                                        index.doc_ids, HYB_DOCS, HYB_K),
             q_names, 1e-5, "hybrid sparse: kernels vs the plain-ops engine")
    del plain
    # the dense run against the direct (unblocked) search
    q_dense = torch.cat([model.encode(b["input_ids"], b["attention_mask"])[1]
                         for b in q_batches]).float().cpu().numpy()
    blocked = result_arrays(seg.dense_indexer.search_knn(q_dense, HYB_K))
    seg.dense_indexer.selection = "direct"
    direct = result_arrays(seg.dense_indexer.search_knn(q_dense, HYB_K))
    same_topk(blocked, direct, "hybrid dense: blocked vs direct")
    check(all(list(runs["dense"][q]) == [str(x) for x in blocked[0][i]]
              for i, q in enumerate(q_names)),
          "hybrid dense/run.json is not the blocked search's")
    dense_l, sparse_l = split_launches(launches, ("topm_dense",))
    log(f"hybrid retrieval: {HYB_QUERIES} queries of {HYB_QLEN} tokens into "
        f"sparse/run.json and dense/run.json (k {HYB_K}) in {ret_s:.2f} s; "
        f"sparse (segsort) == xla (tie-equal, rtol {XLA_RTOL}: its "
        f"doc-major values are bf16) == the plain-ops engine (rtol 1e-5); "
        f"dense blocked == direct (scores bit-equal), {dense_fallbacks} "
        f"certificate fallbacks; launches {launches}; card {card_s}")
    del seg
    free()

    # ---- (b) TermEncoderRetriever over its sparse head ----
    lap("term encoder")
    codes = rng.integers(0, VOCAB, (TERM_DOCS, TERM_LEN))
    code_names = [f"t{d}" for d in range(TERM_DOCS)]
    t_batches = [{**b, "queries": b.pop("ids")}
                 for b in token_batches(queries[:TERM_QUERIES],
                                        q_names[:TERM_QUERIES])]
    ter = TermEncoderRetriever(model, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_t = ter.retrieve(t_batches, dict(zip(code_names, codes.tolist())),
                         TOPK, os.path.join(tmp, "term"))
    torch.cuda.synchronize()
    term_s = time.perf_counter() - t0
    pred = torch.cat([model.encode(b["input_ids"], b["attention_mask"])[0]
                      for b in t_batches])
    codes_d = torch.from_numpy(codes).to(dev)
    top_s = torch.full((TERM_QUERIES, TOPK), float("-inf"), device=dev)
    top_i = torch.full((TERM_QUERIES, TOPK), -1, dtype=torch.int64,
                       device=dev)
    for s0 in range(0, TERM_DOCS, TERM_CHUNK):
        sc = pred[:, codes_d[s0:s0 + TERM_CHUNK]].sum(-1)
        rows = torch.arange(s0, s0 + sc.shape[1], device=dev).expand(
            TERM_QUERIES, -1)
        top_s, sel = torch.topk(torch.cat([top_s, sc], 1), TOPK, dim=1)
        top_i = torch.cat([top_i, rows], 1).gather(1, sel)
    acc = RunAccumulator(q_names[:TERM_QUERIES], code_names, TERM_DOCS,
                         threshold=None, keep_empty=True)
    acc.add_tile(np.arange(TERM_QUERIES), top_i.cpu().numpy(),
                 top_s.cpu().numpy())
    same_run(run_t, acc.to_run(), q_names[:TERM_QUERIES], 1e-5,
             "term encoder vs a plain chunked top-k")
    log(f"term encoder: {TERM_QUERIES} queries (the hybrid model's sparse "
        f"head, through encode) over {TERM_DOCS} codes of {TERM_LEN} terms "
        f"into run.json (k {TOPK}) in {term_s:.2f} s == a plain top-k of "
        f"pred[:, codes].sum(-1) in {TERM_CHUNK}-doc chunks (tie-equal, rtol"
        f" 1e-5); card {card_s}")
    del pred, codes_d, top_s, top_i, ter
    free()

    # ---- (c) the reranker's bi-encoder body ----
    lap("reranking")
    corpus = os.path.join(tmp, "hyb_corpus.tsv")
    qpath = os.path.join(tmp, "hyb_queries.tsv")
    write_tsv(corpus, doc_names, docs)
    write_tsv(qpath, q_names[:RERANK_Q], queries[:RERANK_Q])
    first = {q: dict(sorted(runs["sparse"][q].items(),
                            key=lambda kv: -kv[1])[:RERANK_D])
             for q in q_names[:RERANK_Q]}
    run_path = os.path.join(tmp, "rerank_in.json")
    with open(run_path, "w") as f:
        json.dump(first, f)
    pairs_in = {(q, d) for q, ds in first.items() for d in ds}
    doc_row = {n: i for i, n in enumerate(doc_names)}
    for kind, enc in (("splade", LlamaBiSparse(model.params, model.config)),
                      ("dense_encoder", LlamaBiDense(model.params,
                                                     model.config)),
                      ("hybrid_retriever", model)):
        args = eval_reranker.build_parser().parse_args(
            ["--run_path", run_path, "--query_path", qpath, "--corpus_path",
             corpus, "--output_dir", os.path.join(tmp, f"rr_{kind}"),
             "--rerank_type", kind, "--query_max_length", str(HYB_QLEN),
             "--doc_max_length", str(HYB_DOC_LEN), "--eval_batch_size",
             str(TILE), "--data_source", "msmarco", "--device", str(dev)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eval_reranker.bi_encoder_rerank(
            args, eval_reranker.load_pairs(args), model=enc, tokenizer=tok)
        rr_s = time.perf_counter() - t0
        check({(q, d) for q, ds in got.items() for d in ds} == pairs_in,
              f"{kind}: the reranked pairs are not the input pairs")
        # each score against the dot product of the pair's reps
        q_reps = enc.encode(queries[:RERANK_Q],
                            np.ones_like(queries[:RERANK_Q]))
        qi = {q: i for i, q in enumerate(q_names[:RERANK_Q])}
        names = sorted(pairs_in)
        d_ids = docs[[doc_row[d] for _, d in names]]
        want = []
        for s0 in range(0, len(names), TILE):
            d_reps = enc.encode(d_ids[s0:s0 + TILE],
                                np.ones_like(d_ids[s0:s0 + TILE]))
            sel = [qi[q] for q, _ in names[s0:s0 + TILE]]
            if kind == "hybrid_retriever":
                w_ = ((q_reps[0][sel] * d_reps[0]).sum(-1)
                      + (q_reps[1][sel] * d_reps[1]).sum(-1))
            else:
                w_ = (q_reps[sel] * d_reps).sum(-1)
            want.append(w_.float().cpu().numpy())
        want = np.concatenate(want)
        have = np.array([got[q][d] for q, d in names])
        err = float(np.abs(have - want).max() / np.abs(want).max())
        check(err <= RERANK_RTOL, f"{kind}: reranked scores differ from the "
              f"pairs' rep dot products by {err:.2e} of the largest > "
              f"{RERANK_RTOL}")
        log(f"rerank {kind}: {RERANK_Q} queries x {RERANK_D} docs of the "
            f"hybrid sparse run through eval_reranker's bi-encoder body in "
            f"{rr_s:.2f} s; the output holds exactly its input pairs; each "
            f"score == the dot product of the pair's reps from encode (max "
            f"difference {err:.2e} of the largest score, limit "
            f"{RERANK_RTOL}); card {card_s}")
    del model
    free()
    log(f"phase 9 (a)-(c): {time.perf_counter() - t_phase:.1f} s; card "
        f"{card_s}")
    return {"hybrid sparse": sparse_l, "hybrid dense": dense_l}


def t5_phase(dev, seed: int, card_s: str, tmp: str) -> dict:
    """Phase 9 (d): T5 at google/t5-v1_1-base width, random bf16 weights
    written as an HF checkpoint, trained through train_sparse's body
    (--model_type t5), its adapter reloaded, merged and served back
    through B1, B4 and B5. Returns the launch counts of that path."""
    from scaling_retriever_tpu_torch.index.indexer import SparseIndexer
    from scaling_retriever_tpu_torch.index.sparse_retrieval import \
        SparseRetrieval
    from scaling_retriever_tpu_torch.models import t5
    from scaling_retriever_tpu_torch.models.t5_encoder import T5Sparse
    from scaling_retriever_tpu_torch.models.weights import random_params
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
    from scaling_retriever_tpu_torch.parallel.mesh import shard_batch
    from scaling_retriever_tpu_torch.training import train_sparse
    from scaling_retriever_tpu_torch.training.trainer import tree_leaves

    t_phase = time.perf_counter()

    def lap(step: str) -> None:
        log(f"phase 9 (d) at {time.perf_counter() - t_phase:.1f} s: {step}")

    rng = np.random.default_rng(seed + 95)
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = t5.T5Config(**T5_V1_1_BASE, **bf16)
    vocab = cfg.vocab_size
    tok = StandInTokenizer(vocab, padding_side="right")

    lap("checkpoint")
    ckpt = os.path.join(tmp, "t5_ckpt")
    t0 = time.perf_counter()
    base = random_params(cfg, seed + 96, dev)
    t5.save_pretrained(base, cfg, ckpt)
    n_params = sum(p.numel() for p in base.parameters())
    del base
    free()
    size = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
    log(f"T5 at google/t5-v1_1-base width ({n_params} params, bf16, random "
        f"from seed {seed + 96}) written as an HF checkpoint "
        f"({size / 1e9:.2f} GB) in {time.perf_counter() - t0:.2f} s")

    corpus = os.path.join(tmp, "t5_corpus.tsv")
    doc_words = rng.integers(0, vocab, (max(TRAIN_DOCS, SERVE_DOCS), 160))
    write_tsv(corpus, [f"p{d}" for d in range(len(doc_words))], doc_words)
    train_path = os.path.join(tmp, "t5_train.jsonl")
    with open(train_path, "w") as f:
        for i in range(TRAIN_QUERIES):
            negs = [int(x) for x in rng.choice(TRAIN_DOCS, 25, replace=False)
                    if x != i][:24]
            f.write(json.dumps({
                "question": " ".join(f"w{t}" for t in doc_words[i][:80]),
                "pos_pid": f"p{i}",
                "neg_pids": [f"p{x}" for x in negs]}) + "\n")
    out = os.path.join(tmp, "t5_out")
    argv = ["--model_name_or_path", ckpt, "--model_type", "t5",
            "--loss_type", "nce", "--corpus_path", corpus, "--train_path",
            train_path, "--output_dir", out, "--data_source", "msmarco",
            "--per_device_train_batch_size", str(TRAIN_Q), "--n_negs",
            str(TRAIN_NEGS), "--query_max_length", str(TRAIN_QLEN),
            "--doc_max_length", str(TRAIN_DLEN), "--fixed_length", "--bf16",
            "--lora_r", "16", "--lora_alpha", "32", "--lora_dropout", "0.1",
            "--learning_rate", str(T5_LR), "--warmup_ratio", "0",
            "--max_steps", "1000", "--logging_steps", "1", "--device",
            str(dev)]

    lap("T5 sparse NCE")
    groups = [(TRAIN_Q, TRAIN_QLEN), (TRAIN_Q * (1 + TRAIN_NEGS), TRAIN_DLEN)]
    tokens = sum(r * t for r, t in groups)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer, _ = train_sparse.build_training(argv, "sparse", tokenizer=tok)
    check(isinstance(trainer.encoder, T5Sparse), "not a T5Sparse")
    trainer.args = dataclasses.replace(trainer.args, max_steps=T5_STEPS,
                                       reg_T=REG_T)
    with step_times() as ms:
        trainer.train()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = step_report(
        f"T5 sparse NCE (google/t5-v1_1-base width), LoRA r 16 over both "
        f"stacks, bf16, {TRAIN_Q} x (1 + {TRAIN_NEGS}) at "
        f"{TRAIN_QLEN}/{TRAIN_DLEN} tokens ({tokens} tokens)", ms,
        t5_flops(cfg, groups), tokens, peak, card_s)
    logs = read_log(out)
    check(len(logs) == T5_STEPS and all(
        np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
        for e in logs), f"T5 logs {logs}")
    # the loss on one fixed batch before and after T5_FIXED_STEPS steps on
    # it, both at the ramp weight of the first of them: the logged losses
    # add the FLOPS regularizers at weights that ramp up per step, and
    # random T5 reps are dense (scores near 25,000), so their rank term
    # sits at 0 or jumps by hundreds
    fixed = shard_batch(next(iter(trainer.train_loader)), trainer.mesh)
    at = trainer.micro_step + 1

    def fixed_loss():
        with torch.no_grad():
            total, parts = trainer._combined_loss(fixed, at)
        return float(total), {k: float(v) for k, v in parts.items()}

    before, parts0 = fixed_loss()
    trainer.train_loader = [fixed] * T5_FIXED_STEPS
    trainer.args = dataclasses.replace(trainer.args,
                                       max_steps=T5_STEPS + T5_FIXED_STEPS)
    trainer.train()
    after, parts1 = fixed_loss()
    logged = [round(e["loss"], 4) for e in read_log(out)[T5_STEPS:]]
    check(np.isfinite(after) and after < before,
          f"the T5 loss on one fixed batch did not fall: {before} -> "
          f"{after} ({parts0} -> {parts1})")
    log(f"T5 sparse NCE on one fixed batch, learning rate {T5_LR}, "
        f"{T5_FIXED_STEPS} steps: loss at the ramp weight of step {at} "
        f"{before:.6g} -> {after:.6g} ({parts0} -> {parts1}); the steps' "
        f"logged losses {logged}")

    def one_step():
        trainer.micro_step += 1
        trainer.step += 1
        trainer._train_step(fixed, trainer.micro_step)

    profile_tile("T5 sparse NCE micro step", one_step, card_s)

    lap("T5 adapter")
    adapter = os.path.join(tmp, "t5_adapter")
    trainer.save_model(adapter)
    with open(os.path.join(adapter, "adapter_config.json")) as f:
        acfg = json.load(f)
    check(acfg["auto_mapping"]["base_model_class"]
          == "T5ForConditionalGeneration", f"adapter config {acfg}")
    b_max = max(float(t.detach().abs().max())
                for p_, t in tree_leaves(trainer.trainable)
                if p_.endswith(".b"))
    check(b_max > 0, "T5 training left every B factor at zero")
    n_factors = len(tree_leaves(trainer.trainable))
    probe = doc_words[:TILE, :TRAIN_DLEN]
    mask = np.ones_like(probe)
    mask[1::2, TRAIN_DLEN // 2:] = 0            # right padding
    probe = probe * mask
    unmerged = trainer.encoder.encode(probe, mask)
    del trainer, fixed
    free()
    # float32: the adapter merged by load_from_lora against the same files
    # loaded unmerged
    merged32 = T5Sparse.load_from_lora(adapter, device=dev)
    unmerged32 = T5Sparse.load(ckpt, lora_name_or_path=adapter,
                               merge_peft=False, device=dev)
    d32 = rel_l2(merged32.encode(probe, mask), unmerged32.encode(probe, mask))
    del merged32, unmerged32
    free()
    check(d32 <= MERGE_F32_RTOL, f"merged T5 reps differ from the unmerged "
          f"by {d32:.3e} (relative L2, f32) > {MERGE_F32_RTOL}")
    merged = T5Sparse.load_from_lora(adapter, device=dev, **bf16)
    base = T5Sparse.load(ckpt, device=dev, **bf16)
    d_merge = rel_l2(merged.encode(probe, mask), unmerged)
    d_adapter = rel_l2(unmerged, base.encode(probe, mask))
    del base, unmerged
    log(f"T5 adapter: save_model (peft T5 layout, {n_factors} factors), "
        f"load_from_lora merged; relative L2 of {TILE} right-padded reps: "
        f"merged vs unmerged {d32:.3e} in f32 (limit {MERGE_F32_RTOL}), "
        f"{d_merge:.4f} in bf16 (not checked: random T5-base amplifies the "
        f"merge's bf16 rounding), trained vs base {d_adapter:.4f} (bf16); "
        f"largest |B| {b_max:.4f}")
    free()

    lap("T5 trained adapter served")
    doc_ids = doc_words[:SERVE_DOCS, :TRAIN_DLEN]
    names = [f"p{d}" for d in range(SERVE_DOCS)]
    idx_dir = os.path.join(tmp, "t5_index")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = SparseIndexer(TopKReps(merged, CKPT_L0_D), idx_dir,
                          device_sparsify_t=CKPT_T).index(
        token_batches(doc_ids, names))["index"]
    index_s = time.perf_counter() - t0
    picks = rng.choice(SERVE_DOCS, SERVE_QUERIES, replace=False)
    q_texts = [" ".join(f"w{t}" for t in doc_words[d][:int(n)])
               for d, n in zip(picks, rng.integers(8, CKPT_QUERY_WORDS + 1,
                                                   SERVE_QUERIES))]
    qids = [f"q{i}" for i in range(SERVE_QUERIES)]
    enc_q = tok(q_texts, max_length=CKPT_QUERY_WORDS, padding="max_length",
                truncation=True)
    q_batches = [{"input_ids": enc_q["input_ids"][s:s + TILE],
                  "attention_mask": enc_q["attention_mask"][s:s + TILE],
                  "ids": qids[s:s + TILE]}
                 for s in range(0, SERVE_QUERIES, TILE)]
    q_model = TopKReps(merged, L0_Q)
    run_dir = os.path.join(tmp, "t5_run")
    ret = SparseRetrieval(q_model, idx_dir, out_dir=run_dir, topk=TOPK,
                          engine="segsort", device=dev)
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret.retrieve(q_batches)
    torch.cuda.synchronize()
    ret_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    with open(os.path.join(run_dir, "run.json")) as f:
        run_kernels = json.load(f)
    plain = ss.SegsortEngine(index, topk=TOPK, ops=ss.PLAIN, device=dev)
    qt, qv = ss.sparsify_reps_device(torch.cat([
        q_model.encode(b["input_ids"], b["attention_mask"])
        for b in q_batches]), plain.T)
    same_run(run_kernels, engine_run(plain, qt, qv, qids, index.doc_ids,
                                     index.nb_docs()),
             qids, 1e-5, "the T5 adapter's run: kernel vs plain path")
    log(f"T5 trained adapter served: {SERVE_DOCS} docs indexed by "
        f"SparseIndexer in {index_s:.1f} s ({index.nnz} postings), "
        f"{SERVE_QUERIES} right-padded doc-prefix queries into run.json in "
        f"{ret_s:.2f} s == the plain-ops engine (tie-equal, rtol 1e-5); "
        f"launches {launches}; card {card_s}")
    del merged, plain, ret, index
    free()
    log(f"phase 9 (d): {time.perf_counter() - t_phase:.1f} s; card "
        f"{card_s}")
    return {"t5 trained adapter": launches}


# ---- phase 11: the power-law index and skewed serving traffic

ZIPF_CONCURRENCY = (8, 128)
ZIPF_SECONDS = 2.0
ZIPF_MS_TILES = 2


def zipf_phase(dev, seed: int, card_s: str) -> dict:
    """Phase 11 (module docstring). Returns the launch counts of the served
    path and of the maxscore path, each read over exactly that path."""
    from scaling_retriever_tpu_torch.benches import serving_zipf, zipf
    from scaling_retriever_tpu_torch.benches.common import (Checks,
                                                            closed_loop,
                                                            server_counters)
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.serving.server import \
        ServerOverloadedError

    t_phase = time.perf_counter()
    corpus = corpora.ZipfCorpus(corpora.ZipfSpec(), dev)
    engine, backend, server = serving_zipf.zipf_server(corpus)
    torch.cuda.synchronize()
    t = corpus.t
    log(f"zipf index: {t['nnz']} postings over {t['V']} terms, full CSR "
        f"{(engine.rows_flat.nbytes + engine.valbits_flat.nbytes) / 1e9:.2f}"
        f" GB on card in {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    cal, hot, alpha = serving_zipf.pools(t, seed)
    n_warm = serving_zipf.warm(backend, cal + hot, passes=1)
    log(f"zipf pools ({len(cal)} calibrated, alpha {alpha:.4f}; {len(hot)} "
        f"hot) and {n_warm} warm tiles in {time.perf_counter() - t0:.1f} s")

    paths = {}
    # ---- the served path: launch counts cover exactly this block ----
    cuda_lib.reset_launches()
    with server:
        res, _ = closed_loop(
            server.search, serving_zipf.mix(cal, hot), ZIPF_CONCURRENCY,
            ZIPF_SECONDS, counters=server_counters(server),
            shed=(ServerOverloadedError,), seed=seed, label="zipf served, ")
        served = serving_zipf.serve_sample(server, backend, cal, hot)
        stats = server.stats()
    paths["served zipf"] = dict(cuda_lib.LAUNCHES)
    # ---- end of the served path ----
    log(f"zipf served: {json.dumps(res)}; server {stats}; card {card_s}")
    check(sum(r["n_cost_splits"] for r in res.values()) > 0,
          f"no cost-aware split in the zipf mix: {res}")
    check(sum(r["n_hot"] for r in res.values()) > 0,
          f"no query took the hot lane in the zipf mix: {res}")
    check(res[ZIPF_CONCURRENCY[-1]]["mean_batch"] > 1,
          f"no batching at concurrency {ZIPF_CONCURRENCY[-1]}: {res}")
    t0 = time.perf_counter()
    serving_zipf.check_served(engine, backend.hot_lane, served)
    log(f"zipf: {len(served)} served results (fast lane and hot lane) == "
        f"ZipfHostLane and the engine (tie-equal, rtol 1e-5) in "
        f"{time.perf_counter() - t0:.1f} s")

    search = zipf.ZipfSearch(corpus, engine.rows_flat, engine.valbits_flat)
    tiles = corpora.make_queries(t, np.random.default_rng(seed + 11),
                                 ZIPF_MS_TILES, alpha, zipf.TILE,
                                 zipf.T_BUDGET, zipf.L0_Q)
    gb = search.build_maxscore(tiles)
    torch.cuda.synchronize()
    # ---- the maxscore path: launch counts cover exactly this block ----
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    ms = [search.ms_tile(qt, qv) for qt, qv in tiles]
    ms_s = time.perf_counter() - t0
    paths["zipf maxscore"] = dict(cuda_lib.LAUNCHES)
    # ---- end of the maxscore path ----
    checks = Checks()
    for i, (qt, qv) in enumerate(tiles):
        search.check_tile(checks, f"zipf maxscore tile {i}", qt, qv)
    check(checks.ok, f"zipf maxscore: {checks.failed}")
    log(f"zipf maxscore: {ZIPF_MS_TILES} tiles of {zipf.TILE} in {ms_s:.2f}"
        f" s, certified {[m[2] for m in ms]}, fell back "
        f"{[m[3] for m in ms]}; the certified rows, the results and the "
        f"doc-major scan == the full-CSR segsort (tie-equal, rtol 1e-5); "
        f"prefix and doc-major {gb} GB; card {card_s}")
    del engine, backend, server, search
    free()
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s; card {card_s}")
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from scaling_retriever_tpu_torch.ops import cuda_lib

    card_s = card(torch.device("cuda", 0))
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; card {card_s}")

    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    cuda_lib.library()
    log(f"phase 1: built {lib} in {time.perf_counter() - t0:.1f} s")
    report = run(torch.device("cuda", 0), args.seed, card_s)
    log(card_s)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev, seed: int, card_s: str) -> list:
    """Phases 2-14 on ``dev``; returns the per-kernel report entries."""
    from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine

    t0 = time.perf_counter()
    rows, valbits, pairs, packed, offsets, scales, nnz = gen_index(dev)
    eng_f32 = SegsortEngine(topk=TOPK, query_terms_budget=T_BUDGET,
                            device_csr=(rows, valbits, offsets, N_DOCS))
    eng_bf16 = SegsortEngine(topk=TOPK, query_terms_budget=T_BUDGET,
                             val_dtype="bf16",
                             device_csr=(rows, pairs, offsets, N_DOCS))
    eng_q8 = SegsortEngine(topk=TOPK, query_terms_budget=T_BUDGET,
                           val_dtype="q8",
                           device_csr=(packed, scales, offsets, N_DOCS))
    log(f"index: {nnz} postings on card in {time.perf_counter() - t0:.1f} s "
        f"(f32 {(rows.nbytes + valbits.nbytes) / 1e9:.1f} GB, bf16 pairs "
        f"{(rows.nbytes + pairs.nbytes) / 1e9:.1f} GB, q8 "
        f"{packed.nbytes / 1e9:.1f} GB)")

    t0 = time.perf_counter()
    cfg = make_cfg()
    csr, meta, base = clustered_index(dev, cfg, TOPK)
    bmx_tiles = make_tiles(cfg, np.random.default_rng(seed), 14)
    log(f"clustered index: {cfg['NNZ']} postings, {cfg['N']} docs in "
        f"{cfg['C']} clusters, on card with block-max meta "
        f"({len(meta['sub_max'])} sub-blocks, from the card's tensors) in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({(csr[0].nbytes + csr[1].nbytes) / 1e9:.1f} GB)")

    tiles = query_tiles(np.random.default_rng(seed), 9)
    report = kernel_phase(dev, eng_f32, eng_q8, eng_bf16, tiles[0], card_s)
    report.insert(1, blockmax_kernel_phase(dev, csr, meta, bmx_tiles[0]))
    log_kernels(report, card_s)
    log("phase 2: every kernel matches its plain version")
    engine_phase(dev, eng_f32, eng_q8, eng_bf16, tiles, card_s)
    bmx = clustered_phase(dev, cfg, csr, meta, base, bmx_tiles[:12], card_s)
    log("phase 3: engine kernel paths match the plain paths; block-max "
        "matches the unpruned engine")
    model = make_model(dev, seed)
    paths = serving_phase(dev, model, eng_f32, eng_q8, eng_bf16, bmx,
                          bmx_tiles[12:], seed, card_s)
    log("phase 4: served text and pre-encoded requests (f32, bf16, q8, "
        "block-max) through the kernels")
    # phase 5 starts from host copies of both corpora; the card keeps
    # neither the generated arrays nor the engines over them
    index = host_index(rows, valbits, offsets, N_DOCS, nnz, "d")
    cindex = host_index(csr[0], csr[1], cfg["offsets"], cfg["N"],
                        cfg["NNZ"], "c")
    del eng_f32, eng_q8, eng_bf16, bmx, base, csr, meta
    del rows, valbits, pairs, packed
    free()
    with tempfile.TemporaryDirectory() as tmp:
        offline, refs = offline_phase(dev, model, index, cindex, cfg, seed,
                                      card_s, tmp)
        for path, counts in offline.items():
            log(f"launches over the {path} path: {counts}")
        paths.update(offline)
        log("phase 5: the offline path (f32, bf16, q8, text via the hot "
            "route, gather, block-max, maxscore, the CLI) through the "
            "kernels")
        del cindex
        sharded = mesh_sparse_phase(dev, model, index, refs, card_s, tmp)
        for path, counts in sharded.items():
            log(f"launches over the {path} path: {counts}")
        paths.update(sharded)
        log(f"phase 10a: the sharded sparse entry points ({MESH_SHARDS} "
            f"shards of one card: f32, q8, bf16, served, xla, --use_mesh) "
            f"== the single engines, through B1, B2, B3, B4 and B5")
        # phase 6 keeps phase 5's CLI cut on disk, not its host corpora
        del index, refs
        dense, entry = dense_phase(dev, model, seed, card_s, tmp)
    for path, counts in dense.items():
        log(f"launches over the {path} path: {counts}")
    paths.update(dense)
    log("phase 6: the dense path (bf16 and int8 at 8,841,823 x 2048, "
        "served, HTTP, text, eval_dense, the server CLI) through B5")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = checkpoint_phase(dev, model, seed, card_s, tmp)
    for path, counts in ckpt.items():
        log(f"launches over the {path} path: {counts}")
    paths.update(ckpt)
    log("phase 7: the offline pipeline from a checkpoint on disk (1B "
        "checkpoint and adapter, indexing, queries to run.json) through B1, "
        "B4 and B5")
    with tempfile.TemporaryDirectory() as tmp:
        from scaling_retriever_tpu_torch.models.hf_loader import \
            save_pretrained

        save_pretrained(model.params, model.config, os.path.join(tmp, "ckpt"))
        del model
        free()
        trained = training_phase(dev, os.path.join(tmp, "ckpt"), seed,
                                 card_s, tmp)
        for path, counts in trained.items():
            log(f"launches over the {path} path: {counts}")
        paths.update(trained)
        log("phase 8: training at Llama-3.2-1B width (sparse NCE, remat, "
            "accumulation and resume, dense NCE, MNTP), the trained adapter "
            "served through B1, B4 and B5")
        p9 = os.path.join(tmp, "p9")
        os.makedirs(p9)
        t9 = time.perf_counter()
        extra = hybrid_phase(dev, os.path.join(tmp, "ckpt"), seed, card_s, p9)
        extra.update(t5_phase(dev, seed, card_s, p9))
    for path, counts in extra.items():
        log(f"launches over the {path} path: {counts}")
    paths.update(extra)
    log(f"phase 9: hybrid retrieval at Llama-3.2-1B width (sparse through "
        f"B1, B4 and B5, dense through B5), the term-encoder retriever, the "
        f"reranker's bi-encoder body, and T5 at google/t5-v1_1-base width "
        f"trained and served through B1, B4 and B5, in "
        f"{time.perf_counter() - t9:.1f} s")
    free()
    p11 = zipf_phase(dev, seed, card_s)
    for path, counts in p11.items():
        log(f"launches over the {path} path: {counts}")
    paths.update(p11)
    log("phase 11: the power-law index served with skewed traffic "
        "(cost-aware splits, the hot lane) and maxscore, through B1, B4 "
        "and B5")
    report.append(entry)
    moe_report = moe_phase(dev, seed, card_s)
    p12 = deepseek_phase(dev, seed, card_s)
    for path, counts in p12.items():
        log(f"launches over the {path} path: {counts}")
    paths.update(p12)
    log("phase 12: the routed-expert kernels match their plain versions at "
        "DeepSeek-V2-Lite's widths and the text tiles, and launch once per "
        "MoE layer in the whole model's eager tiles")
    attn_report, p13 = attention_phase(dev, seed, card_s)
    for path, counts in p13.items():
        log(f"launches over the {path} path: {counts}")
    paths.update(p13)
    log("phase 13: the attention kernel matches its plain version at "
        "Mistral-7B's, Qwen2-1.5B's and Llama-3.2-1B's text tiles, and "
        "launches once a layer in each one's eager tile")
    kda_report = kda_phase(dev, seed, card_s)
    p14 = kimi_phase(dev, seed, card_s)
    for path, counts in p14.items():
        log(f"launches over the {path} path: {counts}")
    paths.update(p14)
    log("phase 14: the KDA kernel matches its plain steps at Kimi-Linear's "
        "widths and the text tiles; in the whole model's eager tiles it "
        "launches once a KDA layer and the routed-expert kernels once per "
        "MoE layer over a held share of 64 of 256 experts")
    for path, kernels in PATH_KERNELS.items():
        missing = [k_ for k_ in kernels if paths[path][k_] == 0]
        check(not missing, f"{missing} not launched on the {path} path: "
              f"{paths[path]}")
    for r in report:
        r["launches"] = sum(p_[r["name"]] for p_ in paths.values())
    # a routed-expert or KDA kernel's launches in the one tile its entry
    # times
    for r in moe_report + kda_report:
        model_ = "deepseek" if r["layout"] == "deepseek" else "kimi"
        r["launches"] = paths[f"{model_} {r['tile']} tile"][r["name"]]
    report += moe_report + attn_report + kda_report
    check(all(r["launches"] > 0 for r in report),
          f"a kernel was not launched on the main paths: {paths}")
    return report


if __name__ == "__main__":
    sys.exit(main())
