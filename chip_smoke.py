"""Smoke run of the torch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):
  1. build the CUDA kernels from scaling_retriever_tpu_torch/csrc with nvcc
     for sm_90a;
  2. generate an MSMARCO-scale index on the card (8,841,823 docs, 128
     postings per doc, vocab 128,256: 1,131,730,944 postings) in the f32
     and q8 layouts, and hold each kernel against its plain PyTorch version
     at the main path's shapes (64 queries x 512 jobs = 524,288 slots per
     query, 4096-slot blocks, m = 32), timing kernel, plain version and,
     where one exists, a single PyTorch call computing the same function;
  3. run 64-query tiles through SegsortEngine on both layouts and compare
     the kernel path's top-1000 with the plain path's (tie-equal), plus a
     small index against a brute-force oracle;
  4. serve text through the published Llama-3.2-1B architecture (random
     bf16 weights from --seed): QueryEncoderFrontend over RetrievalServer
     on the q8 index (device handoff), and pre-encoded requests through
     RetrievalServer.submit on the f32 index; launch counts of every kernel
     are read over exactly this phase;
  5. print the card, per-kernel numbers as one JSON line, and last
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_DOCS = 8_841_823
K_PER_DOC = 128
VOCAB = 128_256
L0_Q = 48
TILE = 64
T_BUDGET = 64
TOPK = 1000
JOBS = 512
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM data sheet, non-tensor f32


def log(*a) -> None:
    print(*a, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    tb, to = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def gen_index(dev):
    """bench.py's synthetic CSR, on the card: row = hash(i) mod-folded into
    [0, N_DOCS), every value 1.0. The hash runs in int64 masked to 32 bits
    (torch's uint32 ops on CUDA are limited). Returns (rows i32, valbits
    i32, packed q8 i32, host offsets, host scales)."""
    per_term = (N_DOCS * K_PER_DOC) // VOCAB
    nnz = per_term * VOCAB
    n = nnz + 1024
    rows = torch.full((n,), N_DOCS, dtype=torch.int32, device=dev)
    pad_word = N_DOCS << 8
    pad_word -= (1 << 32) if pad_word >= 1 << 31 else 0   # as signed int32
    packed = torch.full((n,), pad_word, dtype=torch.int32, device=dev)
    step = 1 << 27
    for s in range(0, nnz, step):
        i = torch.arange(s, min(s + step, nnz), dtype=torch.int64, device=dev)
        h = (i * 2654435761) & 0xFFFFFFFF
        h = (h ^ (h >> 13)) & 0xFFFFFF
        r = h % N_DOCS          # = bench.py's h - N_DOCS fold (2^24 < 2N)
        rows[s:s + len(i)] = r.to(torch.int32)
        w = (r << 8) | 255                      # code 255 = value 1.0
        packed[s:s + len(i)] = torch.where(w >= 1 << 31, w - (1 << 32),
                                           w).to(torch.int32)
    one = int(np.float32(1.0).view(np.int32))
    valbits = torch.full((n,), one, dtype=torch.int32, device=dev)
    valbits[nnz:] = 0
    offsets = np.arange(VOCAB + 1, dtype=np.int64) * per_term
    scales = np.full(VOCAB, np.float32(1.0) / np.float32(255.0), np.float32)
    return rows, valbits, packed, offsets, scales, nnz


def query_tiles(rng, n):
    out = []
    for _ in range(n):
        qt = rng.integers(0, VOCAB, (TILE, T_BUDGET)).astype(np.int32)
        qv = rng.uniform(0.1, 2.0, (TILE, T_BUDGET)).astype(np.float32)
        qv[:, L0_Q:] = 0.0
        out.append((qt, qv))
    return out


def kernel_phase(dev, eng_f32, eng_q8, tile, card_s):
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
    slots = TILE * JOBS * 1024
    table_bytes = TILE * JOBS * (8 + 4 + 4 + 4)
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
    for name, fn, plain, args, post_bytes, src_file, line in (
            ("fetch_f32", fetch.fetch_jobs, fetch.fetch_jobs_plain, f32_args,
             8, "fetch.cu", "scaling_retriever_tpu/ops/pallas_fetch.py:54"),
            ("fetch_q8", fetch.fetch_jobs_q8, fetch.fetch_jobs_q8_plain,
             q8_args, 4, "fetch.cu",
             "scaling_retriever_tpu/ops/pallas_fetch.py:137")):
        b_ms, b_by = bound(table_bytes + valid * post_bytes + slots * 8,
                           valid)
        report.append({
            "name": name, "route": "cuda",
            "source": f"scaling_retriever_tpu_torch/csrc/{src_file}",
            "replaces": line, "launches": 0, "max_abs_err": 0.0,
            "ms": time_ms(lambda: fn(*args), 20),
            "plain_ms": time_ms(lambda: plain(*args), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

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
    nblk = P // block
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
            lambda: torch.topk(out.view(TILE, nblk, block), m), 20)})
    for r in report:
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}) per {TILE}-query tile; card {card_s}")
    return report


def engine_phase(dev, eng_f32, eng_q8, tiles, card_s):
    """Phase 3: SegsortEngine (kernels) vs the plain path on full tiles,
    and tile times through the depth-2 pipeline."""
    from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
    from scaling_retriever_tpu_torch.utils.utils import (
        depth2_pipeline, tie_equal_topk)

    for name, eng in (("f32", eng_f32), ("q8", eng_q8)):
        for qt, qv in tiles[:3]:
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
            else:
                s0, r0, _ = ss.segsort_retrieve_dma(
                    eng.rows_flat, eng.valbits_flat, eng.offsets, qtd, qvd,
                    TOPK, J, N_DOCS, ops=ss.PLAIN)
            s0, r0 = s0.cpu().numpy(), r0.cpu().numpy()
            check(np.isfinite(s1).all() and s1.shape == (TILE, TOPK),
                  f"{name}: non-finite or short top-{TOPK}")
            for q in range(TILE):
                tie_equal_topk(r0[q], s0[q], r1[q], s1[q], rtol=1e-5)
        n = 8
        t0 = time.perf_counter()
        depth2_pipeline(tiles[:n], lambda t: eng.retrieve_tile_async(
            None, TOPK, sparsified=t), eng.finalize)
        ms = (time.perf_counter() - t0) * 1e3 / n
        log(f"engine {name}: kernel path == plain path (tie-equal, rtol 1e-5)"
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


class StandInTokenizer:
    """Texts of words "w<id>" → token id = id mod vocab, left-padded to the
    smallest length rung that holds the batch (the stand-in for the
    Llama-3 tokenizer, whose files are not in the repository)."""

    def __init__(self, vocab: int, lengths=(16, 64)):
        self.vocab = vocab
        self.lengths = tuple(lengths)

    def __call__(self, texts, length=None):
        toks = [[int(w[1:]) % self.vocab for w in t.split()] for t in texts]
        if length is None:
            need = max(len(t) for t in toks)
            length = next(r for r in self.lengths if r >= need)
        ids = np.zeros((len(texts), length), np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, t in enumerate(toks):
            t = t[:length]
            if t:
                ids[i, length - len(t):] = t
                mask[i, length - len(t):] = 1
        return ids, mask


def serving_phase(dev, eng_f32, eng_q8, seed, card_s):
    """Phase 4: text serving at Llama-3.2-1B width (q8 handoff) and
    pre-encoded serving (f32). Returns the launch counts of the phase."""
    from scaling_retriever_tpu_torch.models.config import (LLAMA_3_2_1B,
                                                           ModelConfig)
    from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
    from scaling_retriever_tpu_torch.models.weights import random_params
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.serving.server import (
        RetrievalServer, SparseTileBackend)
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, make_encode_fn_handoff)
    from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

    cfg = ModelConfig.from_hf_config(LLAMA_3_2_1B, dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaBiSparse(random_params(cfg, seed, dev), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"encoder: Llama-3.2-1B architecture, {n_params} params bf16, "
        f"random from seed {seed}, on card in "
        f"{time.perf_counter() - t0:.1f} s")

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
        w = fe.warmup(short[:8] + long[:8], passes=2)
        log(f"frontend warmup: {w}")
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
        launches = dict(cuda_lib.LAUNCHES)
        # ---- end of the main path ----

        log(f"text serving (q8 index, device handoff): {len(text_res)} "
            f"requests in {text_s:.2f} s = {len(text_res) / text_s:.1f} QPS;"
            f" encode {enc_ms[16]:.2f} ms (16-token rung) / {enc_ms[64]:.2f}"
            f" ms (64-token rung) per {TILE}-query tile; handoff retrieve "
            f"{retr_ms:.2f} ms per tile (bucket {fe.jobs_bucket} jobs); "
            f"frontend {fe.stats()}; card {card_s}")
        log(f"pre-encoded serving (f32 index): {len(f32_res)} requests in "
            f"{f32_s:.2f} s = {len(f32_res) / f32_s:.1f} QPS; "
            f"server {srv_f32.stats()}; card {card_s}")

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
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from scaling_retriever_tpu_torch.ops import cuda_lib
    from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine

    dev = torch.device("cuda", 0)
    card_s = card()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; card {card_s}")

    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    cuda_lib.library()
    log(f"phase 1: built {lib} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows, valbits, packed, offsets, scales, nnz = gen_index(dev)
    eng_f32 = SegsortEngine(topk=TOPK, query_terms_budget=T_BUDGET,
                            device_csr=(rows, valbits, offsets, N_DOCS))
    eng_q8 = SegsortEngine(topk=TOPK, query_terms_budget=T_BUDGET,
                           val_dtype="q8",
                           device_csr=(packed, scales, offsets, N_DOCS))
    log(f"index: {nnz} postings on card in {time.perf_counter() - t0:.1f} s "
        f"(f32 {(rows.nbytes + valbits.nbytes) / 1e9:.1f} GB, q8 "
        f"{packed.nbytes / 1e9:.1f} GB)")

    tiles = query_tiles(np.random.default_rng(args.seed), 9)
    report = kernel_phase(dev, eng_f32, eng_q8, tiles[0], card_s)
    log("phase 2: every kernel matches its plain version")
    engine_phase(dev, eng_f32, eng_q8, tiles, card_s)
    log("phase 3: engine kernel path matches the plain path")
    launches = serving_phase(dev, eng_f32, eng_q8, args.seed, card_s)
    for r in report:
        r["launches"] = launches[r["name"]]
    check(all(r["launches"] > 0 for r in report),
          f"a kernel was not launched on the main path: {launches}")
    log("phase 4: served text and pre-encoded requests through the kernels")
    log(card_s)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
