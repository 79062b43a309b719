"""Posting fetch for the segsort engine (port of ops/pallas_fetch.py).

Each (query, term) pair reads one contiguous CSR slice, so the fetch is a
set of fixed-size copies ("jobs") rather than a row gather: a term's slice
is rounded down to an ALIGN-aligned source and covered by CHUNK-posting
jobs, job j of a query landing in slot j of its [J * CHUNK] output row.
The job table says, per job, where to read, which of its slots are valid
and the query weight to attach.

The kernels (``csrc/fetch.cu``) fuse what the JAX package does in separate
passes after its copy: invalid slots get the sentinel row and a zero
contribution, valid slots get ``value * weight``. So the functions here
return ``(rows, contrib)`` where the reference returned
``(rows, vals, qw, valid)``; ``rows`` equals the reference's
``where(valid, rows, sentinel)`` and ``contrib`` its
``where(valid, vals * qw, 0)`` bit for bit.

Three value layouts share the job machinery: f32 (rows and value bits in
two int32 streams) and q8 (one ``(row24 << 8) | code8`` word per posting)
use CHUNK-posting jobs from ALIGN-aligned sources; the bf16-pair layout
(rows plus one int32 word per two little-endian bf16 values, 6 B per
posting) uses CHUNK2-posting jobs from CHUNK2-aligned sources, so the
value words of a job start at ``src // 2``.

Each kernel has a plain PyTorch version of the same function beside it.
The wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from scaling_retriever_tpu_torch.ops import cuda_lib

CHUNK = 1024    # postings per job (f32, q8)
ALIGN = 1024    # job source alignment, in postings (f32, q8)
CHUNK2 = 2048   # postings per job and source alignment of the bf16 layout
# q8 words carry 24-bit rows: (row24 << 8) | code8
Q8_ROW_LIMIT = 1 << 24


def _job_table(src_al: torch.Tensor, prev_jobs: torch.Tensor,
               cum_jobs: torch.Tensor, region_start: torch.Tensor,
               region_end: torch.Tensor, q_vals: torch.Tensor,
               jobs_per_query: int, chunk: int = CHUNK):
    """(src_j, jv_start, jv_end, j_qv), each [nq, J]: per-job source
    address, valid-slot bounds (positions in the query's output row) and
    query weight; idle job slots are all zero.

    The term of job slot s is the one with prev_jobs <= s < cum_jobs; the
    reference finds it with a [nq, T, J] compare (or a T-step scan), this
    finds it with one ``searchsorted`` over the cumulative job counts. The
    intervals are disjoint, so both give the same table."""
    nq, T = src_al.shape
    slot = torch.arange(jobs_per_query, device=src_al.device,
                        dtype=cum_jobs.dtype).expand(nq, jobs_per_query)
    term = torch.searchsorted(cum_jobs.contiguous(), slot.contiguous(),
                              right=True)
    used = term < T
    term = term.clamp_max(T - 1)

    def pick(per_term):
        return torch.where(used, per_term.gather(1, term),
                           torch.zeros((), dtype=per_term.dtype,
                                       device=per_term.device))

    src_j = torch.where(
        used, src_al.gather(1, term) + (slot - prev_jobs.gather(1, term)) * chunk,
        0)
    return src_j, pick(region_start), pick(region_end), pick(q_vals)


def job_table(q_terms: torch.Tensor, offsets: torch.Tensor,
              q_vals: torch.Tensor, jobs_per_query: int, nnz: int,
              chunk: int = CHUNK):
    """The fetch's inputs for one query tile: (src [nq*J] int64 clamped into
    the flat arrays, jv_start [nq*J] int32, jv_end [nq*J] int32, j_qv
    [nq*J] f32, total [nq] int64 = valid postings per query). ``q_vals``
    must already carry any q8 dequant scale. ``chunk`` is the layout's job
    size, CHUNK or CHUNK2; every layout aligns its sources to its job size
    (ALIGN == CHUNK)."""
    nq, T = q_terms.shape
    qt = q_terms.long()
    lens = (offsets[qt + 1] - offsets[qt]) * (q_vals > 0)
    starts = offsets[qt]
    src_al = (starts // chunk) * chunk
    head = starts - src_al
    n_jobs = torch.where(lens > 0, -(-(head + lens) // chunk), 0)
    cum_jobs = torch.cumsum(n_jobs, dim=1)
    prev_jobs = cum_jobs - n_jobs
    region_start = prev_jobs * chunk + head
    region_end = region_start + lens
    src_j, jv_start, jv_end, j_qv = _job_table(
        src_al, prev_jobs, cum_jobs, region_start, region_end,
        q_vals.float(), jobs_per_query, chunk)
    # callers pad the flat arrays by one job (SegsortEngine does), so every
    # aligned window is in bounds; the clamp guards idle slots only
    max_src = ((nnz - chunk) // chunk) * chunk
    base = torch.arange(jobs_per_query, device=q_terms.device) * chunk
    per_job = (torch.minimum(jv_end, base + chunk)
               - torch.maximum(jv_start, base)).clamp_min(0)
    return (src_j.reshape(-1).clamp(0, max_src).contiguous(),
            jv_start.reshape(-1).to(torch.int32).contiguous(),
            jv_end.reshape(-1).to(torch.int32).contiguous(),
            j_qv.reshape(-1).contiguous(),
            per_job.sum(dim=1))


def _plain_windows(src, jv_start, jv_end, jobs_per_query, chunk=CHUNK):
    n = src.shape[0]
    lane = torch.arange(chunk, device=src.device)
    pos = (torch.arange(n, device=src.device) % jobs_per_query)[:, None] \
        * chunk + lane
    valid = (pos >= jv_start[:, None]) & (pos < jv_end[:, None])
    return src[:, None] + lane, valid


def fetch_jobs_plain(rows_flat, valbits_flat, src, jv_start, jv_end, j_qv,
                     jobs_per_query: int, sentinel: int):
    """Plain version of the f32 fetch kernel: (rows, contrib) [nq*J*CHUNK]."""
    idx, valid = _plain_windows(src, jv_start, jv_end, jobs_per_query)
    rows = torch.where(valid, rows_flat[idx], sentinel)
    vals = valbits_flat[idx].view(torch.float32)
    contrib = torch.where(valid, vals * j_qv[:, None], 0.0)
    return rows.reshape(-1), contrib.reshape(-1)


def fetch_jobs_q8_plain(packed_flat, src, jv_start, jv_end, j_qv,
                        jobs_per_query: int, sentinel: int):
    """Plain version of the q8 fetch kernel. int32 ``>>`` is arithmetic in
    torch (and ``>>`` on uint32 has no CPU kernel), so the row is
    ``(w >> 8) & 0xFFFFFF``: rows >= 2^23 set the word's sign bit."""
    idx, valid = _plain_windows(src, jv_start, jv_end, jobs_per_query)
    w = packed_flat[idx]
    rows = torch.where(valid, (w >> 8) & 0xFFFFFF, sentinel)
    contrib = torch.where(valid, (w & 0xFF).float() * j_qv[:, None], 0.0)
    return rows.reshape(-1), contrib.reshape(-1)


def unpack_bf16_pairs(words: torch.Tensor) -> torch.Tensor:
    """int32 words [..., n] → f32 [..., 2n]: the low half of word i is
    value 2i, the high half value 2i+1 (little-endian pairs). A bf16 is
    the top half of an f32, so each half is moved there with a left shift
    or a mask; neither touches torch's arithmetic ``>>``."""
    lo = torch.bitwise_left_shift(words, 16)
    hi = words & -0x10000                       # 0xFFFF0000 as int32
    return torch.stack([lo, hi], dim=-1).flatten(-2).view(torch.float32)


def fetch_jobs_bf16_plain(rows_flat, valpacked_flat, src, jv_start, jv_end,
                          j_qv, jobs_per_query: int, sentinel: int):
    """Plain version of the bf16-pair fetch kernel: job j copies the CHUNK2
    rows at ``src[j]`` and the CHUNK2 // 2 value words at ``src[j] // 2``.
    Returns (rows, contrib) [nq*J*CHUNK2]."""
    idx, valid = _plain_windows(src, jv_start, jv_end, jobs_per_query, CHUNK2)
    rows = torch.where(valid, rows_flat[idx], sentinel)
    widx = (src // 2)[:, None] + torch.arange(CHUNK2 // 2, device=src.device)
    vals = unpack_bf16_pairs(valpacked_flat[widx])
    contrib = torch.where(valid, vals * j_qv[:, None], 0.0)
    return rows.reshape(-1), contrib.reshape(-1)


def _check_table(src, jv_start, jv_end, j_qv, device):
    cuda_lib.check_cuda("src", src, torch.int64, device)
    cuda_lib.check_cuda("jv_start", jv_start, torch.int32, device)
    cuda_lib.check_cuda("jv_end", jv_end, torch.int32, device)
    cuda_lib.check_cuda("j_qv", j_qv, torch.float32, device)
    n = src.shape[0]
    if not (jv_start.shape[0] == jv_end.shape[0] == j_qv.shape[0] == n):
        raise ValueError("job table columns differ in length")


def fetch_jobs(rows_flat, valbits_flat, src, jv_start, jv_end, j_qv,
               jobs_per_query: int, sentinel: int, site: str = "fetch_f32"):
    """f32 fetch (kernel B1): job j copies the CHUNK postings at
    ``src[j]`` into slots [j*CHUNK, (j+1)*CHUNK), masked and weighted.
    Returns (rows int32, contrib f32), each [len(src) * CHUNK]. ``site``
    is the launch counter (B1 has two call sites: the segsort engine's
    on-device job table and the block-max engine's host-built one)."""
    if rows_flat.device.type == "cpu":
        return fetch_jobs_plain(rows_flat, valbits_flat, src, jv_start,
                                jv_end, j_qv, jobs_per_query, sentinel)
    if rows_flat.device.type != "cuda":
        raise ValueError(f"no fetch for device {rows_flat.device}")
    dev = rows_flat.device
    cuda_lib.check_cuda("rows_flat", rows_flat, torch.int32, dev)
    cuda_lib.check_cuda("valbits_flat", valbits_flat, torch.int32, dev)
    if valbits_flat.shape != rows_flat.shape:
        raise ValueError("rows_flat and valbits_flat differ in length")
    _check_table(src, jv_start, jv_end, j_qv, dev)
    n = src.shape[0]
    rows = torch.empty(n * CHUNK, dtype=torch.int32, device=dev)
    contrib = torch.empty(n * CHUNK, dtype=torch.float32, device=dev)
    if n:
        cuda_lib.launch(site, "srt_fetch_f32", dev,
                        src.data_ptr(), jv_start.data_ptr(),
                        jv_end.data_ptr(), j_qv.data_ptr(),
                        rows_flat.data_ptr(), valbits_flat.data_ptr(),
                        rows.data_ptr(), contrib.data_ptr(), n,
                        jobs_per_query, sentinel)
    return rows, contrib


def fetch_jobs_q8(packed_flat, src, jv_start, jv_end, j_qv,
                  jobs_per_query: int, sentinel: int):
    """q8 fetch (kernel B2): one stream of ``(row24 << 8) | code8`` words,
    decoded with a logical shift; contrib = code * (scale-folded) weight."""
    if packed_flat.device.type == "cpu":
        return fetch_jobs_q8_plain(packed_flat, src, jv_start, jv_end, j_qv,
                                   jobs_per_query, sentinel)
    if packed_flat.device.type != "cuda":
        raise ValueError(f"no fetch for device {packed_flat.device}")
    dev = packed_flat.device
    cuda_lib.check_cuda("packed_flat", packed_flat, torch.int32, dev)
    _check_table(src, jv_start, jv_end, j_qv, dev)
    n = src.shape[0]
    rows = torch.empty(n * CHUNK, dtype=torch.int32, device=dev)
    contrib = torch.empty(n * CHUNK, dtype=torch.float32, device=dev)
    if n:
        cuda_lib.launch("fetch_q8", "srt_fetch_q8", dev,
                        src.data_ptr(), jv_start.data_ptr(),
                        jv_end.data_ptr(), j_qv.data_ptr(),
                        packed_flat.data_ptr(), rows.data_ptr(),
                        contrib.data_ptr(), n, jobs_per_query, sentinel)
    return rows, contrib


def fetch_jobs_bf16(rows_flat, valpacked_flat, src, jv_start, jv_end,
                    j_qv, jobs_per_query: int, sentinel: int):
    """bf16-pair fetch (kernel B3): job j copies the CHUNK2 postings at the
    CHUNK2-aligned ``src[j]`` into slots [j*CHUNK2, (j+1)*CHUNK2), values
    widened to f32, masked and weighted. Returns (rows int32, contrib f32),
    each [len(src) * CHUNK2]."""
    if rows_flat.device.type == "cpu":
        return fetch_jobs_bf16_plain(rows_flat, valpacked_flat, src,
                                     jv_start, jv_end, j_qv, jobs_per_query,
                                     sentinel)
    if rows_flat.device.type != "cuda":
        raise ValueError(f"no fetch for device {rows_flat.device}")
    dev = rows_flat.device
    cuda_lib.check_cuda("rows_flat", rows_flat, torch.int32, dev)
    cuda_lib.check_cuda("valpacked_flat", valpacked_flat, torch.int32, dev)
    if 2 * valpacked_flat.shape[0] < rows_flat.shape[0]:
        raise ValueError("valpacked_flat holds fewer than len(rows_flat) "
                         "values")
    _check_table(src, jv_start, jv_end, j_qv, dev)
    n = src.shape[0]
    rows = torch.empty(n * CHUNK2, dtype=torch.int32, device=dev)
    contrib = torch.empty(n * CHUNK2, dtype=torch.float32, device=dev)
    if n:
        cuda_lib.launch("fetch_bf16", "srt_fetch_bf16", dev,
                        src.data_ptr(), jv_start.data_ptr(),
                        jv_end.data_ptr(), j_qv.data_ptr(),
                        rows_flat.data_ptr(), valpacked_flat.data_ptr(),
                        rows.data_ptr(), contrib.data_ptr(), n,
                        jobs_per_query, sentinel)
    return rows, contrib


def fetch_postings_dma(rows_flat, valbits_flat, q_terms, offsets, q_vals,
                       jobs_per_query: int, sentinel: int,
                       fetch=fetch_jobs):
    """rows_flat/valbits_flat [nnz] int32 (value bits), q_terms/q_vals
    [nq, T], offsets [V+1] int64 on the same device. Returns (rows [nq, Pp]
    int32, contrib [nq, Pp] f32, total [nq]) with Pp = J * CHUNK."""
    nq = q_terms.shape[0]
    src, jvs, jve, jqv, total = job_table(q_terms, offsets, q_vals,
                                          jobs_per_query, rows_flat.shape[0])
    rows, contrib = fetch(rows_flat, valbits_flat, src, jvs, jve, jqv,
                          jobs_per_query, sentinel)
    return rows.view(nq, -1), contrib.view(nq, -1), total


def fetch_postings_dma_q8(packed_flat, q_terms, offsets, q_vals,
                          jobs_per_query: int, sentinel: int,
                          fetch=fetch_jobs_q8):
    """q8 twin of ``fetch_postings_dma``: ``q_vals`` must already carry the
    per-term dequant scales (SegsortEngine folds them)."""
    nq = q_terms.shape[0]
    src, jvs, jve, jqv, total = job_table(q_terms, offsets, q_vals,
                                          jobs_per_query, packed_flat.shape[0])
    rows, contrib = fetch(packed_flat, src, jvs, jve, jqv, jobs_per_query,
                          sentinel)
    return rows.view(nq, -1), contrib.view(nq, -1), total


def fetch_postings_dma_bf16(rows_flat, valpacked_flat, q_terms, offsets,
                            q_vals, jobs_per_query: int, sentinel: int,
                            fetch=fetch_jobs_bf16):
    """bf16-pair twin of ``fetch_postings_dma``: rows_flat [nnz + pad]
    int32, valpacked_flat int32 with 2 * len >= len(rows_flat). Returns
    (rows [nq, Pp] int32, contrib [nq, Pp] f32, total [nq]) with
    Pp = J * CHUNK2."""
    nq = q_terms.shape[0]
    src, jvs, jve, jqv, total = job_table(q_terms, offsets, q_vals,
                                          jobs_per_query, rows_flat.shape[0],
                                          CHUNK2)
    rows, contrib = fetch(rows_flat, valpacked_flat, src, jvs, jve, jqv,
                          jobs_per_query, sentinel)
    return rows.view(nq, -1), contrib.view(nq, -1), total
