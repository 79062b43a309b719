"""Doc-major impact scoring, the "xla" engine (port of ops/sparse_scoring.py).

    scores[d, q] = sum_k vals[d, k] * Q^T[terms[d, k], q]

over the doc-major index (``SparseIndex.to_doc_major``: [N, K] terms and
values, padding slots term 0 with value 0), with a running top-k merge, so
the full [N, nq] score matrix is never held. The cost is one sweep of the
whole index per query tile, whatever the query: the bounded worst case the
offline driver routes its hot queries to.

The reference scans K single-column gathers per 4096-doc block, to bound a
TPU temporary. In eager PyTorch that is N/block x K launches per tile
(about 276k at MSMARCO scale). Here a step covers several blocks at once:
its [rows, K] slice is a CSR matrix over the vocabulary (K entries per
row, padding included; the values cast to f32), one sparse-dense product
with Q^T gives [rows, nq], and one ``torch.topk`` merges it, with the
step's rows sized to ``step_bytes`` of f32 values. So each entry is read
once and the launches grow with N / rows only. Scores are exact whenever
the products and their sums are (dyadic values): bit-equal to the
reference there.

``make_sharded_retrieve`` is the doc-sharded scan over a mesh: each shard
scans its rows on its device, and the shards' top-k merge on the mesh's
first device.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

STEP_BYTES = 1 << 30


def pad_docs(terms: torch.Tensor, vals: torch.Tensor, block: int):
    """Pad N up to a multiple of ``block`` with zero rows (padding scores
    are 0; callers drop rows >= n_docs after the top-k)."""
    n = terms.shape[0]
    n_pad = -(-n // block) * block
    if n_pad != n:
        terms = F.pad(terms, (0, 0, 0, n_pad - n))
        vals = F.pad(vals, (0, 0, 0, n_pad - n))
    return terms, vals


def _step_rows(n: int, kk: int, block: int, step_bytes: int) -> int:
    """Docs per step: whole blocks whose [rows, K] f32 values fit
    ``step_bytes`` (at least one block)."""
    per_doc = max(1, kk * 4)
    return min(n, max(block, (step_bytes // per_doc) // block * block))


def _score_rows(tb: torch.Tensor, vb: torch.Tensor,
                q_t: torch.Tensor) -> torch.Tensor:
    """[rows, K] postings x q_t [V, nq] -> [rows, nq] f32 scores, as one
    CSR x dense product (padding entries carry value 0)."""
    rows, kk = tb.shape
    crow = torch.arange(0, rows * kk + 1, kk, dtype=tb.dtype,
                        device=tb.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta" notice
        a = torch.sparse_csr_tensor(crow, tb.reshape(-1),
                                    vb.reshape(-1).float(),
                                    (rows, q_t.shape[0]),
                                    check_invariants=False)
    return a @ q_t.float()


def _check(terms, vals, q_t, block: int) -> None:
    if terms.shape != vals.shape:
        raise ValueError(f"terms {tuple(terms.shape)} and vals "
                         f"{tuple(vals.shape)} differ")
    if terms.shape[0] % block:
        raise ValueError(f"N {terms.shape[0]} is not a multiple of block "
                         f"{block} (pad_docs)")
    if not (terms.device == vals.device == q_t.device):
        raise ValueError("terms, vals and q_t must share one device")


def score_doc_major(terms: torch.Tensor, vals: torch.Tensor,
                    q_t: torch.Tensor, block: int = 4096,
                    step_bytes: int = STEP_BYTES) -> torch.Tensor:
    """terms/vals [N, K] (N a multiple of block), q_t [V, nq] dense query
    tile (f32) → scores [N, nq] f32."""
    _check(terms, vals, q_t, block)
    n, kk = terms.shape
    if not n:
        return torch.zeros((0, q_t.shape[1]), device=q_t.device)
    step = _step_rows(n, kk, block, step_bytes)
    return torch.cat([_score_rows(terms[s:s + step], vals[s:s + step], q_t)
                      for s in range(0, n, step)])


def retrieve_doc_major(terms: torch.Tensor, vals: torch.Tensor,
                       q_t: torch.Tensor, k: int, block: int = 4096,
                       step_bytes: int = STEP_BYTES):
    """Fused score + running top-k merge. Returns (scores [nq, k] f32,
    rows [nq, k] int64); unfilled slots are (-inf, -1)."""
    _check(terms, vals, q_t, block)
    n, kk = terms.shape
    nq = q_t.shape[1]
    dev = terms.device
    top_s = torch.full((nq, k), float("-inf"), device=dev)
    top_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    step = _step_rows(n, kk, block, step_bytes)
    for s0 in range(0, n, step):
        s = _score_rows(terms[s0:s0 + step], vals[s0:s0 + step], q_t).T
        rows = torch.arange(s0, s0 + s.shape[1], device=dev).expand(nq, -1)
        cat_s = torch.cat([top_s, s], dim=1)
        cat_i = torch.cat([top_i, rows], dim=1)
        top_s, sel = torch.topk(cat_s, k, dim=1)
        top_i = cat_i.gather(1, sel)
    return top_s, top_i


def merge_shards(scores, rows, k: int, device):
    """Per-shard (scores [nq, k_s], global rows [nq, k_s]) → the top ``k``
    of their concatenation in shard order, on ``device``. The sort is
    stable, so ties keep the lower position, as ``lax.top_k`` does over
    the reference's all-gathered [nq, S * k]."""
    cat_s = torch.cat([s.to(device) for s in scores], dim=1)
    cat_r = torch.cat([r.to(device) for r in rows], dim=1)
    top_s, idx = torch.sort(cat_s, dim=1, descending=True, stable=True)
    return top_s[:, :k], cat_r.gather(1, idx[:, :k])


def make_sharded_retrieve(mesh, axis: str, k: int, block: int = 4096):
    """Doc-sharded retrieval over ``mesh``: each shard scores its rows
    (``retrieve_doc_major`` on its device), maps its local rows to global
    ones, and the shards' top-k merge on ``mesh.device``.

    Returns fn(terms_shards, vals_shards, row_ids_shards, q_t) → (scores
    [nq, k], global rows [nq, k]). Where the reference takes arrays sharded
    over ``axis``, this takes one tensor per mesh entry, in mesh order
    (shard i on ``mesh.devices[i]``); q_t [V, nq] is copied to each."""
    del axis                                 # the shards are the lists

    def fn(terms_shards, vals_shards, row_ids_shards, q_t):
        scores, rows = [], []
        for terms, vals, row_ids in zip(terms_shards, vals_shards,
                                        row_ids_shards):
            s, r = retrieve_doc_major(terms, vals, q_t.to(terms.device),
                                      k=k, block=block)
            scores.append(s)
            rows.append(row_ids[r])
        return merge_shards(scores, rows, k, mesh.device)

    return fn
