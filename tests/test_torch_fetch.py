"""Posting fetch of the torch port (scaling_retriever_tpu_torch/ops/fetch.py)
against the JAX package's ``fetch_postings_dma*`` (Pallas, interpret mode
on the CPU). The port fuses the reference's masking pass into the fetch,
so it is compared with the reference's ``where(valid, rows, sentinel)`` and
``where(valid, vals * qw, 0)``: bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.ops import pallas_fetch as ref
from scaling_retriever_tpu_torch.ops import fetch

torch.set_num_threads(1)

SENTINEL = (1 << 24) - 1


def _corpus(rng, V=40, high_rows=False):
    """Random CSR: empty terms, terms shorter than a chunk, and terms that
    straddle several chunks."""
    lens = rng.integers(0, 2600, V)
    lens[rng.choice(V, 5, replace=False)] = 0
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    nnz = int(offsets[-1])
    lo = (1 << 23) if high_rows else 0
    rows = rng.integers(lo, SENTINEL, nnz + fetch.CHUNK).astype(np.int32)
    vals = rng.uniform(0.01, 3.0, nnz + fetch.CHUNK).astype(np.float32)
    return offsets, rows, vals


def _queries(rng, V, nq=3, T=6):
    qt = rng.integers(0, V, (nq, T)).astype(np.int32)
    qv = rng.uniform(0.1, 2.0, (nq, T)).astype(np.float32)
    qv[rng.random((nq, T)) < 0.2] = 0.0
    return qt, qv


def _masked(out):
    rows, vals, qw, valid = (np.asarray(x) for x in out)
    return (np.where(valid, rows, SENTINEL),
            np.where(valid, vals * qw, np.float32(0.0)),
            valid.sum(axis=1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("use_scan", [False, True])
def test_job_table_matches_reference(use_scan):
    rng = np.random.default_rng(1)
    offsets, _, _ = _corpus(rng)
    qt, qv = _queries(rng, len(offsets) - 1, nq=4, T=8)
    starts = offsets[qt]
    lens = (offsets[qt + 1] - starts) * (qv > 0)
    src_al = (starts // fetch.ALIGN) * fetch.ALIGN
    head = starts - src_al
    n_jobs = np.where(lens > 0, -(-(head + lens) // fetch.CHUNK), 0)
    cum = np.cumsum(n_jobs, axis=1)
    prev = cum - n_jobs
    r_start = prev * fetch.CHUNK + head
    r_end = r_start + lens
    J = int(cum[:, -1].max()) + 3   # idle slots at the end of every row
    want = ref._job_table(*(jnp.asarray(a.astype(np.int32)) for a in
                            (src_al, prev, cum, r_start, r_end)),
                          jnp.asarray(qv), J, use_scan)
    got = fetch._job_table(*(_t(a) for a in
                             (src_al, prev, cum, r_start, r_end, qv)), J)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("jobs", [None, 2])
def test_fetch_f32_matches_reference(jobs):
    """``jobs=2`` truncates most queries' job tables (the handoff's
    over-bucket case): both packages must drop the same postings."""
    rng = np.random.default_rng(2)
    offsets, rows, vals = _corpus(rng)
    qt, qv = _queries(rng, len(offsets) - 1)
    need = int(fetch.job_table(_t(qt), _t(offsets), _t(qv), 4096,
                               len(rows))[4].max())
    J = jobs or need + 1
    want = _masked(ref.fetch_postings_dma(
        jnp.asarray(rows), jnp.asarray(vals.view(np.int32)), jnp.asarray(qt),
        jnp.asarray(offsets), jnp.asarray(qv), J, interpret=True))
    got = fetch.fetch_postings_dma(_t(rows), _t(vals.view(np.int32)), _t(qt),
                                   _t(offsets), _t(qv), J, SENTINEL)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())


def test_fetch_q8_matches_reference_high_rows():
    """Rows >= 2^23 set the sign bit of the packed word: the decode must be
    a logical shift."""
    rng = np.random.default_rng(3)
    offsets, rows, _ = _corpus(rng, high_rows=True)
    codes = rng.integers(0, 256, len(rows)).astype(np.uint32)
    packed = ((rows.astype(np.uint32) << np.uint32(8)) | codes).view(np.int32)
    assert (packed < 0).any()
    qt, qv = _queries(rng, len(offsets) - 1)
    J = int(fetch.job_table(_t(qt), _t(offsets), _t(qv), 4096,
                            len(rows))[4].max()) + 1
    want = _masked(ref.fetch_postings_dma_q8(
        jnp.asarray(packed), jnp.asarray(qt), jnp.asarray(offsets),
        jnp.asarray(qv), J, interpret=True))
    got = fetch.fetch_postings_dma_q8(_t(packed), _t(qt), _t(offsets), _t(qv),
                                      J, SENTINEL)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())
    valid_rows = got[0].numpy()[got[0].numpy() != SENTINEL]
    assert (valid_rows >= 1 << 23).all()
