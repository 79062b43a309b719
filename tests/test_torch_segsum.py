"""Segmented sum + run-end mask of the torch port
(scaling_retriever_tpu_torch/ops/segsum.py) against the JAX package's
``segsum_mask`` (Pallas, interpret mode on the CPU). Contributions are
dyadic rationals, so f32 sums are exact in any order and the comparison is
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.ops.pallas_segsum import _block_rows
from scaling_retriever_tpu.ops.pallas_segsum import segsum_mask as ref_segsum
from scaling_retriever_tpu.ops.segsort_scoring import \
    _segsum_passes as ref_passes
from scaling_retriever_tpu_torch.ops import segsum

torch.set_num_threads(1)

SENTINEL = 1 << 20


def _sorted_runs(rng, nq, P, max_run, sentinel=SENTINEL):
    """Increasing group ids with run lengths in [1, max_run], then a
    sentinel tail of random length (which may straddle blocks)."""
    keys = []
    for _ in range(nq):
        ks, gid = [], 0
        while len(ks) < P:
            run = min(int(rng.integers(1, max_run + 1)), P - len(ks))
            ks.extend([gid] * run)
            gid += 1
        arr = np.array(ks, np.int32)
        nsent = int(rng.integers(0, P // 3))
        if nsent:
            arr[-nsent:] = sentinel
        keys.append(arr)
    return np.stack(keys)


def _dyadic(rng, srow, sentinel=SENTINEL):
    sc = rng.integers(-8, 8, srow.shape).astype(np.float32) / 4.0
    sc[srow == sentinel] = 0.0
    return sc


def _check(srow, sc, max_run, sentinel=SENTINEL):
    want = np.asarray(ref_segsum(jnp.asarray(srow), jnp.asarray(sc), sentinel,
                                 max_run, interpret=True))
    got = segsum.segsum_mask(torch.from_numpy(srow), torch.from_numpy(sc),
                             sentinel, max_run)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nq,P,max_run", [(3, 2048, 64), (1, 5120, 128),
                                          (2, 1024, 1), (2, 3072, 128)])
def test_segsum_mask_matches_reference(nq, P, max_run):
    rng = np.random.default_rng(P + max_run)
    srow = _sorted_runs(rng, nq, P, max_run)
    _check(srow, _dyadic(rng, srow), max_run)


def test_segsum_mask_block_boundary_runs():
    """Runs ending exactly at, and straddling, the reference kernel's block
    boundaries (its cross-block carry)."""
    rng = np.random.default_rng(7)
    max_run = 64
    P = 33792  # 264 rows of 128 -> 3 reference blocks of 88 rows
    brs = _block_rows(P // 128) * 128
    assert P // brs == 3
    rows = []
    for q in range(2):
        ks, gid, pos = [], 0, 0
        while pos < P:
            run = int(rng.integers(1, max_run + 1))
            edge = (pos // brs + 1) * brs
            if pos + run > edge and (edge // brs + q) % 2:
                run = edge - pos        # this run ends AT the boundary
            run = min(run, P - pos)
            ks += [gid] * run
            gid, pos = gid + 1, pos + run
        arr = np.array(ks, np.int32)
        arr[-brs // 2:] = SENTINEL      # sentinel tail inside the last block
        rows.append(arr)
    srow = np.stack(rows)
    _check(srow, _dyadic(rng, srow), max_run)


def test_segsum_mask_sentinel_rows():
    """A row that is all sentinel, and a row of pairs."""
    rng = np.random.default_rng(3)
    srow = np.stack([np.full(1024, 999, np.int32),
                     np.repeat(np.arange(512, dtype=np.int32), 2)])
    sc = _dyadic(rng, srow, 999)
    _check(srow, sc, 64, sentinel=999)


def test_segsum_passes_matches_reference():
    """The plain doubling passes, used for shapes the kernel does not take
    (and as the kernel's plain version)."""
    rng = np.random.default_rng(5)
    srow = _sorted_runs(rng, 2, 700, 16)
    sc = rng.uniform(-2, 2, srow.shape).astype(np.float32)
    want = np.asarray(ref_passes(jnp.asarray(sc), jnp.asarray(srow), 1, 16))
    got = segsum._segsum_passes(torch.from_numpy(sc), torch.from_numpy(srow),
                                1, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eligibility_gates():
    assert segsum.eligible(1024, 64)
    assert segsum.eligible(524288, 128)
    assert not segsum.eligible(1025, 64)
    assert not segsum.eligible(512, 64)
    assert not segsum.eligible(1024, 129)
    assert not segsum.eligible(1024, 0)
    with pytest.raises(ValueError):
        segsum.segsum_mask(torch.zeros(1, 512, dtype=torch.int32),
                           torch.zeros(1, 512), 0, 8)
