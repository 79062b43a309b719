"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU. This file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed; ``tests/conftest.py`` imports JAX, hence
``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import cuda_lib, fetch, segsum, topm
from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

pytestmark = pytest.mark.cuda

SENTINEL = (1 << 24) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("layout", ["f32", "q8"])
def test_fetch_kernel_matches_plain(cuda, layout):
    rng = np.random.default_rng(4)
    V = 40
    lens = rng.integers(0, 2600, V)
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    n = int(offsets[-1]) + fetch.CHUNK
    rows = rng.integers(1 << 22, SENTINEL, n).astype(np.int32)
    qt = rng.integers(0, V, (8, 12)).astype(np.int32)
    qv = rng.uniform(0.1, 2.0, (8, 12)).astype(np.float32)
    qv[rng.random(qv.shape) < 0.2] = 0.0
    table = fetch.job_table(_t(qt, cuda), _t(offsets, cuda), _t(qv, cuda),
                            64, n)[:4]
    before = cuda_lib.LAUNCHES[f"fetch_{layout}"]
    if layout == "f32":
        vals = rng.uniform(0.01, 3.0, n).astype(np.float32).view(np.int32)
        args = (_t(rows, cuda), _t(vals, cuda), *table, 64, SENTINEL)
        got, want = fetch.fetch_jobs(*args), fetch.fetch_jobs_plain(*args)
    else:
        codes = rng.integers(0, 256, n).astype(np.uint32)
        packed = ((rows.astype(np.uint32) << np.uint32(8)) | codes
                  ).view(np.int32)
        args = (_t(packed, cuda), *table, 64, SENTINEL)
        got, want = fetch.fetch_jobs_q8(*args), fetch.fetch_jobs_q8_plain(*args)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[f"fetch_{layout}"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0] >= 1 << 23).sum()) > 0


def _sorted_runs(rng, nq, P, max_run, sentinel):
    keys = []
    for _ in range(nq):
        runs = rng.integers(1, max_run + 1, P)
        arr = np.repeat(np.arange(P, dtype=np.int32), runs)[:P]
        arr[P - int(rng.integers(0, P // 3)):] = sentinel
        keys.append(arr)
    return np.stack(keys)


@pytest.mark.parametrize("max_run", [1, 64, 128])
def test_segsum_kernel_matches_plain(cuda, max_run):
    rng = np.random.default_rng(max_run)
    sent = 1 << 20
    srow = _t(_sorted_runs(rng, 4, 8192, max_run, sent), cuda)
    dyadic = torch.randint(-8, 8, srow.shape, device=cuda).float() / 4
    dyadic = torch.where(srow == sent, 0.0, dyadic)
    assert torch.equal(segsum.segsum_mask(srow, dyadic, sent, max_run),
                       segsum.segsum_mask_plain(srow, dyadic, sent, max_run))
    real = torch.where(srow == sent, 0.0,
                       torch.rand(srow.shape, device=cuda) + 0.1)
    got = segsum.segsum_mask(srow, real, sent, max_run)
    want = segsum.segsum_mask_plain(srow, real, sent, max_run)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert float(((got - want)[fin].abs() / want[fin]).max()) <= 1e-6


def test_topm_kernel_matches_plain(cuda):
    rng = np.random.default_rng(9)
    s = rng.standard_normal((8, 8 * 4096)).astype(np.float32)
    s[1] = np.round(s[1])                          # many ties
    s[2, :4096] = -np.inf                          # an empty block
    s[3, 4096:8192] = -np.inf
    s[3, 4096 + np.array([5, 9, 17])] = [1.0, 3.0, 2.0]   # < m finite
    st = _t(s, cuda)
    v, i = topm.block_topm(st, 32, 4096)
    pv, pi = topm.block_topm_plain(st, 32, 4096)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert i[3, 1].tolist() == [9, 17, 5] + [0] * 29


def test_segsort_kernels_match_plain_path(cuda):
    """The engine's kernel path against the plain path and a CPU engine,
    on a small real-valued index."""
    rng = np.random.default_rng(8)
    V, N = 96, 300
    rows = np.repeat(np.arange(N), 6)
    cols = np.concatenate([rng.choice(V, 6, replace=False) for _ in range(N)])
    vals = rng.uniform(0.1, 3.0, len(rows)).astype(np.float32)
    idx = SparseIndex.from_triples(rows, cols, vals, list(range(N)), V)
    qt = np.stack([rng.choice(V, 8, replace=False) for _ in range(4)]
                  ).astype(np.int32)
    qv = rng.uniform(0.2, 2.0, (4, 8)).astype(np.float32)
    for val_dtype in ("f32", "q8"):
        gpu = ss.SegsortEngine(idx, topk=20, query_terms_budget=8,
                               val_dtype=val_dtype, device=cuda)
        cpu = ss.SegsortEngine(idx, topk=20, query_terms_budget=8,
                               val_dtype=val_dtype, device="cpu")
        s1, r1 = gpu.finalize(gpu.retrieve_tile_async(None, 20,
                                                      sparsified=(qt, qv)))
        s0, r0 = cpu.finalize(cpu.retrieve_tile_async(None, 20,
                                                      sparsified=(qt, qv)))
        for q in range(4):
            fin = np.isfinite(s0[q])
            tie_equal_topk(r0[q][fin], s0[q][fin], r1[q][fin], s1[q][fin],
                           rtol=1e-6)
