"""The port's host C++ engine (scaling_retriever_tpu_torch/index/cpp_engine.py
over its own csrc/sparse_engine.cpp) against a numpy brute force and the
port's segsort engine, across thread counts, and its build.

Values are multiples of 1/8 and query weights multiples of 1/4, so every
score is exact in f32 in any summation order: scores are compared
bit-equal, doc ids tie-equal (the engine's partial sort has no tie order).
The engine is held against brute force, not against the JAX package's
CppSparseEngine, whose in-place ``make`` this file does not call.
"""

import os
import threading

import numpy as np
import pytest
import torch

from scaling_retriever_tpu_torch.index import cpp_engine
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

torch.set_num_threads(1)

V, N = 64, 300


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(N), 12)
    cols = np.concatenate([rng.choice(V, 12, replace=False)
                           for _ in range(N)])
    vals = rng.integers(1, 17, rows.size) / 8.0
    return SparseIndex.from_triples(rows, cols, vals.astype(np.float32),
                                    [f"d{i}" for i in range(N)], V)


def _queries(rng, nq, t=6):
    qt = np.stack([rng.choice(V, t, replace=False) for _ in range(nq)])
    qv = (rng.integers(1, 9, (nq, t)) / 4.0).astype(np.float32)
    qv[:, -1] = 0.0                               # a zero pad slot
    return qt.astype(np.int32), qv


def _brute(index, qt, qv):
    dense = np.zeros((len(qt), V), np.float32)
    np.add.at(dense, (np.repeat(np.arange(len(qt)), qt.shape[1]),
                      qt.ravel()), qv.ravel())
    d = np.zeros((N, V), np.float32)
    for t in range(V):
        r, v = index.posting(t)
        d[r, t] = v
    return dense, dense @ d.T


@pytest.mark.parametrize("n_threads", [0, 1, 3])
def test_retrieve_matches_brute_force_and_segsort(index, n_threads):
    rng = np.random.default_rng(1)
    qt, qv = _queries(rng, 9)
    dense, exact = _brute(index, qt, qv)
    eng = cpp_engine.CppSparseEngine(index, n_threads=n_threads)
    k = 20
    rows, scores = eng.retrieve(dense, k)
    seg = SegsortEngine(index, topk=k, query_terms_budget=8, device="cpu")
    s_seg, r_seg = seg.finalize(seg.retrieve_tile_async(
        None, k, sparsified=(np.pad(qt, ((0, 0), (0, 2))),
                             np.pad(qv, ((0, 0), (0, 2))))))
    for i in range(len(qt)):
        pos = exact[i] > 0
        order = np.argsort(-exact[i], kind="stable")[:min(k, int(pos.sum()))]
        n_hit = int((rows[i] >= 0).sum())
        assert n_hit == len(order) and (rows[i][n_hit:] == -1).all()
        assert scores[i][:n_hit].tobytes() == exact[i][order].tobytes()
        tie_equal_topk(rows[i][:n_hit], scores[i][:n_hit], order,
                       exact[i][order], rtol=0.0)
        fin = np.isfinite(s_seg[i]) & (s_seg[i] > 0)
        tie_equal_topk(rows[i][:n_hit], scores[i][:n_hit], r_seg[i][fin],
                       s_seg[i][fin], rtol=0.0)
        # the one-query serving form (terms with a zero pad slot) agrees
        r1, s1 = eng.retrieve_sparse(qt[i], qv[i], k)
        assert s1.tobytes() == scores[i].tobytes()
        tie_equal_topk(r1[:n_hit], s1[:n_hit], rows[i][:n_hit],
                       scores[i][:n_hit], rtol=0.0)


def test_threshold_and_duplicate_terms(index):
    rng = np.random.default_rng(2)
    qt, qv = _queries(rng, 1)
    eng = cpp_engine.CppSparseEngine(index, n_threads=2)
    # a duplicated term adds up, as in the dense form
    dup_t = np.concatenate([qt[0], qt[0][:1]])
    dup_v = np.concatenate([qv[0], qv[0][:1]])
    dense, exact = _brute(index, dup_t[None], dup_v[None])
    r, s = eng.retrieve_sparse(dup_t, dup_v, N)
    thr = float(np.median(exact[0][exact[0] > 0]))
    rt, st = eng.retrieve_sparse(dup_t, dup_v, N, threshold=thr)
    kept = int((rt >= 0).sum())
    assert kept == int((exact[0] > thr).sum()) and (st[:kept] > thr).all()
    assert s[:kept].tobytes() == st[:kept].tobytes()
    assert int((r >= 0).sum()) == int((exact[0] > 0).sum())


def test_build_is_keyed_by_hash_and_atomic(tmp_path, monkeypatch):
    """Two threads building into an empty build root at once: one library
    under the source's hash, no temporary file left, and a second call
    reuses it (no rebuild, whatever the files' times)."""
    monkeypatch.setattr(cpp_engine, "BUILD_ROOT", str(tmp_path))
    paths, errors = [], []

    def build():
        try:
            paths.append(cpp_engine.ensure_built())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(paths) == 2 and paths[0] == paths[1]
    key = cpp_engine._key(os.environ.get("CXX", "g++"))
    assert paths[0] == str(tmp_path / key / cpp_engine.LIB_NAME)
    assert os.listdir(tmp_path / key) == [cpp_engine.LIB_NAME]
    mtime = os.path.getmtime(paths[0])
    os.utime(paths[0], (0, 0))                  # older than the source
    assert cpp_engine.ensure_built() == paths[0]
    assert os.path.getmtime(paths[0]) == 0 != mtime
