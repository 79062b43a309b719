"""ctypes binding for the host C++ CSR scoring engine (port of
index/cpp_engine.py over the port's own ``csrc/sparse_engine.cpp``): the
server's hot lane and ``SparseRetrieval``'s engine "cpp".

The shared library is built at first use with g++ and the flags below into
``build/native/<key>/`` at the repository root (or under
``$SRT_BUILD_DIR``: ``utils.build_dir``), keyed by a hash of the source
and the flags (never by file times, which a checkout leaves in any order).
Each build writes a temporary file in that directory and renames it into
place (``os.replace``), so processes building at once never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.utils.utils import build_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sparse_engine.cpp")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")
LIB_NAME = "libsrt_sparse.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _key(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx,) + CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def ensure_built() -> str:
    """Compile the engine if this source and these flags are not built yet;
    return the library's path."""
    cxx = os.environ.get("CXX", "g++")
    out_dir = os.path.join(build_dir(BUILD_ROOT), _key(cxx))
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=".tmp-", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(ensure_built())
            lib.srt_score_topk.restype = None
            lib.srt_score_topk.argtypes = [
                ctypes.POINTER(ctypes.c_int64),   # offsets
                ctypes.POINTER(ctypes.c_int32),   # doc_rows
                ctypes.POINTER(ctypes.c_float),   # values
                ctypes.c_int64, ctypes.c_int64,   # dim, n_docs
                ctypes.POINTER(ctypes.c_int64),   # q_offsets
                ctypes.POINTER(ctypes.c_int32),   # q_terms
                ctypes.POINTER(ctypes.c_float),   # q_vals
                ctypes.c_int64,                   # nq
                ctypes.c_int32, ctypes.c_float,   # topk, threshold
                ctypes.c_int32,                   # n_threads
                ctypes.POINTER(ctypes.c_int32),   # out_rows
                ctypes.POINTER(ctypes.c_float),   # out_scores
            ]
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class CppSparseEngine:
    """Exact top-k over a host ``SparseIndex`` by term-at-a-time
    scatter-add, ``n_threads`` workers (0 = one per core)."""

    def __init__(self, index: SparseIndex, n_threads: int = 0):
        self.index = index
        self.n_threads = n_threads
        self._offsets = np.ascontiguousarray(index.offsets, np.int64)
        self._doc_rows = np.ascontiguousarray(index.doc_rows, np.int32)
        self._values = np.ascontiguousarray(index.values, np.float32)
        _load()

    def _score(self, q_offsets: np.ndarray, q_terms: np.ndarray,
               q_vals: np.ndarray, nq: int, topk: int, threshold: float):
        out_rows = np.full((nq, topk), -1, np.int32)
        out_scores = np.zeros((nq, topk), np.float32)
        _load().srt_score_topk(
            _ptr(self._offsets, ctypes.c_int64),
            _ptr(self._doc_rows, ctypes.c_int32),
            _ptr(self._values, ctypes.c_float),
            ctypes.c_int64(self.index.dim),
            ctypes.c_int64(self.index.nb_docs()),
            _ptr(q_offsets, ctypes.c_int64),
            _ptr(q_terms, ctypes.c_int32),
            _ptr(q_vals, ctypes.c_float),
            ctypes.c_int64(nq),
            ctypes.c_int32(topk),
            ctypes.c_float(threshold),
            ctypes.c_int32(self.n_threads),
            _ptr(out_rows, ctypes.c_int32),
            _ptr(out_scores, ctypes.c_float),
        )
        return out_rows, out_scores

    def retrieve_sparse(self, terms: np.ndarray, vals: np.ndarray, topk: int,
                        threshold: float = 0.0
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Score ONE query given as (terms, vals). Duplicate terms add up
        and zero-valued pad slots contribute nothing (only scores above
        ``threshold`` are kept), so padded serving-format queries are safe
        as they are. Returns (rows [topk] -1-padded, scores [topk])
        descending."""
        terms = np.ascontiguousarray(terms, np.int32)
        vals = np.ascontiguousarray(vals, np.float32)
        q_offsets = np.array([0, terms.size], np.int64)
        rows, scores = self._score(q_offsets, terms, vals, 1, topk, threshold)
        return rows[0], scores[0]

    def retrieve(self, q_dense: np.ndarray, topk: int, threshold: float = 0.0
                 ) -> tuple[np.ndarray, np.ndarray]:
        """q_dense: [nq, V] float32. Returns (rows [nq, topk] -1-padded,
        scores [nq, topk]) sorted by descending score."""
        nq = q_dense.shape[0]
        qr, qc = np.nonzero(q_dense)
        q_vals = np.ascontiguousarray(q_dense[qr, qc], np.float32)
        q_terms = np.ascontiguousarray(qc, np.int32)
        q_offsets = np.zeros(nq + 1, np.int64)
        np.cumsum(np.bincount(qr, minlength=nq), out=q_offsets[1:])
        return self._score(q_offsets, q_terms, q_vals, nq, topk, threshold)
