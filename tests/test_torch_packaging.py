"""An installed port can build its kernels and its hot lane (the wheel
carries every ``csrc`` source, and ``$SRT_BUILD_DIR`` moves both build
roots out of a directory that cannot be written), and the engines'
constructors take the reference's parameters in the reference's order."""

import inspect
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from scaling_retriever_tpu.ops import segsort_scoring as ref_seg
from scaling_retriever_tpu_torch.index import cpp_engine
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import cuda_lib
from scaling_retriever_tpu_torch.ops import segsort_scoring as seg
from scaling_retriever_tpu_torch.utils.utils import build_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = ("fetch.cu", "segsum.cu", "topm.cu", "moe.cu", "attention.cu",
        "sparse_engine.cpp")


def test_wheel_carries_every_csrc_source(tmp_path):
    """``pip wheel`` of a copy of the tree (so the build leaves nothing in
    the checkout) holds the six sources the port compiles at first use."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(ROOT, "pyproject.toml"), src)
    for pkg in ("scaling_retriever_tpu", "scaling_retriever_tpu_torch"):
        shutil.copytree(os.path.join(ROOT, pkg), src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = tmp_path / "wheel"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "-q", "-w", str(out), str(src)],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    (wheel,) = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    for name in CSRC:
        assert f"scaling_retriever_tpu_torch/csrc/{name}" in names


def test_build_dir_override_moves_both_roots(tmp_path, monkeypatch):
    monkeypatch.delenv("SRT_BUILD_DIR", raising=False)
    assert build_dir(cuda_lib.BUILD_ROOT) == cuda_lib.BUILD_ROOT
    assert build_dir(cpp_engine.BUILD_ROOT) == cpp_engine.BUILD_ROOT
    assert cuda_lib.BUILD_ROOT.endswith(os.path.join("build", "kernels"))
    assert cpp_engine.BUILD_ROOT.endswith(os.path.join("build", "native"))
    # a tree that cannot be written builds in the user's cache
    locked = tmp_path / "site-packages"
    locked.mkdir()
    locked.chmod(0o555)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    try:
        if not os.access(locked, os.W_OK):      # root may write anyway
            assert build_dir(str(locked / "build" / "native")) == str(
                tmp_path / "cache" / "scaling_retriever_tpu_torch" / "native")
    finally:
        locked.chmod(0o755)
    monkeypatch.setenv("SRT_BUILD_DIR", str(tmp_path / "b"))
    assert build_dir(cuda_lib.BUILD_ROOT) == str(tmp_path / "b" / "kernels")
    assert build_dir(cpp_engine.BUILD_ROOT) == str(tmp_path / "b" / "native")
    # the hot lane really builds there
    lib = cpp_engine.ensure_built()
    assert lib.startswith(str(tmp_path / "b" / "native")) and os.path.exists(
        lib)


def _params(cls):
    return list(inspect.signature(cls.__init__).parameters)[1:]


@pytest.mark.parametrize("name", ["SegsortEngine", "ShardedSegsortEngine"])
def test_engine_constructors_take_the_reference_order(name):
    want = _params(getattr(ref_seg, name))
    got = _params(getattr(seg, name))
    assert got[:len(want)] == want
    extra = inspect.signature(getattr(seg, name).__init__).parameters
    if name == "SegsortEngine":
        assert all(extra[p].kind is inspect.Parameter.KEYWORD_ONLY
                   for p in ("device", "ops", "sync"))
    else:
        assert extra["devices"].default is None


def test_sync_upload_binds_and_unported_reads_raise():
    rng = np.random.default_rng(0)
    n, v = 50, 40
    rows = rng.integers(0, n, 300)
    cols = rng.integers(0, v, 300)
    idx = SparseIndex.from_triples(rows, cols,
                                   rng.random(300).astype(np.float32),
                                   [str(i) for i in range(n)], v)
    # bench_bmx.py's call binds as the reference's does
    inspect.signature(seg.SegsortEngine).bind(
        None, topk=10, query_terms_budget=8, device_csr=None,
        sync_upload=False)
    eng = seg.SegsortEngine(idx, 5, 8, 1 << 17, "gather", False,
                            device="cpu")
    eng.sync_upload()
    q = np.zeros((1, v), np.float32)
    q[0, :4] = 1.0
    want = seg.SegsortEngine(idx, topk=5, query_terms_budget=8,
                             device="cpu").retrieve_tile(q)
    got = eng.retrieve_tile(q)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    for kw in ({"packed_read": True}, {"packed_read": False},
               {"pack_pad_bytes": 1 << 20}):
        with pytest.raises(ValueError, match="packed"):
            seg.SegsortEngine(idx, device="cpu", **kw)
