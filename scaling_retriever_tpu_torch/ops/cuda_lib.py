"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together, then one link) into a shared
library with a plain C interface, cached under ``build/kernels/<hash>/`` at
the repository root (keyed by the sources and flags), and loaded with
``ctypes``. ``$SRT_BUILD_DIR`` moves the build (``utils.build_dir``), as
an installed package in a directory it cannot write needs. Nothing here
runs at import time: the CPU tests import every
module on a host with no ``nvcc``.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0. ``LAUNCHES``
counts the launches of each kernel, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from scaling_retriever_tpu_torch.utils.utils import build_dir

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = ("fetch.cu", "segsum.cu", "topm.cu", "moe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                          "kernels")
LIB_NAME = "libsrt_kernels.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
# C entry -> argtypes (pointers and the stream are c_void_p)
SIGNATURES = {
    "srt_fetch_f32": [_P] * 8 + [_I64, _I32, _I32, _P],
    "srt_fetch_q8": [_P] * 7 + [_I64, _I32, _I32, _P],
    "srt_fetch_bf16": [_P] * 8 + [_I64, _I32, _I32, _P],
    "srt_segsum": [_P] * 3 + [_I64, _I64, _I32, _P],
    "srt_topm": [_P] * 3 + [_I64, _I32, _I32, _I32, _P],
    # the routed-expert layer (ops/moe.py)
    "srt_moe_route": [_P, _I32, _I32] + [_P] * 6,
    "srt_moe_expert_up": [_P] * 6 + [_I32] * 5 + [_P],
    "srt_moe_expert_down": [_P] * 7 + [_I32] * 4 + [_P],
    "srt_moe_combine": [_P] * 4 + [_I32] * 3 + [_P],
}

# fetch_f32_blockmax counts B1's second call site (ops/blockmax.py),
# topm_dense B5's dense call site (index/dense_index.py)
LAUNCHES = {"fetch_f32": 0, "fetch_f32_blockmax": 0, "fetch_q8": 0,
            "fetch_bf16": 0, "segsum": 0, "topm": 0, "topm_dense": 0,
            "moe_route": 0, "moe_expert_up": 0, "moe_expert_down": 0,
            "moe_combine": 0}

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels (if this source set is not built yet) and return
    the library's path. ``verbose`` adds ``-Xptxas -v`` and prints what the
    compiler says (registers, shared memory, spills)."""
    root = build_dir(BUILD_ROOT)
    out_dir = os.path.join(root, _key())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path) and not verbose:
        return lib_path
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root, prefix="tmp-")
    extra = ("-Xptxas", "-v") if verbose else ()
    exe = nvcc()
    procs = []
    for name in SOURCES:
        obj = os.path.join(tmp, name + ".o")
        procs.append((name, subprocess.Popen(
            [exe, *NVCC_FLAGS, *extra, "-c", os.path.join(CSRC, name),
             "-o", obj], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out, end="", flush=True)
        if p.returncode != 0:
            errors.append(f"{name}:\n{out}")
    if errors:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    objs = [os.path.join(tmp, n + ".o") for n in SOURCES]
    link = subprocess.run([exe, *NVCC_FLAGS, "-shared", "-o",
                           os.path.join(tmp, LIB_NAME), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    if os.path.exists(lib_path):   # built meanwhile by another process
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        try:
            os.replace(tmp, out_dir)
        except OSError:              # lost the race to another process
            shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.srt_error_string.argtypes = [ctypes.c_int]
            lib.srt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream and count one
    launch of ``kernel``; raises if the launch was refused."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} "
                           f"({lib.srt_error_string(rc).decode()})")
    with _lock:
        LAUNCHES[kernel] += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device) -> None:
    """Kernel-input checks: device, dtype, contiguity and 16-byte alignment
    (the kernels use vector loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
