"""The torch port and chip_smoke.py import neither JAX nor the JAX package
(nor ml_dtypes or transformers, which the machine with the card lacks):
an AST scan of
every file, and an import of every module in a fresh interpreter that
must leave them out of ``sys.modules``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "scaling_retriever_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "scaling_retriever_tpu", "ml_dtypes",
             "transformers", "tokenizers", "safetensors")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_imports_without_jax():
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").replace(
            ".__init__", "")
        for p in _port_files() if p.startswith(PKG))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              f"{FORBIDDEN!r}]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_dense_slice_modules_are_scanned():
    """The dense path, the server CLI and the C++ engine's binding are among
    the files the two checks above cover."""
    files = {os.path.relpath(p, PKG) for p in _port_files()
             if p.startswith(PKG)}
    for mod in ("index/dense_index.py", "index/indexer.py",
                "index/cpp_engine.py", "data/prefetch.py",
                "evaluation/eval_dense.py", "serving/server.py"):
        assert mod in files, mod
