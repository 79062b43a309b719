"""The torch port and chip_smoke.py import neither JAX nor the JAX package
(nor ml_dtypes, optax or orbax) anywhere, and the host libraries the
machine with the card lacks (transformers, tokenizers, safetensors, peft,
h5py, datasets, wandb) only inside the functions that need them, never at
module level: an AST scan of every file, and an import of every module in
a fresh interpreter that must leave all of them out of ``sys.modules``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "scaling_retriever_tpu_torch")
STRICT = ("jax", "jaxlib", "flax", "scaling_retriever_tpu", "ml_dtypes",
          "optax", "orbax")
OPTIONAL = ("transformers", "tokenizers", "safetensors", "peft", "h5py",
            "datasets", "wandb")
FORBIDDEN = STRICT + OPTIONAL


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(node, in_function=False):
    """(module name, imported inside a function) for every import."""
    if isinstance(node, ast.Import):
        yield from ((a.name, in_function) for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield node.module, in_function
    elif (isinstance(node, ast.Call)
          and getattr(node.func, "attr", getattr(node.func, "id", ""))
          in ("import_module", "__import__") and node.args
          and isinstance(node.args[0], ast.Constant)):
        yield node.args[0].value, in_function
    inner = in_function or isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
    for child in ast.iter_child_nodes(node):
        yield from _imports(child, inner)


def _imported(path):
    with open(path) as f:
        return list(_imports(ast.parse(f.read(), path)))


def _matches(mod, names):
    return any(mod == f or mod.startswith(f + ".") for f in names)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m, in_function in _imported(path)
           if _matches(m, STRICT) or (_matches(m, OPTIONAL)
                                      and not in_function)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_tells_module_level_from_function_imports():
    tree = ast.parse("import h5py\n"
                     "def f():\n"
                     "    from transformers import AutoTokenizer\n"
                     "class C:\n"
                     "    import peft\n")
    assert list(_imports(tree)) == [("h5py", False), ("transformers", True),
                                    ("peft", False)]


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
                "evaluation/eval_dense.py", "serving/server.py",
                "models/hf_loader.py", "models/safetensors_io.py",
                "models/lora.py", "models/qwen2.py", "models/mistral.py",
                "evaluation/eval_sparse.py", "serving/text_frontend.py"):
        assert mod in files, mod


def test_training_slice_modules_are_scanned():
    """The training path's modules are among the files the checks above
    cover."""
    files = {os.path.relpath(p, PKG) for p in _port_files()
             if p.startswith(PKG)}
    for mod in ("models/losses.py", "parallel/mesh.py",
                "training/trainer.py", "training/train_sparse.py",
                "training/train_dense.py", "training/mntp.py"):
        assert mod in files, mod


def test_hybrid_rerank_and_t5_slice_modules_are_scanned():
    """The hybrid, term-encoder, reranker and T5 modules are among the
    files the checks above cover."""
    files = {os.path.relpath(p, PKG) for p in _port_files()
             if p.startswith(PKG)}
    for mod in ("index/hybrid.py", "index/term_encoder.py",
                "evaluation/eval_reranker.py", "models/t5.py",
                "models/t5_encoder.py"):
        assert mod in files, mod


def test_sharded_slice_modules_are_scanned():
    """The sharded entry points' modules are among the files the checks
    above cover."""
    files = {os.path.relpath(p, PKG) for p in _port_files()
             if p.startswith(PKG)}
    for mod in ("parallel/partitioning.py", "parallel/mesh.py",
                "ops/segsort_scoring.py", "ops/sparse_scoring.py",
                "utils/utils.py", "data/collators.py"):
        assert mod in files, mod


def test_distributed_slice_modules_are_scanned():
    """The modules that train over several ranks are among the files the
    checks above cover."""
    files = {os.path.relpath(p, PKG) for p in _port_files()
             if p.startswith(PKG)}
    for mod in ("parallel/collectives.py", "parallel/mesh.py",
                "parallel/partitioning.py", "training/trainer.py",
                "models/llama.py", "utils/utils.py"):
        assert mod in files, mod


def test_benches_modules_are_scanned():
    """The benchmark drivers and their shared modules are among the files
    the checks above cover."""
    files = {os.path.relpath(p, PKG) for p in _port_files()
             if p.startswith(PKG)}
    for mod in ("benches/__init__.py", "benches/common.py",
                "benches/corpora.py", "benches/uniform.py",
                "benches/serving.py", "benches/zipf.py",
                "benches/serving_zipf.py", "benches/text.py",
                "benches/dense.py", "benches/serving_dense.py",
                "benches/bf16.py", "benches/bmx.py", "benches/indexing.py",
                "benches/train.py", "benches/mntp.py"):
        assert mod in files, mod
