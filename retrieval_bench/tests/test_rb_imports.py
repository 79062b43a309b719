"""What the benchmark may import and read: no JAX and no JAX package
anywhere (top-level names compared whole, since the port's name begins
with the JAX package's), nothing of the port in the reference, and none
of the JAX package's figures or benchmark scripts."""

from __future__ import annotations

import ast
import os
import re

from retrieval_bench import run

BENCH = os.path.join(run.ROOT, "retrieval_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "scaling_retriever_tpu"}


def py_files():
    for d, _, names in os.walk(BENCH):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def module_of(path: str) -> str:
    rel = os.path.relpath(path, run.ROOT)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    pkg = module_of(path).rsplit(".", 1)[0]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.rsplit(".", node.level - 1)[0] if node.level > 1 \
                    else pkg
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def test_no_file_imports_jax_or_the_jax_package():
    walked = {module_of(p) for p in py_files()}
    assert "retrieval_bench.archs.bidir_decoder" in walked
    found = {(os.path.relpath(p, run.ROOT), m) for p in py_files()
             for m in imports(p) if m.split(".")[0] in FORBIDDEN}
    assert not found, found


def test_the_reference_imports_nothing_of_the_port():
    files = {module_of(p): p for p in py_files()}
    todo = [m for m in files if m.startswith("retrieval_bench.reference")]
    seen = set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        for m in imports(files[mod]):
            assert m.split(".")[0] != "scaling_retriever_tpu_torch", (mod, m)
            if m in files:
                todo.append(m)
    assert "retrieval_bench.gen" in seen


def string_literals(path: str) -> list:
    """The file's string constants, docstrings left out."""
    tree = ast.parse(open(path).read(), path)
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant):
            docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_nothing_reads_the_jax_packages_figures():
    pat = re.compile(r"BENCH_\w*\.json|E2E_\w*\.json|MULTICHIP_\w*\.json|"
                     r"BASELINE\.json|^bench\w*\.py$|PERFORMANCE\.md")
    hits = [(p, s) for p in py_files() for s in string_literals(p)
            if pat.search(s)]
    assert not hits, hits


def test_forbidden_modules_compared_by_whole_top_level_name():
    port = ["scaling_retriever_tpu_torch", "scaling_retriever_tpu_torch.ops",
            "jaxtyping", "flaxen.x"]
    assert run.forbidden_loaded(port) == []
    assert run.forbidden_loaded(port + ["scaling_retriever_tpu.models"]) \
        == ["scaling_retriever_tpu"]
    assert run.forbidden_loaded(["jaxlib.xla_client", "flax"]) == \
        ["flax", "jaxlib"]
