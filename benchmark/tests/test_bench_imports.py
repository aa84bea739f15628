"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Top-level module
names are compared whole: the program's `lol_tpu_torch` begins with the
JAX package's `lol_tpu`."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

import pytest

from bench_tiny import ROOT

BENCH = ROOT / "benchmark"
JAX_NAMES = ("jax", "jaxlib", "flax", "lol_tpu")
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def _top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_sources_name_no_jax(path):
    assert not _top_level_imports(path) & set(JAX_NAMES)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_sources_name_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {*JAX_NAMES, "lol_tpu_torch"}


def _import_all(blocked, modules) -> subprocess.CompletedProcess:
    """Import every module in a fresh interpreter in which the blocked
    names cannot be imported; print the top-level names loaded."""
    code = textwrap.dedent(f"""
        import importlib, sys
        from pathlib import Path

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {list(blocked)!r}:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        from benchmark.cells import load_module
        for p in {[m.relative_to(ROOT).as_posix() for m in modules]!r}:
            if "." in Path(p).stem:  # a metric named with a dot: by its path
                load_module(Path({str(ROOT)!r}) / p)
            else:
                importlib.import_module(p[:-3].replace("/", "."))
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)


def test_every_module_imports_with_jax_blocked():
    out = _import_all(JAX_NAMES, MODULES)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not set(eval(out.stdout.strip().splitlines()[-1])) & set(JAX_NAMES)


def test_reference_imports_with_the_program_blocked():
    out = _import_all((*JAX_NAMES, "lol_tpu_torch"), REFERENCE)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {*JAX_NAMES, "lol_tpu_torch"}


def test_run_refuses_when_jax_was_loaded(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.loaded_forbidden() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "lol_tpu_torch_extra", object())
    assert run.loaded_forbidden() == []
