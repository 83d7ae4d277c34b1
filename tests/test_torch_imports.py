"""The PyTorch port imports nothing of JAX and nothing of the JAX package:
an ``ast`` scan of every module of ``hnsw_nsg_tpu_torch/`` (``parallel/``,
``cli.py``, ``entry.py`` and ``examples/`` among them) and of
``chip_smoke.py``; then every module imported in a process where
``import jax`` fails, and every example compiled."""

import ast
import pathlib
import py_compile
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hnsw_nsg_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "hnsw_nsg_tpu")


def _imported(path):
    """Top-level names of every absolute import in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if p.parent.name != "examples" and p.name != "__main__.py")
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "sys.modules['hnsw_nsg_tpu'] = None; "
            f"[importlib.import_module(m) for m in {mods!r}]")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize(
    "path", sorted((PKG / "examples").glob("example_*.py")),
    ids=lambda p: p.name)
def test_example_compiles(path, tmp_path):
    py_compile.compile(str(path), cfile=str(tmp_path / "x.pyc"),
                       doraise=True)
    assert "hnsw_nsg_tpu_torch" in set(_imported(path))
