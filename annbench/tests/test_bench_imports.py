"""Nothing the benchmark loads is JAX or the JAX package; the reference
imports nothing of the program. Top-level names are compared whole:
``hnsw_nsg_tpu_torch`` begins with ``hnsw_nsg_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "hnsw_nsg_tpu"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "references").glob("*.py"):
        assert _imports(path) <= {"__future__", "torch", "numpy", "math"}, \
            path


def test_top_level_names_compare_whole():
    from annbench.run import FORBIDDEN as names, forbidden_modules
    assert set(names) == FORBIDDEN
    sys.modules.setdefault("hnsw_nsg_tpu_torch_probe", sys)
    try:
        assert "hnsw_nsg_tpu_torch_probe" not in forbidden_modules()
    finally:
        del sys.modules["hnsw_nsg_tpu_torch_probe"]


def test_a_rehearsed_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny\n"
        "from annbench import harness\n"
        "from annbench.run import forbidden_modules\n"
        "r = harness.run(tiny('sift1m-cnns-bf16.batch8k'), 3, 0.2, False,"
        " 'cpu', 0.0)\n"
        "assert 'hnsw_nsg_tpu_torch' in sys.modules\n"
        "print('FOUND', forbidden_modules())\n"
    ) % (str(ROOT), str(HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
