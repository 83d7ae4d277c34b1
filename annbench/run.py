"""Run one cell of the benchmark of ``hnsw_nsg_tpu_torch``.

    python3 annbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the result as one JSON line, last on
standard output, and the numbers compared with their limits as the last
lines of standard error. Exits non-zero without a result where the cell
cannot be run as asked: no CUDA card or too few of them, the program
missing, or JAX loaded in this process by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# imports resolve from the checkout's root (``annbench.*``, the program),
# never from this script's own directory
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "annbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# names whose presence in sys.modules, compared whole, refuses the run
FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_nsg_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _caches() -> None:
    # every kernel cache inside the checkout, at fixed paths, so that
    # only the first run of a cell in a checkout builds
    cache = ROOT / ".annbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    _caches()
    import torch

    from annbench import harness, spec

    cell = spec.load_cell(a.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card is visible: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run(cell, a.seed, a.seconds, bool(a.trace),
                         torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    report(result)
    return 0


def report(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    from annbench.checks import holds
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} {c['op']} {c['limit']!r} "
              f"{'ok' if holds(c) else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
