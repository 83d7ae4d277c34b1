"""The control of the benchmark's comparison, run on the card at a cell's
own size: the numbers that ``checks.py`` compares, read from a system
that works one precision below the configuration's bf16 slabs.

    python3 annbench/control.py --workload NAME --seeds 1 2 3 \\
        [--mode program-int8|reference-int8] [--seconds 3]

``program-int8`` is the program with its own int8 path switched on
(``build_cnns(slab_dtype=torch.int8)``: SQ8 slabs, bf16 queries; the
program takes it for l2 only). ``reference-int8`` puts the plain
reference in the program's place: exact search over the rows as int8
stores them, with bf16 queries. Each seed is one window of the cell's
traffic, judged as a benchmark run is; a control has to fail. The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "annbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class ProgramInt8:
    """The configuration's system with int8 slabs."""

    def __init__(self, system):
        self._system = system
        self.search = system.search
        self.counters = system.counters

    def build(self, x_host, config, device):
        return self._system.build(x_host, config, device, slab_dtype="int8")


class ReferenceInt8:
    """The reference in the program's place, over int8 rows."""

    def __init__(self, reference):
        self._ref = reference

    def build(self, x_host, config, device):
        import torch
        t0 = time.perf_counter()
        rows = self._ref.quantize_int8(torch.from_numpy(x_host).to(device))
        return rows, {"build_s": time.perf_counter() - t0}

    def search(self, rows, queries, k, config):
        return self._ref.search(rows, queries, k, config["metric"])

    def counters(self):
        return {}


def control_system(mode: str, config: dict):
    from annbench import spec
    if mode == "program-int8":
        return ProgramInt8(spec.load_module("systems", config["system"]))
    if mode == "reference-int8":
        return ReferenceInt8(spec.load_module("references",
                                              config["reference"]))
    raise ValueError(f"unknown control mode {mode!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", default="reference-int8",
                   choices=("program-int8", "reference-int8"))
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import torch

    from annbench import harness, spec

    cell = spec.load_cell(a.workload, ROOT)
    system = control_system(a.mode, cell.config)
    for seed in a.seeds:
        t0 = time.perf_counter()
        res = harness.run(cell, seed, a.seconds, False, torch.device(a.device),
                          t0, system=system)
        print(json.dumps({"workload": a.workload, "mode": a.mode,
                          "seed": seed, "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
