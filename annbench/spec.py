"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own: the configuration at the ``file``
its entry gives, the traffic at ``annbench/traffic/<traffic>.json``. A
configuration names the system under test (``annbench/systems/<system>.py``)
and its plain reference (``annbench/references/<reference>.py``); a
per-layer metric is read by ``annbench/metrics/<name>.py``. Adding any of
them is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    chips: int = 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files read.
    Raises KeyError for an unknown cell, OSError for a missing file."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, reported)]
    return Cell(workload, config, traffic, e2e, per_layer,
                int(w.get("chips", 1)))


def _safe(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z_]", "_", name)


def load_module(kind: str, name: str):
    """``annbench/<kind>/<name>.py`` as a module (``kind`` is ``systems``,
    ``references`` or ``metrics``). The file name is the name itself, so a
    metric named ``a.b`` lives in ``metrics/a.b.py``."""
    mod_name = f"annbench.{kind}.{_safe(name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no file {path} for {kind} {name!r}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
