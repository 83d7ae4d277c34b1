"""Tiny cells for rehearsing the benchmark on the CPU: the published
widths (d = 128) over a small set, so that a whole run takes seconds."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(workload: str, n: int = 20000, pool: int = 1024,
         batch: int = 256, d: int | None = None):
    from annbench import spec
    cell = spec.load_cell(workload, ROOT)
    cfg = copy.deepcopy(cell.config)
    cfg.update(n=n, pool=pool)
    if d is not None:
        cfg["d"] = d
    cfg["index"]["n_clusters"] = max(1, n // 1000)
    cfg["nprobe"] = 4
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=batch, warmup_requests=1,
                        trace_requests=3)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
