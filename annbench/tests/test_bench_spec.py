"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has the file the harness looks for."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for w in cmd[1:]:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in paths)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert (ROOT / "annbench/systems" / f"{body['system']}.py").exists()
        assert (ROOT / "annbench/references"
                / f"{body['reference']}.py").exists()


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "annbench/traffic" / f"{w['traffic']}.json").exists()
        four += w["chips"] == 4
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    names = set()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert (ROOT / "annbench/metrics" / f"{m['name']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for cell in cells:
        e2e = {m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", cells)]
        assert layer and all(m["moves"] in e2e for m in layer)
