"""Whole runs rehearsed on the CPU at a tiny size: the contract's last
line, the traced run's per-layer reading, and the refusal without a
card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from annbench import harness, run

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_a_cell_prints_the_contracts_last_line(tiny_cell, capsys):
    res = harness.run(tiny_cell("sift1m-cnns-bf16.batch8k"), 2**31 + 3,
                      0.5, False, "cpu", 0.0)
    run.report(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"qps", "p95_ms", "recall_at_k",
                                    "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] % 256 == 0
    tail = err.strip().splitlines()[-4:]
    assert [t.split()[1] for t in tail] == ["recall_at_k", "dist_gap",
                                            "unsorted", "bad_ids"]
    assert all(t.endswith(" ok") for t in tail)


def test_the_per_query_path_cell(tiny_cell):
    # 64 queries x nprobe 2 pairs is under 2 C: the per-query path
    cell = tiny_cell("sift1m-cnns-bf16.batch512", batch=64)
    res = harness.run(cell, 11, 0.3, False, "cpu", 0.0)
    assert res["correct"] is True


def test_an_inner_product_cell_at_k100(tiny_cell):
    cell = tiny_cell("dbpedia-openai3-cnns-bf16.k100", d=1024)
    res = harness.run(cell, 12, 0.3, False, "cpu", 0.0)
    assert res["correct"] is True
    assert 0.5 < res["metrics"]["recall_at_k"]["value"] <= 1.0


def test_the_traced_run_reads_the_build_and_leaves_device_metrics_out(
        tiny_cell):
    res = harness.run(tiny_cell("sift1m-cnns-bf16.batch8k"), 4, 0.0, True,
                      "cpu", 0.0)
    assert res["correct"] is True
    # no device on the CPU: every device metric finds nothing to read
    assert set(res["metrics"]) == {"build_s", "kmeans_s"}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def test_a_metric_whose_function_is_gone_is_left_out(tiny_cell, capsys,
                                                    monkeypatch):
    from annbench import spec
    mod = spec.load_module("metrics", "route_ms")
    monkeypatch.setattr(mod, "WRAP", [("hnsw_nsg_tpu_torch.models.cnns",
                                       "_no_such_function")])
    res = harness.run(tiny_cell("sift1m-cnns-bf16.batch8k"), 4, 0.0, True,
                      "cpu", 0.0)
    assert "route_ms" not in res["metrics"]
    assert "route_ms: not reported" in capsys.readouterr().err


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "annbench/run.py", "--workload",
         "sift1m-cnns-bf16.batch8k", "--seed", str(2**31 + 9), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_command_fails_without_the_program(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "annbench", tmp_path / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "annbench/run.py", "--workload",
         "sift1m-cnns-bf16.batch8k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
