"""The uint8 configuration (``sift10m-u8-cnns-int8``) rehearsed on the
CPU at a tiny size: the uint8 map gives the same bytes on the host as
through the reference, a run comes out correct, the traced run reads the
build's stages, and the reference-int8 control comes out not correct."""

import numpy as np
import torch

from annbench import control, datagen, harness, spec
from annbench.systems import cnns_u8

CELL = "sift10m-u8-cnns-int8.batch16k"
ref = spec.load_module("references", "exact_knn_u8")


def test_the_uint8_map_gives_equal_bytes_on_the_host_and_in_the_reference():
    x, q = datagen.mixture({"normalize": False}, 4000, 128, 256,
                           2**31 + 5, "cpu")
    # edges of the map: the clamp at both ends and ties rounded to even
    edge = torch.tensor([-10.0, -128 / 36, 127.5 / 36, 0.5 / 36, 1.5 / 36,
                         10.0])
    x = torch.cat([x, edge.repeat(128 // 6 + 1)[:128][None]])
    host = cnns_u8._ref.uint8_rows(torch.from_numpy(x.numpy()))
    assert host.dtype == torch.uint8
    assert torch.equal(host, ref.uint8_map(x))
    # the repository's own map (utils/synth.py), in numpy's f32
    xn = x.numpy()
    assert torch.equal(host, torch.from_numpy(
        np.clip(xn * np.float32(36) + np.float32(128), 0, 255).round()
        .astype(np.uint8)))


def test_a_rehearsed_run_of_the_uint8_cell_is_correct(tiny_cell):
    res = harness.run(tiny_cell(CELL), 2**31 + 21, 0.3, False, "cpu", 0.0)
    assert res["correct"] is True
    assert res["checks"]["dist_gap"]["value"] == 0.0
    assert set(res["metrics"]) == {"qps", "recall_at_k", "setup_s"}


def test_the_traced_run_reads_the_build_stages(tiny_cell):
    res = harness.run(tiny_cell(CELL), 22, 0.0, True, "cpu", 0.0)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"build_s", "kmeans_s", "upload_s",
                                   "slabs_s"}
    m = res["metrics"]
    assert m["upload_s"]["value"] <= m["kmeans_s"]["value"]
    assert m["kmeans_s"]["value"] + m["slabs_s"]["value"] <= (
        m["build_s"]["value"])


def test_the_reference_int8_control_is_not_correct(tiny_cell):
    cell = tiny_cell(CELL)
    res = harness.run(cell, 31, 0.3, False, "cpu", 0.0,
                      system=control.control_system("reference-int8",
                                                    cell.config))
    gap = res["checks"]["dist_gap"]
    assert res["correct"] is False
    assert gap["value"] > gap["limit"]
    assert res["checks"]["recall_at_k"]["value"] >= (
        res["checks"]["recall_at_k"]["limit"])
