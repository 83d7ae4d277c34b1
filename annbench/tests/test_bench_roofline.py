"""The copied roofline count on hand-counted shapes."""

import pytest

from annbench import roofline


def test_bytes_bound_scan():
    # 4 queries of d = 8 in bf16 (64 B), lists [2, 4] int32 (32 B),
    # outputs [2, 4, 3] f32 + int32 (192 B), one probed slab of 16 rows
    # of 8 bf16 with an f32 bias (16 * (16 + 4) = 320 B): 608 B
    t, kind = roofline.scan_bound(4, 8, 2, 4, 16, 3, live_rows=3,
                                  probed_slabs=1, q_dtype="bfloat16",
                                  s_dtype="bfloat16")
    assert kind == "bytes"
    assert t == pytest.approx(608 / 3.35e12)


def test_operations_bound_f32():
    # f32: 2 * 1000 live rows * 4096 * 1024 = 8.39e9 operations at 67e12
    # against a few MB of bytes
    t, kind = roofline.scan_bound(1000, 1024, 1, 1000, 4096, 1,
                                  live_rows=1000, probed_slabs=1,
                                  q_dtype="float32", s_dtype="float32")
    assert kind == "operations"
    assert t == pytest.approx(2 * 1000 * 4096 * 1024 / 67e12)


def test_unprobed_slabs_cost_nothing():
    a = roofline.scan_bound(8, 128, 64, 32, 2056, 10, 8, 1, "bfloat16",
                            "bfloat16")[0]
    b = roofline.scan_bound(8, 128, 64, 32, 2056, 10, 8, 2, "bfloat16",
                            "bfloat16")[0]
    assert b - a == pytest.approx(2056 * (128 * 2 + 4) / 3.35e12)


def test_int8_slab_with_bf16_query_at_bf16_peak():
    assert roofline.PEAK_OPS[("bfloat16", "int8")] == 989e12
    assert roofline.bound(0.0, 989e12)[0] == pytest.approx(1.0)
