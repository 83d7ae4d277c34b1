"""The readers of the program's own spans and counts (``stalls.py`` and
the metrics that use it), on a hand-made Chrome trace, and a traced
rehearsal on the CPU."""

from collections import Counter

import pytest

from annbench import harness, spec, stalls, tracing

PROGRAM_METRICS = ("route_stall_ms", "pairs_stall_ms", "probe_stall_ms",
                   "outside_stall_ms", "search_launches", "dedup_ms",
                   "spill_pairs", "dropped_pairs")


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 0.2, tid=tid,
              corr=corr)


def _kernel(ts, dur, corr, name="scan_mma_kernel<float>"):
    return _x("kernel", name, ts, dur, tid=7, corr=corr)


# two requests: the first's last launch (in cnns.dedup) runs after its
# search has returned; the benchmark's own span around the router and a
# launch of another thread are not the program's
EVENTS = [
    _x("user_annotation", tracing.WINDOW, 0, 100),
    _x("user_annotation", "cnns.search", 10, 50),
    _x("user_annotation", "cnns.route", 12, 18),
    _x("user_annotation",
       "hnsw_nsg_tpu_torch.models.cnns._route_clusters", 12, 17),
    _x("user_annotation", "cnns.pairs", 32, 23),
    _x("user_annotation", "cnns.dedup", 56, 3),
    _x("user_annotation", "cnns.search", 70, 25),
    _x("user_annotation", "cnns.route", 71, 9),
    _x("user_annotation", "cnns.pairs", 82, 12),
    _launch(13, 1), _launch(33, 2), _launch(34, 3), _launch(58.5, 4),
    _launch(83, 5), _launch(96, 6), _launch(40, 8, tid=2),
    _kernel(15, 10, 1),
    _kernel(35, 5, 2),
    _x("gpu_memset", "Memset (Device)", 40, 1, tid=7, corr=2),
    _kernel(38, 12, 3),
    _kernel(61, 1, 4, name="elementwise_kernel<int>"),
    _kernel(85, 5, 5),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 97, 2, tid=7,
       corr=6),
    _kernel(41, 1, 8),
]
# idle: 0-15, 25-35, 50-61, 62-85, 90-97, 99-100 (67 us), charged by
# hand to the innermost program span open in each part
CHARGED_US = {"outside": 10 + 1 + 8 + 2 + 1, "cnns.search": 10,
              "cnns.route": 3 + 5 + 9, "cnns.pairs": 3 + 5 + 3 + 4,
              "cnns.dedup": 3}


def _reading():
    return tracing.Reading(EVENTS, requests=2, setup={})


def test_the_split_divides_the_windows_idle_time_exactly():
    r = _reading()
    idle_s = r.window_s - r.busy_s
    assert idle_s == pytest.approx(67e-6)
    got = stalls.charges(r)
    assert sum(got.values()) == pytest.approx(idle_s)
    assert got == pytest.approx({k: v * 1e-6 for k, v in
                                 CHARGED_US.items()})


def test_an_idle_interval_across_spans_is_split_by_time():
    r = _reading()
    # 25-35: 5 in the route, 2 in the search between route and pairs, 3
    # in the pairs
    assert stalls.idle(r)[1] == (25, 35)
    pieces = [(max(a, 25), min(b, 35), n) for a, b, n in stalls._pieces(r)
              if a < 35 and b > 25]
    assert pieces == [(25, 30, "cnns.route"), (30, 32, "cnns.search"),
                      (32, 35, "cnns.pairs")]


def test_the_stall_metrics_read_ms_a_request():
    r = _reading()
    for name, span in (("route_stall_ms", "cnns.route"),
                       ("pairs_stall_ms", "cnns.pairs"),
                       ("outside_stall_ms", "outside")):
        value, note = spec.load_module("metrics", name).read(r, [])
        assert value == pytest.approx(1e-3 * CHARGED_US[span] / 2)
        assert note.startswith("idle ms a request: cnns.search 0.0050")
    # no per-query path in this trace
    assert spec.load_module("metrics", "probe_stall_ms").read(r, []) is None


def test_launches_are_counted_under_a_span_by_correlation():
    r = _reading()
    # the Reading's launch lists, which stalls.py reads
    assert r._launch_ts == [13, 33, 34, 58.5, 83, 96]
    assert r._launch_corr == [1, 2, 3, 4, 5, 6]
    assert [n for _, n in r._by_corr[2]] == ["scan_mma_kernel", "Memset"]
    # corr 2 launched two operations; corr 4 ran after its search ended;
    # corr 8 came from another thread
    assert stalls.launches(r, "cnns.search") == [5, 1]
    assert stalls.launches(r, "cnns.pairs") == [3, 1]
    assert stalls.launches(r, "cnns.dedup") == [1]
    value, note = spec.load_module("metrics", "search_launches").read(r, [])
    assert value == 3.0
    assert note == ("a request: cnns.route 0.5, cnns.pairs 2.0, "
                    "cnns.probe 0.0, cnns.dedup 0.5")
    dedup = spec.load_module("metrics", "dedup_ms").read(r, [])
    assert dedup == pytest.approx(1e3 * 1e-6 / 2)


def test_the_counter_metrics_come_from_record_snapshots(monkeypatch):
    from hnsw_nsg_tpu_torch.models import cnns
    monkeypatch.setattr(cnns, "pair_counts",
                        Counter(pairs=100, spilled=10, dropped=2))
    spill = spec.load_module("metrics", "spill_pairs")
    dropped = spec.load_module("metrics", "dropped_pairs")
    first = spill.record((), {})
    assert first == {"pairs": 100, "spilled": 10, "dropped": 2}
    cnns.pair_counts.update(pairs=200, spilled=30, dropped=6)
    assert first["spilled"] == 10                  # a copy
    records = [first, spill.record((), {})]
    r = _reading()
    value, note = spill.read(r, records)
    assert value == 15.0 and note == "of 100 pairs a request (15.0000%)"
    assert dropped.read(r, records) == 3.0
    # the grouped path did not run, or the program keeps no counts
    assert spill.read(r, []) is None
    assert dropped.read(r, [None]) is None
    monkeypatch.delattr(cnns, "pair_counts")
    assert spill.record((), {}) is None


def test_a_program_without_spans_gives_nothing_to_read():
    events = [e for e in EVENTS if not e["name"].startswith("cnns.")]
    r = tracing.Reading(events, requests=2, setup={})
    for name in PROGRAM_METRICS[:6]:
        assert spec.load_module("metrics", name).read(r, []) is None


def test_the_traced_rehearsal_records_spans_and_counts_on_the_cpu(
        tiny_cell, monkeypatch):
    seen = {}

    class Keep(tracing.Reading):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["reading"] = self

    class KeepWrap(tracing.Wrapping):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["wrap"] = self

    monkeypatch.setattr(tracing, "Reading", Keep)
    monkeypatch.setattr(tracing, "Wrapping", KeepWrap)
    cell = tiny_cell("sift1m-cnns-bf16.batch8k")
    res = harness.run(cell, 2**31 + 17, 0.0, True, "cpu", 0.0)
    assert res["correct"] is True
    # nothing ran on a card: every metric of the program's spans and
    # counts is left out, as the device metrics are
    assert set(res["metrics"]) == {"build_s", "kmeans_s"}
    r, wrap = seen["reading"], seen["wrap"]
    n = cell.traffic["trace_requests"]
    assert len(r.spans("cnns.search")) == n
    assert len(r.spans("cnns.route")) == len(r.spans("cnns.pairs")) == n
    assert len(r.spans("cnns.dedup")) == n and not r.spans("cnns.probe")
    ch = stalls.charges(r)
    assert sum(ch.values()) == pytest.approx(r.window_s)
    assert ch["outside"] > 0 and ch["cnns.pairs"] > 0
    # the records a card run would read: every pair of the window counted
    from hnsw_nsg_tpu_torch.models import cnns
    first = wrap.records["spill_pairs"][0]
    pairs = cnns.pair_counts["pairs"] - first["pairs"]
    assert pairs == n * cell.traffic["batch"] * cell.config["nprobe"]
    assert len(wrap.records["dropped_pairs"]) == n
