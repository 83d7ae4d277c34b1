"""The CNNS search's spans and pair counts (models/cnns.py,
utils/metrics.py ``span``): the five stages under a CPU profiler, nothing
entered without one, the same results either way, and the grouped path's
pair counts against counts made by hand."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu_torch.models import cnns as tc  # noqa: E402
from hnsw_nsg_tpu_torch.utils import metrics  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig  # noqa: E402

SPANS = {"cnns.search", "cnns.route", "cnns.pairs", "cnns.probe",
         "cnns.dedup"}
# (group, router) -> the spans a search opens besides cnns.search
PATHS = {
    "grouped": (True, "flat", {"cnns.route", "cnns.pairs", "cnns.dedup"}),
    "per_query": (False, "flat", {"cnns.route", "cnns.probe", "cnns.dedup"}),
    "grouped_hnsw_router": (True, "hnsw",
                            {"cnns.route", "cnns.pairs", "cnns.dedup"}),
}


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((12, 16)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 12, 3000)]
         + rng.standard_normal((3000, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 12, 64)]
         + rng.standard_normal((64, 16))).astype(np.float32)
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=16, m=3, kmeans_iters=4,
                                      replicate=True),
                        slab_dtype=torch.bfloat16, device="cpu")
    assert idx.n_clusters % 64 == 0 and idx.replicated
    return idx, torch.from_numpy(q)


def _search(idx, q, path):
    group, router, _ = PATHS[path]
    return idx.search(q, k=10, nprobe=4, group=group, router=router)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_the_spans_nest_under_a_cpu_profiler(index, path):
    idx, q = index
    _search(idx, q, path)      # the HNSW router is built at its first use
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _search(idx, q, path)
    got = {}
    for e in prof.events():
        if e.name in SPANS:
            got.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    inner = PATHS[path][2]
    assert set(got) == {"cnns.search"} | inner
    assert all(len(v) == 1 for v in got.values())
    (s0, s1), = got["cnns.search"]
    stages = sorted(got[n][0] + (n,) for n in inner)
    for a, b, _ in stages:
        assert s0 <= a <= b <= s1
    # one after the other: route, then the scan path, then the dedup
    assert [n for _, _, n in stages][0] == "cnns.route"
    assert [n for _, _, n in stages][-1] == "cnns.dedup"
    assert all(stages[i][1] <= stages[i + 1][0]
               for i in range(len(stages) - 1))


def test_without_a_profiler_no_record_function_is_entered(index,
                                                          monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    idx, q = index
    for path in PATHS:
        _search(idx, q, path)
    assert metrics.span("a") is metrics.span("b")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_results_are_the_same_with_the_profiler_on_and_off(index, path):
    idx, q = index
    d0, i0 = _search(idx, q, path)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        d1, i1 = _search(idx, q, path)
    assert torch.equal(i0, i1)
    assert torch.equal(d0.view(torch.int32), d1.view(torch.int32))


def test_pair_counts_match_hand_counts(index):
    idx, q = index
    qn, cap, budget = 40, 8, 10
    # a skewed visit: every query's first probe is cluster 0, its second
    # one of four clusters (10 queries each), the last five PAD
    visit = torch.stack([torch.zeros(qn, dtype=torch.long),
                         1 + torch.arange(qn) % 4], 1)
    visit[35:, 1] = tc.PAD_ID
    real = visit[visit >= 0].numpy()
    spilled = int(np.maximum(np.bincount(real) - cap, 0).sum())
    # cluster 0: 40 - 8; clusters 1-4: 9, 9, 9 and 8 pairs, one each of
    # the first three past the cap
    assert spilled == 32 + 3
    before = dict(tc.pair_counts)
    tc._grouped_probe_search(q[:qn], visit, idx.data_c, idx.ids_c,
                             idx.cnorms_c, 10, idx.metric, cap=cap,
                             sp_budget=budget)
    delta = {k: tc.pair_counts[k] - before.get(k, 0)
             for k in ("pairs", "spilled", "dropped")}
    assert delta == {"pairs": qn * 2, "spilled": spilled,
                     "dropped": spilled - budget}


def test_pair_counts_count_the_grouped_path_alone(index):
    idx, q = index
    before = dict(tc.pair_counts)
    idx.search(q, k=10, nprobe=4, group=False)
    assert dict(tc.pair_counts) == before
    idx.search(q, k=10, nprobe=4, group=True)
    assert tc.pair_counts["pairs"] - before.get("pairs", 0) == q.shape[0] * 4


# the build's stages: (rows, slab dtype, local index)
BUILDS = {
    "f32_flat": ("f32", torch.bfloat16, "flat"),
    "uint8_flat": ("uint8", torch.int8, "flat"),
    "uint8_nsg": ("uint8", torch.int8, "nsg"),
}


def _stage_build(kind):
    rows, sdt, local = BUILDS[kind]
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (1500, 16)).astype(np.uint8)
    stages = {}
    tc.build_cnns(x if rows == "uint8" else x.astype(np.float32),
                  CNNSConfig(n_clusters=8, m=2, kmeans_iters=2,
                             replicate=local == "flat"),
                  local_index=local, slab_dtype=sdt, device="cpu",
                  stage_seconds=stages)
    return stages


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_every_build_writes_its_upload_and_slabs_stages(kind):
    stages = _stage_build(kind)
    assert {"upload", "kmeans", "slabs"} <= set(stages)
    assert all(v >= 0 for v in stages.values())
    assert stages["upload"] <= stages["kmeans"]


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_the_build_stages_are_spans_under_a_cpu_profiler(kind):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _stage_build(kind)
    got = {}
    for e in prof.events():
        if e.name.startswith("cnns.build."):
            got.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    assert set(got) == {"cnns.build.upload", "cnns.build.slabs"}
    assert all(len(v) == 1 for v in got.values())
    (u0, u1), = got["cnns.build.upload"]
    (s0, s1), = got["cnns.build.slabs"]
    assert u0 <= u1 <= s0 <= s1
