"""CNNS flat path of the PyTorch port vs the JAX package.

Indexes built by the JAX package are cross-loaded into the port (its
.npz format), which takes the two k-means RNGs out of every search
comparison; then both packages search the same numpy queries.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import cnns as jc  # noqa: E402
from hnsw_nsg_tpu.utils.params import CNNSConfig  # noqa: E402
from hnsw_nsg_tpu_torch.models import cnns as tc  # noqa: E402
from hnsw_nsg_tpu_torch.ops import PAD_DIST, brute_force_topk, recall  # noqa: E402
from hnsw_nsg_tpu_torch.ops import cluster_scan, route  # noqa: E402
from hnsw_nsg_tpu_torch.ops import pairwise_dists, squared_norms  # noqa: E402
from hnsw_nsg_tpu_torch.ops.topk import topk_smallest  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)   # f32 sums in another order
# bf16 slabs and SQ8 (bf16 query x int8 slab): the same f32 products of
# the same rounded values, summed in another order, so a near-tie may
# swap: at least this share of ids must agree, and distances agree where
# the ids do
ID_OVERLAP_BF16 = 0.99
CFG = dict(n_clusters=16, m=3, kmeans_iters=6)

# name -> (metric, slab dtype, replicate, data transform)
VARIANTS = {
    "f32_l2": ("l2", "f32", False, None),
    "f32_l2_rep": ("l2", "f32", True, None),
    "f32_ip": ("ip", "f32", False, None),
    "f32_ip_rep": ("ip", "f32", True, None),
    "bf16_l2_rep": ("l2", "bf16", True, None),
    "u8": ("l2", "int8", False, "uint8"),
    "sq8": ("l2", "int8", False, "scale100"),
}
_JDT = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}


def _data(metric, transform, n=4000, nq=96, d=16, seed=31):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((20, d)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 20, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, 20, nq)]
         + rng.standard_normal((nq, d))).astype(np.float32)
    if metric == "ip":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    if transform == "uint8":
        x = np.clip(x * 12 + 128, 0, 255).round().astype(np.float32)
        q = np.clip(q * 12 + 128, 0, 255).round().astype(np.float32)
    elif transform == "scale100":       # SQ8 with qscale >= 2
        x, q = x * 100, q * 100
    return x, q


@pytest.fixture(scope="module")
def jax_indexes(tmp_path_factory):
    """Each variant built by the JAX package, saved, and loaded by both
    packages. Searches compare the two loaded copies: the .npz holds no
    slab norms, so a loaded bf16 index takes its norms from the rounded
    slabs, where a freshly built one keeps those of the f32 rows."""
    out = {}
    tmp = tmp_path_factory.mktemp("cnns")
    for name, (metric, sdt, rep, tf) in VARIANTS.items():
        x, q = _data(metric, tf)
        ji = jc.build_cnns(x, CNNSConfig(replicate=rep, **CFG),
                           metric=metric, slab_dtype=_JDT[sdt])
        path = str(tmp / f"{name}.npz")
        ji.save(path)
        out[name] = (x, q, ji, jc.CNNSIndex.load(path),
                     tc.CNNSIndex.load(path, device="cpu"))
    return out


def _check_search(name, jd, ji, td, ti):
    jd, ji, td, ti = (np.asarray(a) for a in (jd, ji, td, ti))
    if name.startswith("f32") or name == "u8":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, **TOL)
    else:
        assert (ti == ji).mean() >= ID_OVERLAP_BF16, (ti == ji).mean()
        same = ti == ji
        np.testing.assert_allclose(td[same], jd[same], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_cross_loaded_search_matches_jax(jax_indexes, name, group):
    x, q, _, ji, ti = jax_indexes[name]
    assert ti.qscale == ji.qscale and ti.replicated == ji.replicated
    if name == "sq8":
        assert ti.qscale >= 2.0
    for nprobe in (2, 4):
        jd, jid = ji.search(q, k=10, nprobe=nprobe, group=group)
        td, tid = ti.search(torch.from_numpy(q), k=10, nprobe=nprobe,
                            group=group)
        _check_search(name, jd, jid, td, tid)


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("name", ["f32_l2", "f32_l2_rep", "bf16_l2_rep"])
def test_cross_loaded_search_at_the_default_k(jax_indexes, name, group):
    """search() at its own default k = 100, past the scan's fast kernels'
    k = 32 (a replicated index scans 2k = 200): the port returns [Q, 100]
    and agrees with the JAX package. A hundred ranks deep, f32 sums in
    another order swap a few near-ties even with f32 slabs: ids equal at
    >= 99.9% of the slots in f32 (99% in bf16), distances within TOL
    where they agree, and the first 10 ranks as at k = 10."""
    _, q, _, ji, ti = jax_indexes[name]
    jd, jid = (np.asarray(a) for a in ji.search(q, nprobe=4, group=group))
    td, tid = (t.numpy() for t in ti.search(torch.from_numpy(q), nprobe=4,
                                            group=group))
    assert tid.shape == (len(q), 100)
    same = tid == jid
    assert same.mean() >= (0.999 if name.startswith("f32") else
                           ID_OVERLAP_BF16), same.mean()
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-4, atol=1e-3)
    _check_search(name, jd[:, :10], jid[:, :10], td[:, :10], tid[:, :10])


@pytest.mark.parametrize("name", ["f32_l2", "f32_ip_rep", "bf16_l2_rep",
                                  "u8", "sq8"])
def test_grouped_scan_matches_jax_pallas(jax_indexes, name):
    """The port's grouped scan vs JAX _grouped_probe_search with the
    Pallas kernel (interpret mode), on the same probe lists."""
    x, q, _, ji, ti = jax_indexes[name]
    qs = (q - np.asarray(ji.qshift, np.float32)) / np.float32(ji.qscale)
    visit = np.array(ji._route(jnp.asarray(qs), 4))   # writable copy
    kk = 20 if ji.replicated else None
    cn = (ji.cnorms_c if ji.cnorms_c is not None
          else jnp.zeros(ji.ids_c.shape, jnp.float32))
    jd, jid = jc._grouped_probe_search(
        jnp.asarray(qs), jnp.asarray(visit), ji.data_c, ji.ids_c, cn, 10,
        ji.metric, cap=16, block=64, approx=False, pallas=True,
        q_round=ji.qscale == 1.0, k_out=kk)
    tcn = (ti.cnorms_c if ti.cnorms_c is not None
           else torch.zeros(ti.ids_c.shape))
    td, tid = tc._grouped_probe_search(
        torch.from_numpy(qs), torch.from_numpy(visit).long(), ti.data_c,
        ti.ids_c, tcn, 10, ti.metric, cap=16, q_round=ti.qscale == 1.0,
        k_out=kk)
    _check_search(name, jd, jid, td, tid)


@pytest.mark.parametrize("group", [False, True])
def test_sq8_pad_slots_stay_pad_dist(tmp_path, group):
    """F-R2: at qscale >= 2 unfilled result slots must come back as
    PAD_DIST (not overflow to inf under the qscale^2 rescale)."""
    x, q = _data("l2", "scale100", n=300, nq=8)
    ji = jc.build_cnns(x, CNNSConfig(n_clusters=16, m=2, kmeans_iters=4),
                       slab_dtype=jnp.int8)
    ji.save(str(tmp_path / "s.npz"))
    ti = tc.CNNSIndex.load(str(tmp_path / "s.npz"), device="cpu")
    assert ti.qscale >= 2.0
    k = 32 if group else 48          # above one cluster's fill
    td, tid = ti.search(torch.from_numpy(q), k=k, nprobe=1, group=group)
    jd, jid = ji.search(q, k=k, nprobe=1, group=group)
    pad = tid < 0
    assert pad.any()
    assert bool((td[pad] == float(PAD_DIST)).all())
    assert bool(torch.isfinite(td).all())
    np.testing.assert_array_equal(tid.numpy() < 0, np.asarray(jid) < 0)


@pytest.mark.parametrize("name", ["f32_l2", "f32_l2_rep", "bf16_l2_rep"])
def test_port_build_matches_jax_build(jax_indexes, name):
    """Same slab layout rules, each point present, same recall (+-0.01)."""
    metric, sdt, rep, tf = VARIANTS[name]
    x, q, ji, _, _ = jax_indexes[name]
    ti = tc.build_cnns(x, CNNSConfig(replicate=rep, **CFG), metric=metric,
                       slab_dtype=_TDT[sdt], device="cpu")
    assert ti.data_c.shape[0] == ji.data_c.shape[0]
    assert ti.maxc == ji.maxc and ti.n_real > 0
    ids = ti.ids_c.numpy()
    members = np.concatenate([row[:s] for row, s in zip(ids, ti.sizes)])
    np.testing.assert_array_equal(np.sort(members), np.arange(len(x)))
    counts = np.bincount(ids[ids >= 0], minlength=len(x))
    assert counts.max() == (2 if rep else 1)
    _, gt = brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10,
                             metric)
    for nprobe in (2, 4):
        _, tid = ti.search(torch.from_numpy(q), k=10, nprobe=nprobe)
        _, jid = ji.search(q, k=10, nprobe=nprobe)
        assert abs(recall(tid, gt) - recall(np.asarray(jid), gt)) <= 0.01


def test_multipass_q3000_matches_per_query():
    """F-R1: Q=3000 beyond the 512 capacity ceiling — the JAX package's
    multi-pass fails to reshape its spill budget here; the port clamps it
    and the multi-pass result equals the per-query scan's."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((3000, 16)).astype(np.float32))
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=8, m=2, kmeans_iters=6),
                        device="cpu")
    c = idx.data_c.shape[0]
    nprobe = min(8, idx.n_real)
    assert 2 * q.shape[0] * nprobe > 512 * c
    _, gt = brute_force_topk(q, torch.from_numpy(x), 10)
    d1, i1 = idx.search(q, k=10, nprobe=nprobe, group=False)
    d2, i2 = idx.search(q, k=10, nprobe=nprobe, group=True)
    assert recall(i2, gt) == recall(i1, gt)
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), **TOL)


@pytest.mark.parametrize("sdt", ["f32", "bf16"])
def test_save_load_round_trips(tmp_path, sdt):
    """port -> npz -> JAX and port -> npz -> port: same slabs, same
    search results."""
    x, q = _data("l2", None)
    ti = tc.build_cnns(x, CNNSConfig(replicate=True, **CFG),
                       slab_dtype=_TDT[sdt], device="cpu")
    p = str(tmp_path / "t.npz")
    ti.save(p)
    ji = jc.CNNSIndex.load(p)
    t2 = tc.CNNSIndex.load(p, device="cpu")
    np.testing.assert_array_equal(np.asarray(ji.data_c, np.float32),
                                  ti.data_c.float().numpy())
    assert torch.equal(t2.data_c, ti.data_c) and t2.replicated
    t2d, t2id = t2.search(torch.from_numpy(q), k=10, nprobe=3)
    if sdt == "f32":
        # (a loaded bf16 index takes its norms from the rounded slabs, see
        # jax_indexes, so only f32 searches equal the built index's)
        td, tid = ti.search(torch.from_numpy(q), k=10, nprobe=3)
        assert torch.equal(tid, t2id) and torch.equal(td, t2d)
    jd, jid = ji.search(q, k=10, nprobe=3)
    _check_search(sdt + "_rt", jd, jid, t2d, t2id)


def test_unported_local_indexes_raise(jax_indexes, monkeypatch):
    """The local indexes build_cnns cannot build raise ValueError before
    k-means runs: boundary replication with graph locals (as in the JAX
    package) and an unknown local index."""
    x, _, _, _, _ = jax_indexes["f32_l2"]

    def no_kmeans(*args, **kwargs):
        raise AssertionError("k-means ran before the check")

    monkeypatch.setattr(tc, "kmeans", no_kmeans)
    with pytest.raises(ValueError, match="replication"):
        tc.build_cnns(x, CNNSConfig(replicate=True, **CFG),
                      local_index="nsg", device="cpu")
    with pytest.raises(ValueError, match="unknown local_index"):
        tc.build_cnns(x, CNNSConfig(**CFG), local_index="ivf", device="cpu")


def test_search_on_cpu_launches_no_kernel(jax_indexes):
    """A CPU search takes the plain versions: no scan and no route kernel
    launches, and the router counts a plain route of its queries."""
    _, q, _, _, ti = jax_indexes["bf16_l2_rep"]
    before = cluster_scan.launches
    counts = dict(tc.route_counts)
    ti.search(torch.from_numpy(q), k=10, nprobe=4, group=True)
    assert cluster_scan.launches == before == 0
    assert route.launches == 0 and not route.launches_by_kernel
    assert tc.route_counts["plain"] == counts.get("plain", 0) + 1
    assert tc.route_counts["queries"] == counts.get("queries", 0) + len(q)


def _plain_route(q, reps, nprobe, metric, rank_by="hits", route_m=None,
                 n_valid=None):
    """The router's plain path as it stood before the route kernel: the
    product over the bf16-rounded reps (pairwise_dists), the padded
    clusters masked by index, a stable sort of every column."""
    if route_m is not None:
        reps = reps[:, :route_m]
    c, m1, d = reps.shape
    rd = pairwise_dists(q.to(torch.bfloat16),
                        reps.reshape(c * m1, d).to(torch.bfloat16), metric,
                        exact=False)
    if n_valid is not None and n_valid < c:
        col_cid = torch.arange(c * m1) // m1
        rd = torch.where(col_cid[None, :] >= n_valid, PAD_DIST, rd)
    ids = torch.arange(c * m1).expand(rd.shape[0], -1)
    _, rep_idx = topk_smallest(rd, ids, min(nprobe * m1, c * m1))
    return tc._rank_rep_hits(rep_idx, m1, nprobe, rank_by)


@pytest.mark.parametrize("name", ["f32_l2_rep", "f32_ip", "bf16_l2_rep",
                                  "u8"])
@pytest.mark.parametrize("nprobe,route_m,n_valid,rank_by", [
    (4, None, None, "hits"), (3, 2, None, "hits"), (5, None, 10, "hits"),
    (4, None, 12, "min_dist"), (20, None, 3, "hits")])
def test_cpu_route_is_the_plain_path(jax_indexes, name, nprobe, route_m,
                                     n_valid, rank_by):
    """On the CPU _route_clusters gives the visits of the plain path the
    router had before its kernel, on the index's own reps and queries: the
    route_m ablation, padded clusters (n_valid, with nprobe past the real
    ones so the padding columns come back) and rank_by="min_dist"."""
    _, q, _, _, ti = jax_indexes[name]
    qt = torch.from_numpy(q)
    got = tc._route_clusters(qt, ti.reps, nprobe, ti.metric, rank_by,
                             route_m, n_valid)
    want = _plain_route(qt, ti.reps, nprobe, ti.metric, rank_by, route_m,
                        n_valid)
    assert got.dtype == torch.int64
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("n_rep,n_valid", [(1, None), (15, None), (33, 9),
                                           (60, 3)])
def test_route_kernel_plain_version_is_the_plain_route(metric, n_rep,
                                                       n_valid):
    """route_topk on CPU tensors (the plain version the card is held to)
    on _route_operands' operands gives the plain path's rep columns, ties
    and padding columns included."""
    rng = np.random.default_rng(n_rep)
    q = torch.from_numpy(rng.integers(-4, 5, (40, 24)).astype(np.float32))
    reps = torch.from_numpy(rng.standard_normal((12, 5, 24)).astype(
        np.float32))
    reps[3, 1] = reps[0, 2]                 # a tie: the lower column first
    c, m1, d = reps.shape
    flat, bias, scale = tc._route_operands(reps, metric, None)
    n_real = c * m1 if n_valid is None else n_valid * m1
    got = route.route_topk(q.to(torch.bfloat16), flat, bias, n_rep, n_real,
                           scale)
    rd = pairwise_dists(q.to(torch.bfloat16), flat, metric, exact=False)
    if n_valid is not None:
        rd = torch.where(torch.arange(c * m1)[None, :] >= n_real, PAD_DIST,
                         rd)
    _, want = topk_smallest(rd, torch.arange(c * m1).expand(40, -1), n_rep)
    assert torch.equal(got, want)


def test_route_operands_made_once_per_reps_and_route_m():
    """The kernel's operands come from the plain path's expressions (the
    bf16-rounded reps and their f32 squared norms for l2, ones for ip),
    are kept by route_m and metric while the reps tensor lives, are made
    anew for other reps, and go with their reps tensor."""
    import gc
    import weakref

    reps = torch.randn(6, 3, 8, generator=torch.Generator().manual_seed(1))
    flat, bias, scale = tc._route_operands(reps, "l2", None)
    assert flat.dtype == torch.bfloat16 and flat.shape == (18, 8)
    assert torch.equal(bias, squared_norms(reps.reshape(18, 8).to(
        torch.bfloat16))) and scale == 2.0
    again = tc._route_operands(reps, "l2", None)
    assert again[0] is flat and again[1] is bias
    flat2, bias2, _ = tc._route_operands(reps, "l2", 2)
    assert flat2.shape == (12, 8)
    flat_ip, bias_ip, scale_ip = tc._route_operands(reps, "ip", None)
    assert torch.equal(bias_ip, torch.ones(18)) and scale_ip == 1.0
    assert sorted(tc._operands[reps], key=str) == [
        (2, "l2"), (None, "ip"), (None, "l2")]
    other = reps.clone()
    assert tc._route_operands(other, "l2", None)[0] is not flat
    # bf16 reps: the operands are a copy, never a view that keeps the
    # reps alive
    b16 = reps.to(torch.bfloat16)
    assert tc._route_operands(b16, "l2", None)[0].data_ptr() != \
        b16.data_ptr()
    gone = [weakref.ref(t) for t in (reps, other, b16)]
    del reps, other, b16
    gc.collect()
    assert all(r() is None for r in gone)
    assert flat.shape == (18, 8)          # the operands outlive their reps


def test_route_wrapper_checks_its_inputs_on_the_cpu():
    q = torch.zeros((4, 16), dtype=torch.bfloat16)
    reps = torch.zeros((10, 16), dtype=torch.bfloat16)
    bias = torch.zeros(10)
    for args, err in (((q.float(), reps, bias, 3, 10), TypeError),
                      ((q, reps, bias.double(), 3, 10), TypeError),
                      ((q, reps[:, :8], bias, 3, 10), ValueError),
                      ((q, reps, bias, 11, 10), ValueError),
                      ((q, reps, bias, 3, -1), ValueError)):
        with pytest.raises(err):
            route.route_topk(*args, 1.0)
