"""The sharded indexes of the PyTorch port (``parallel/mesh.py``) vs the
JAX package's on the CPU, on the same numpy data: the JAX side on the
conftest's 8-device CPU mesh, the port on ``make_mesh(8, devices=["cpu"]
* 8)``. Each of tests/test_mesh.py's ten cases has its counterpart here.

- flat: ids equal, distances allclose 1e-5;
- graph (all shards probed, and routed over unequal shards): on
  integer-valued rows every product is exact, so ids, distances and the
  per-shard evaluation counts are EQUAL;
- kNN build step: ids equal;
- CNNS (routed, replicated, ip over an unaligned cluster count) and
  multi-slice, over one index carried across by ``save``/``load``: ids
  equal outside exact distance ties, distances allclose 1e-5, evaluation
  counts equal; the l2 cases on integer-valued data (exact in f32 in
  both packages). The id overlap is 1.0 in every comparison with the JAX
  package; 0.9984 between the port's four-shard and one-shard searches
  at nprobe 4, from ties at the k-th distance (asserted >= 0.99).

Then the port alone: F-R9 (a sharded uint8 and SQ8 index gives
``CNNSIndex.search``'s distances), ``make_mesh()`` without a card, and
``entry()`` / ``dryrun_multichip`` in process."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from hnsw_nsg_tpu.models.cnns import CNNSIndex as JCNNS  # noqa: E402
from hnsw_nsg_tpu.models.cnns import build_cnns as j_build_cnns  # noqa: E402
from hnsw_nsg_tpu.parallel import mesh as jm  # noqa: E402
from hnsw_nsg_tpu.utils.params import CNNSConfig as JCNNSConfig  # noqa: E402
from hnsw_nsg_tpu_torch import entry as tentry  # noqa: E402
from hnsw_nsg_tpu_torch.models.cnns import CNNSIndex, build_cnns  # noqa: E402
from hnsw_nsg_tpu_torch.ops import (  # noqa: E402
    brute_force_topk, knn_graph_exact, recall)
from hnsw_nsg_tpu_torch.parallel import mesh as tm  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig  # noqa: E402

CPU8 = ["cpu"] * 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jm.make_mesh(8), tm.make_mesh(8, devices=CPU8)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _agree(got_d, got_i, want_d, want_i, min_overlap=0.99):
    """Distances allclose 1e-5; ids equal except where the reference row
    holds the same distance at a neighbouring position or at its last one
    (an exact tie, possibly with a candidate past k). Returns the id
    overlap (the share of each row's ids found in the other row)."""
    gd, gi, wd, wi = (_np(a) for a in (got_d, got_i, want_d, want_i))
    np.testing.assert_allclose(gd, wd, **TOL)
    diff = gi != wi
    tie = np.isclose(wd, wd[:, -1:], rtol=1e-6, atol=0)
    tie[:, 1:] |= np.isclose(wd[:, 1:], wd[:, :-1], rtol=1e-6, atol=0)
    tie[:, :-1] |= np.isclose(wd[:, :-1], wd[:, 1:], rtol=1e-6, atol=0)
    assert not (diff & ~tie).any(), np.argwhere(diff & ~tie)[:5]
    overlap = float(np.mean([len(set(a) & set(b)) / len(a)
                             for a, b in zip(gi, wi)]))
    assert overlap >= min_overlap, overlap
    return overlap


# -- flat ---------------------------------------------------------------------

@pytest.mark.parametrize("n,d,nq,k", [(2000, 16, 32, 10), (1003, 8, 8, 5)],
                         ids=["aligned", "unaligned"])
def test_sharded_flat_matches_jax(meshes, rng, n, d, nq, k):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    jd, ji = jm.ShardedFlatIndex.build(meshes[0], x).search(q, k)
    td, ti = tm.ShardedFlatIndex.build(meshes[1], x).search(q, k)
    assert int(ti.max()) < n
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(td), _np(jd), **TOL)
    _, gt = brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), k)
    assert recall(ti, gt) > 0.999


# -- graph --------------------------------------------------------------------

def _int_shards(rng, sizes, d, spread):
    centers = rng.integers(-spread, spread + 1, (len(sizes), d))
    return [(centers[s] + rng.integers(-3, 4, (sizes[s], d))).astype(
        np.float32) for s in range(len(sizes))], centers


@pytest.mark.parametrize("case", ["all_probe", "routed"])
def test_sharded_graph_matches_jax(meshes, rng, case):
    """all_probe: eight equal shards with entry ids, nprobe = 8 (the JAX
    package's slow test at 256 rows a shard); routed: unequal k-means-like
    shards, nprobe 2 against nprobe 8 (selectivity)."""
    d, k = 16, 10
    if case == "all_probe":
        sizes, spread, eps = [256] * 8, 0, [0] * 8
    else:
        sizes = [150, 210, 256, 175, 300, 140, 256, 225]
        spread, eps = 12, None
    datas, centers = _int_shards(rng, sizes, d, spread)
    adjs = [knn_graph_exact(torch.from_numpy(x), 10).numpy() for x in datas]
    jidx = jm.ShardedGraphIndex.build_from_shards(meshes[0], datas, adjs, eps)
    tidx = tm.ShardedGraphIndex.build_from_shards(meshes[1], datas, adjs, eps)
    assert tidx.rows_pad == jidx.data.shape[0] // 8
    q = (centers[rng.integers(0, 8, 32)]
         + rng.integers(-3, 4, (32, d))).astype(np.float32)
    kw = dict(k=k, l_search=32, nprobe=8 if case == "all_probe" else 2)
    jd, ji, je = jidx.search(q, **kw)
    td, ti, te = tidx.search(q, **kw)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(_np(te), _np(je))
    assert te.shape == (8,)
    if case == "routed":
        # selectivity: 2 of 8 shards cost well under probing all 8
        _, _, te8 = tidx.search(q, k=k, l_search=32, nprobe=8)
        assert int(te.sum()) < 0.5 * int(te8.sum())


def test_sharded_knn_build_matches_jax(meshes, rng):
    x = rng.standard_normal((1024, 12)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(meshes[0],
                                                      P("shard", None)))
    want = np.asarray(jm.sharded_knn_build_step(meshes[0], xs, 8))
    got = tm.sharded_knn_build_step(meshes[1], x, 8)
    assert got.shape == (1024, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    shards = list(torch.from_numpy(x).chunk(8))
    np.testing.assert_array_equal(
        _np(tm.sharded_knn_build_step(meshes[1], shards, 8)), want)


# -- CNNS ---------------------------------------------------------------------

def _clustered(rng, n, d, nq, scale, integer=True):
    """tests/test_mesh.py's mixture; for l2 doubled and rounded to
    integers, where FastL2's cancellation would otherwise leave 1e-4
    absolute differences between two f32 summation orders."""
    centers = rng.standard_normal((30, d)).astype(np.float32) * scale
    x = centers[rng.integers(0, 30, n)] + rng.standard_normal((n, d))
    q = centers[rng.integers(0, 30, nq)] + rng.standard_normal((nq, d))
    if integer:
        x, q = np.round(2 * x), np.round(2 * q)
    return x.astype(np.float32), q.astype(np.float32)


def _carried(tmp_path, name, x, cfg, metric="l2"):
    """One index, built by the JAX package, in both packages."""
    jidx = j_build_cnns(x, JCNNSConfig(**cfg), metric=metric)
    path = str(tmp_path / f"{name}.npz")
    jidx.save(path)
    return JCNNS.load(path), CNNSIndex.load(path, device="cpu")


CFG = dict(n_clusters=30, m=2, kmeans_iters=8)


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    """tests/test_mesh.py's routed fixture (30 clusters of 6000 x 24),
    integer-valued, one index in both packages."""
    x, q = _clustered(np.random.default_rng(42), 6000, 24, 64, 4)
    return (x, q) + _carried(tmp_path_factory.mktemp("routed"), "routed", x,
                             CFG)


def test_sharded_cnns_routed_matches_jax(meshes, routed):
    x, q, jidx, tidx = routed
    js = jm.ShardedCNNSIndex.build(meshes[0], jidx)
    ts = tm.ShardedCNNSIndex.build(meshes[1], tidx)
    jd, ji, je = js.search(q, k=10, nprobe=8)
    td, ti, te = ts.search(q, k=10, nprobe=8)
    _agree(td, ti, jd, ji)
    np.testing.assert_array_equal(_np(te), _np(je))
    # selectivity: at most slots = ceil(8 / 8) + 1 probes a query a shard
    assert (_np(te) <= 64 * 2 * tidx.maxc).all()
    assert int(te.sum()) <= 2.5 * 64 * 8 * tidx.maxc


@pytest.mark.parametrize("nprobe", [4, 8])
def test_sharded_cnns_split_changes_nothing(routed, nprobe):
    """With every probe kept (slots = nprobe) four shards give one shard's
    distances exactly, and its ids outside ties."""
    x, q, _, tidx = routed
    full = tm.ShardedCNNSIndex.build(tm.make_mesh(1, devices=["cpu"]), tidx)
    four = tm.ShardedCNNSIndex.build(tm.make_mesh(4, devices=["cpu"] * 4),
                                     tidx)
    d1, i1, e1 = full.search(q, k=10, nprobe=nprobe, slots=nprobe)
    d4, i4, e4 = four.search(q, k=10, nprobe=nprobe, slots=nprobe)
    assert torch.equal(d1, d4)
    _agree(d4, i4, d1, i1)
    assert int(e1.sum()) == int(e4.sum())


def test_sharded_cnns_replicated_matches_jax(meshes, rng, tmp_path):
    x, q = _clustered(rng, 6000, 24, 64, 2)
    jidx, tidx = _carried(tmp_path, "rep", x, dict(CFG, replicate=True))
    js = jm.ShardedCNNSIndex.build(meshes[0], jidx)
    ts = tm.ShardedCNNSIndex.build(meshes[1], tidx)
    assert ts.replicated
    jd, ji, je = js.search(q, k=10, nprobe=4)
    td, ti, te = ts.search(q, k=10, nprobe=4)
    _agree(td, ti, jd, ji)
    np.testing.assert_array_equal(_np(te), _np(je))
    for row in _np(ti):
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_sharded_cnns_ip_unaligned_matches_jax(meshes, rng, tmp_path):
    """ip metric, a cluster count that is not a multiple of 8: the real
    count is carried (F-H2), and no probe goes to a sentinel row."""
    x, q = _clustered(rng, 6000, 24, 64, 4, integer=False)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jidx, tidx = _carried(tmp_path, "ip", x, CFG, metric="ip")
    js = jm.ShardedCNNSIndex.build(meshes[0], jidx)
    ts = tm.ShardedCNNSIndex.build(meshes[1], tidx)
    assert ts.n_clusters == tidx.n_real == js.n_clusters
    assert ts.reps.shape[0] > ts.n_clusters      # sentinel rows exist
    jd, ji, je = js.search(q, k=10, nprobe=4)
    td, ti, te = ts.search(q, k=10, nprobe=4)
    _agree(td, ti, jd, ji)
    np.testing.assert_array_equal(_np(te), _np(je))


def test_multislice_matches_jax(routed):
    x, q, jidx, tidx = routed
    jmesh = jm.make_multislice_mesh(2)
    tmesh = tm.make_multislice_mesh(2, devices=CPU8)
    assert tmesh.shape == jmesh.shape == {"dcn": 2, "shard": 4}
    js = jm.MultiSliceCNNSIndex.build(jmesh, jidx)
    ts = tm.MultiSliceCNNSIndex.build(tmesh, tidx)
    jd, ji, je = js.search(q, k=10, nprobe=8)
    td, ti, te = ts.search(q, k=10, nprobe=8)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(_np(te), _np(je))
    assert te.shape == (2, 4) and int(te.sum(1).min()) > 0
    with pytest.raises(ValueError, match="slices"):
        ts.search(x[:7], k=5, nprobe=4)


# -- the port alone -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["uint8", "sq8"])
def test_sharded_cnns_keeps_the_query_transform_f_r9(rng, kind):
    """A sharded int8-slab index gives CNNSIndex.search's distances at the
    same probes (every probe kept): the JAX classes drop qshift/qscale."""
    n, d = 4000, 16
    centers = rng.integers(40, 215, (20, d))
    x = centers[rng.integers(0, 20, n)] + rng.normal(0, 12, (n, d))
    q = centers[rng.integers(0, 20, 48)] + rng.normal(0, 12, (48, d))
    if kind == "uint8":
        x, q = (np.clip(a, 0, 255).round() for a in (x, q))
    x, q = x.astype(np.float32), q.astype(np.float32)
    idx = build_cnns(x, CNNSConfig(n_clusters=20, m=2, kmeans_iters=6),
                     slab_dtype=torch.int8, device="cpu")
    assert (idx.qscale == 1.0) == (kind == "uint8")
    sidx = tm.ShardedCNNSIndex.build(tm.make_mesh(4, devices=["cpu"] * 4),
                                     idx)
    for nprobe in (2, 5):
        want_d, want_i = idx.search(q, k=10, nprobe=nprobe)
        got_d, got_i, _ = sidx.search(q, k=10, nprobe=nprobe, slots=nprobe)
        if kind == "uint8":
            assert torch.equal(got_d, want_d)
        _agree(got_d, got_i, want_d, want_i)
    # the exact integer distances of the returned rows (uint8)
    if kind == "uint8":
        ex = ((x[_np(got_i)] - q[:, None]) ** 2).sum(-1)
        np.testing.assert_array_equal(_np(got_d), ex)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tm.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tm.make_multislice_mesh(2)
    assert tm.make_mesh(devices=["cpu"] * 3).shape == {"shard": 3}


def test_entry_matches_jax():
    from __graft_entry__ import entry as j_entry

    jfn, jargs = j_entry()
    jd, ji = jfn(*jargs)
    fn, args = tentry.entry(device="cpu")
    for a, b in zip(args, jargs):        # the norms: two summation orders
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
    td, ti = fn(*args)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(td), np.asarray(jd), **TOL)


def test_dryrun_multichip_in_process():
    tentry.dryrun_multichip(8, devices=CPU8)
