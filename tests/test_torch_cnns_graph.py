"""CNNS graph locals of the PyTorch port vs the JAX package: the exact
in-cluster pools and medoids, the local NSG arena, the graph-local search
(cross-loaded JAX indexes and port-built ones), save/load both ways, the
HNSW router and the local HNSW ablation."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import cnns as jc  # noqa: E402
from hnsw_nsg_tpu.utils.params import CNNSConfig, NSGBuildConfig  # noqa: E402
from hnsw_nsg_tpu_torch.models import cnns as tc  # noqa: E402
from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall  # noqa: E402

NSG_CFG = NSGBuildConfig(L=20, R=12, C=80)
CFG = CNNSConfig(n_clusters=8, m=3, kmeans_iters=10, nsg=NSG_CFG)
_JDT = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def clustered():
    """tests/test_cnns.py's fixture: 4,000 x 16, 20 Gaussian centres."""
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((20, 16)).astype(np.float32) * 4
    assign = rng.integers(0, 20, 4000)
    x = (centers[assign] + rng.standard_normal((4000, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 20, 48)]
         + rng.standard_normal((48, 16))).astype(np.float32)
    _, gt = brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    return x, q, gt


@pytest.fixture(scope="module")
def jax_nsg(clustered, tmp_path_factory):
    """The JAX package's nsg-local index per slab dtype, saved, and loaded
    by both packages."""
    x, _, _ = clustered
    tmp = tmp_path_factory.mktemp("cnns_nsg")
    out = {}
    for sdt in _JDT:
        ji = jc.build_cnns(x, CFG, local_index="nsg", slab_dtype=_JDT[sdt])
        path = str(tmp / f"{sdt}.npz")
        ji.save(path)
        out[sdt] = (ji, jc.CNNSIndex.load(path),
                    tc.CNNSIndex.load(path, device="cpu"))
    return out


def _host_slabs(x, ids_c, n_real):
    """The f32 slabs of the real clusters, as build_cnns lays them out."""
    ids = np.asarray(ids_c)[:n_real]
    data_c = np.zeros(ids.shape + (x.shape[1],), np.float32)
    data_c[ids >= 0] = x[ids[ids >= 0]]
    return data_c, (ids >= 0).sum(1)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_pools_and_medoids_match_jax(clustered, jax_nsg, metric):
    """One block of 8 clusters (maxc 1000, pool 80). Distances within
    rtol 1e-5 and atol 1e-6 x the largest squared norm: the f32 rounding
    of ||a||^2 + ||b||^2 - 2<a, b> summed in another order (measured:
    3.1e-4 in l2 and 9.2e-5 in ip at a largest norm of 452.5). Ids equal
    except inside runs of distances tied within that tolerance (measured:
    92 of 640,000 slots in l2, 20 in ip); medoids equal."""
    x, _, _ = clustered
    ji = jax_nsg["f32"][0]
    data_c, sizes = _host_slabs(x, ji.ids_c, ji.n_real)
    b, maxc, _ = data_c.shape
    base = np.arange(b, dtype=np.int32) * maxc
    jp_i, jp_d = jc._cluster_exact_pools(
        jnp.asarray(data_c), jnp.asarray(sizes, jnp.int32),
        jnp.asarray(base), pool_w=80, metric=metric)
    tp_i, tp_d = tc._cluster_exact_pools(
        torch.from_numpy(data_c), torch.from_numpy(sizes),
        torch.from_numpy(base), 80, metric)
    jp_i, jp_d = np.asarray(jp_i), np.asarray(jp_d)
    tol = dict(rtol=1e-5, atol=1e-6 * float((data_c ** 2).sum(-1).max()))
    np.testing.assert_allclose(tp_d.numpy(), jp_d, **tol)
    diff = tp_i.numpy() != jp_i
    # a mismatch is allowed only where the distance is tied with a
    # neighbouring rank
    tied = np.zeros_like(diff)
    tied[..., 1:] |= np.isclose(jp_d[..., 1:], jp_d[..., :-1], **tol)
    tied[..., :-1] |= np.isclose(jp_d[..., :-1], jp_d[..., 1:], **tol)
    assert not (diff & ~tied).any(), int((diff & ~tied).sum())
    assert diff.sum() <= 0.001 * diff.size, int(diff.sum())
    jm = np.asarray(jc._cluster_medoids(jnp.asarray(data_c),
                                        jnp.asarray(sizes, jnp.int32)))
    tm = tc._cluster_medoids(torch.from_numpy(data_c),
                             torch.from_numpy(sizes)).numpy()
    np.testing.assert_array_equal(tm, jm)


def _reachable(adj, seeds, dead):
    return tc._bfs(adj, seeds, dead.copy())


def test_arena_matches_jax(clustered, jax_nsg):
    """The port's local_nsg_arena on the JAX build's slabs against the
    JAX build's arena: mean per-row edge overlap >= 0.9 (measured: 1.0),
    the same entry points; degree <= R, no self edges, dead rows
    edge-free, every real node reachable from the medoids."""
    x, _, _ = clustered
    ji = jax_nsg["f32"][0]
    c = ji.n_real
    data_c, sizes = _host_slabs(x, ji.ids_c, c)
    maxc = data_c.shape[1]
    stages = {}
    t_adj, t_eps = tc.local_nsg_arena(data_c, sizes, NSG_CFG, "l2",
                                      device="cpu", stage_seconds=stages)
    assert set(stages) == {"pools_prune", "interinsert", "repair"}
    t_adj = t_adj.numpy()
    j_adj = np.asarray(ji.flat_adj)[: c * maxc]
    np.testing.assert_array_equal(t_eps, ji.eps_flat[:c])
    live = ~tc._dead_rows(sizes, maxc)
    overlap = [len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, (a >= 0).sum())
               for a, b in zip(j_adj[live], t_adj[live])]
    assert np.mean(overlap) >= 0.9, np.mean(overlap)
    deg = (t_adj >= 0).sum(1)
    assert deg.max() <= NSG_CFG.R and deg[live].min() >= 1
    assert not (t_adj == np.arange(c * maxc)[:, None]).any()
    assert (t_adj[~live] == -1).all()
    assert (t_adj[t_adj >= 0] // maxc
            == np.nonzero(t_adj >= 0)[0] // maxc).all()   # in-cluster
    assert _reachable(t_adj, t_eps[sizes > 0], ~live).all()


# (positions of a 1-d cluster, its edges, R): a cluster whose medoid is
# node 0 and whose stragglers 2 and 3 both lie nearest node 1
REPAIR_CASES = {
    # node 1 has room for one straggler only: 2 attaches there, then 3's
    # nearest reachable member (1) is full, and overwriting its last edge
    # (the JAX package's repair) would cut 2 off again
    "room_past_the_nearest": ([0.0, 10.0, 11.0, 10.4],
                              [[1, -1], [0, -1], [-1, -1], [-1, -1]], 2),
    # every reachable member is full: one edge must be overwritten, and
    # the BFS from every medoid runs again
    "all_reachable_full": ([0.0, 10.0, 11.0, 12.0],
                           [[1], [0], [-1], [-1]], 1),
}


@pytest.mark.parametrize("case", list(REPAIR_CASES))
def test_local_nsg_repair_never_cuts_off_an_attached_node(case):
    """F-R8: the repair attaches a straggler to the nearest reachable
    member of its cluster that has room, so no edge that reached a node
    is lost; only when every reachable member is full does it overwrite,
    and then it looks again from every medoid."""
    pos, edges, r = REPAIR_CASES[case]
    data_c = np.zeros((1, 4, 1), np.float32)
    data_c[0, :, 0] = pos
    adj = np.array(edges, np.int32)
    before = {(u, v) for u, row in enumerate(edges) for v in row if v >= 0}
    out = tc._repair_arena(data_c, np.array([4]), adj.copy(),
                           np.array([0], np.int64))
    assert _reachable(out, [0], np.zeros(4, bool)).all()
    after = {(u, v) for u, row in enumerate(out) for v in row if v >= 0}
    if case == "room_past_the_nearest":
        assert before <= after          # no edge was overwritten
        assert (1, 2) in after and (2, 3) in after
    assert ((out >= 0).sum(1) <= r).all()


def _check_ids(jd, ji, td, ti):
    """Ids equal row for row except at near-ties (counted, at most 1% of
    the slots), distances allclose (rtol 1e-5, atol 1e-4) where the ids
    agree."""
    jd, ji, td, ti = (np.asarray(a) for a in (jd, ji, td, ti))
    same = ti == ji
    assert same.mean() >= 0.99, (~same).sum()
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-4)
    return int((~same).sum())


@pytest.mark.parametrize("sdt", list(_JDT))
def test_cross_loaded_nsg_search_matches_jax(clustered, jax_nsg, sdt):
    """A JAX-saved nsg-local index (f32, bf16 and int8 slabs: SQ8 on this
    data) cross-loaded into the port: the same ids (measured: every slot
    equal) and distances, through both routers."""
    _, q, _ = clustered
    _, jl, tl = jax_nsg[sdt]
    assert tl.local_index == "nsg" and tl.flat_adj is not None
    for nprobe, l_search in ((4, 64), (2, 32)):
        jd, jid = jl.search(q, k=10, nprobe=nprobe, l_search=l_search)
        td, tid = tl.search(torch.from_numpy(q), k=10, nprobe=nprobe,
                            l_search=l_search)
        assert _check_ids(jd, jid, td, tid) == 0


# the recall@10 each slab type's build must reach at nprobe 4, l_search 64
# (measured, both packages alike: f32 0.808, bf16 0.796, SQ8 0.760; the
# rounded slabs rank a few near neighbours wrongly)
RECALL_FLOOR = {"f32": 0.8, "bf16": 0.78, "int8": 0.74}


@pytest.mark.parametrize("sdt", list(_JDT))
def test_port_built_nsg_index_recall(clustered, jax_nsg, sdt):
    """The port's own build has the JAX build's slab layout, slabs and
    entry points, and reaches recall@10 >= RECALL_FLOOR at nprobe 4 and
    l_search 64, within 0.02 of the JAX build's."""
    x, q, gt = clustered
    ji = jax_nsg[sdt][0]
    ti = tc.build_cnns(x, CFG, local_index="nsg", slab_dtype=_TDT[sdt],
                       device="cpu")
    np.testing.assert_array_equal(ti.ids_c.numpy(), np.asarray(ji.ids_c))
    np.testing.assert_array_equal(ti.eps_flat, ji.eps_flat)
    assert ti.qscale == ji.qscale
    assert ti.data_c.dtype == (_TDT[sdt] or torch.float32)
    np.testing.assert_array_equal(ti.data_c.float().numpy(),
                                  np.asarray(ji.data_c, np.float32))
    _, tid = ti.search(torch.from_numpy(q), k=10, nprobe=4, l_search=64)
    _, jid = ji.search(q, k=10, nprobe=4, l_search=64)
    r_t, r_j = recall(tid, gt), recall(np.asarray(jid), gt)
    assert r_t >= RECALL_FLOOR[sdt] and abs(r_t - r_j) <= 0.02, (r_t, r_j)


def test_nsg_save_load_both_ways(clustered, tmp_path):
    """port -> npz -> port keeps flat_adj and eps_flat and the search;
    port -> npz -> JAX gives an equal arena and the same ids."""
    x, q, _ = clustered
    ti = tc.build_cnns(x, CFG, local_index="nsg", device="cpu")
    p = str(tmp_path / "nsg.npz")
    ti.save(p)
    t2 = tc.CNNSIndex.load(p, device="cpu")
    assert t2.local_index == "nsg"
    assert torch.equal(t2.flat_adj, ti.flat_adj)
    np.testing.assert_array_equal(t2.eps_flat, ti.eps_flat)
    qt = torch.from_numpy(q)
    d1, i1 = ti.search(qt, k=10, nprobe=4, l_search=64)
    d2, i2 = t2.search(qt, k=10, nprobe=4, l_search=64)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    j2 = jc.CNNSIndex.load(p)
    np.testing.assert_array_equal(np.asarray(j2.flat_adj),
                                  ti.flat_adj.numpy())
    np.testing.assert_array_equal(j2.eps_flat, ti.eps_flat)
    jd, jid = j2.search(q, k=10, nprobe=4, l_search=64)
    assert _check_ids(jd, jid, d1, i1) == 0


@pytest.fixture(scope="module")
def ablation():
    """tests/test_cnns.py's TestRouterAndLocalAblations data: 12,000 x 24,
    24 Gaussian centres."""
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((24, 24)).astype(np.float32) * 2.0
    xa = rng.integers(0, 24, 12_000)
    x = (centers[xa] + rng.standard_normal((12_000, 24))).astype(np.float32)
    qa = rng.integers(0, 24, 96)
    q = (centers[qa] + rng.standard_normal((96, 24))).astype(np.float32)
    _, gt = brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    return x, q, gt


def test_hnsw_router_matches_flat_router(ablation):
    """tests/test_cnns.py:361-374 on the port: the HNSW router walks the
    representatives the flat GEMM scans, so recall >= flat - 0.05 and
    > 0.85; it is built once, on the index's device, over the real
    clusters' representatives."""
    x, q, gt = ablation
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=24, m=2, kmeans_iters=6),
                        device="cpu")
    qt = torch.from_numpy(q)
    _, i_flat = idx.search(qt, k=10, nprobe=6, router="flat")
    _, i_hnsw = idx.search(qt, k=10, nprobe=6, router="hnsw")
    r_flat, r_hnsw = recall(i_flat, gt), recall(i_hnsw, gt)
    assert r_hnsw >= r_flat - 0.05 and r_hnsw > 0.85, (r_hnsw, r_flat)
    router = idx._router_hnsw
    assert router.n == idx.n_real * 3 and router.device.type == "cpu"
    idx.search(qt, k=10, nprobe=6, router="hnsw")
    assert idx._router_hnsw is router


def test_hnsw_router_on_nsg_locals(clustered, jax_nsg):
    """router="hnsw" over graph locals (the reference's cluster_hnsw_nsg
    pairing): within 0.05 of the flat router's recall."""
    _, q, gt = clustered
    tl = jax_nsg["f32"][2]
    qt = torch.from_numpy(q)
    _, i_flat = tl.search(qt, k=10, nprobe=4, l_search=64)
    _, i_hnsw = tl.search(qt, k=10, nprobe=4, l_search=64, router="hnsw")
    assert recall(i_hnsw, gt) >= recall(i_flat, gt) - 0.05


def test_hnsw_local_index(clustered):
    """The local HNSW ablation (tests/test_cnns.py:376-386) at a smaller N,
    4,000 x 16 in 8 clusters of ~500: each cluster's arena rows are the
    level-0 rows of the port's HNSWIndex(M=8, ef_construction=60) built on
    its members, with the graph's enterpoint as the entry point, and the
    search reaches recall@10 > 0.7 against brute force at nprobe 6 and
    l_search 64 (measured: 0.731).

    Not compared with the JAX package's build, which compiles every
    cluster's shapes anew (114 s at the JAX test's 12,000 x 24 shape on
    the CPU). There the JAX build reaches 0.852 and the port's 0.799: the
    two HNSW builds draw other levels after the first batch (the JAX
    package's padded batches take intra-batch slots with dummies, F-R6),
    so their enterpoints differ, and the beam starts at them; with the
    JAX build's entry points the port's arena reaches 0.853."""
    x, q, gt = clustered
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=8, m=2, kmeans_iters=6),
                        local_index="hnsw", device="cpu")
    assert idx.local_index == "hnsw" and idx.flat_adj.shape[1] == 16
    _, ids = idx.search(torch.from_numpy(q), k=10, nprobe=6, l_search=64)
    assert recall(ids, gt) > 0.7, recall(ids, gt)
    maxc, adj = idx.maxc, idx.flat_adj.numpy()
    ci = int(np.argmax(idx.sizes))
    sz = int(idx.sizes[ci])
    h = tc.HNSWIndex(16, sz, tc.HNSWConfig(M=8, ef_construction=60),
                     device="cpu")
    h.add_items(idx.data_c[ci, :sz].numpy())
    local = h.adj0[:sz].numpy()
    np.testing.assert_array_equal(
        adj[ci * maxc : ci * maxc + sz],
        np.where(local >= 0, local + ci * maxc, -1))
    assert idx.eps_flat[ci] == h.ep + ci * maxc
    assert (adj[ci * maxc + sz : (ci + 1) * maxc] == -1).all()
