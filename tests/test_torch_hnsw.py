"""HNSW of the PyTorch port vs the JAX package on the CPU: the same numpy
data from a seed goes through both. Traversal functions (ids equal,
distances allclose 1e-5), search on one graph carried across by each
package's files, build from one seed, the stock hnswlib fixture, and the
port's own repairs (tie order, connectivity repair)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import beam as jbeam  # noqa: E402
from hnsw_nsg_tpu.models.hnsw import HNSWIndex as JHNSW  # noqa: E402
from hnsw_nsg_tpu.utils.params import HNSWConfig as JConfig  # noqa: E402
from hnsw_nsg_tpu_torch.models import beam as tbeam  # noqa: E402
from hnsw_nsg_tpu_torch.models.hnsw import HNSWIndex  # noqa: E402
from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import HNSWConfig  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
N, D, NQ, M, EFC = 1024, 16, 64, 8, 32
# Batches that the JAX package pads nothing in: each call's batch_size is
# its chunk's length and the first call has <= 64 rows (no cold start).
CHUNKS = [64] * 4 + [256] * 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _add_chunked(idx, x):
    s = 0
    for c in CHUNKS:
        idx.add_items(x[s : s + c], batch_size=c)
        s += c


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One seed's data built by both packages, and the JAX graph carried
    into the port through the JAX package's .npz."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    jidx = JHNSW(D, N, JConfig(M=M, ef_construction=EFC))
    _add_chunked(jidx, x)
    tidx = HNSWIndex(D, N, HNSWConfig(M=M, ef_construction=EFC),
                     device="cpu")
    _add_chunked(tidx, x)
    path = str(tmp_path_factory.mktemp("hnsw") / "j.npz")
    jidx.save(path)
    loaded = HNSWIndex.load(path, device="cpu")
    _, gt = brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    return x, q, jidx, tidx, loaded, gt.numpy(), path


def _bfs_reach(idx):
    adj = idx.adj0[: idx.n].numpy()
    seen = np.zeros(idx.n, bool)
    seen[idx.ep] = True
    frontier = np.array([idx.ep])
    while len(frontier):
        nxt = adj[frontier].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return int(seen.sum())


# -- (a) traversal functions -------------------------------------------------

def test_greedy_descent_matches_jax(built):
    x, q, jidx, _, loaded, _, _ = built
    start = np.full(NQ, jidx.ep, np.int32)
    jc, jd = jbeam.greedy_descent(
        jnp.asarray(q), jidx.data, jidx.norms, jidx.adj_up[0],
        jnp.asarray(start))
    tc, td = tbeam.greedy_descent(
        torch.from_numpy(q), loaded.data, loaded.norms, loaded.adj_up[0],
        torch.from_numpy(start))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert (tc.numpy() != start).any()          # the walk moved


@pytest.mark.parametrize("expand", [1, 3])
def test_beam_search_filtered_matches_jax(built, expand):
    x, q, jidx, _, loaded, _, _ = built
    accept = np.random.default_rng(5).random(N) < 0.6
    init = np.full((NQ, 1), jidx.ep, np.int32)
    jr = jbeam.beam_search_filtered(
        jnp.asarray(q), jidx.data, jidx.norms, jidx.adj0, jnp.asarray(init),
        width=24, accept=jnp.asarray(accept), expand=expand)
    tr = tbeam.beam_search_filtered(
        torch.from_numpy(q), loaded.data, loaded.norms, loaded.adj0,
        torch.from_numpy(init), width=24, accept=torch.from_numpy(accept),
        expand=expand)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    live = np.asarray(jr.ids) >= 0
    assert accept[np.asarray(jr.ids)[live]].all()
    np.testing.assert_allclose(tr.dists.numpy()[live],
                               np.asarray(jr.dists)[live], **TOL)
    np.testing.assert_array_equal(tr.hops.numpy(), np.asarray(jr.hops))
    np.testing.assert_array_equal(tr.evals.numpy(), np.asarray(jr.evals))


# -- (b) search parity on one graph ------------------------------------------

@pytest.mark.parametrize("entry", ["routed", "descend"])
@pytest.mark.parametrize("mode", ["plain", "deleted", "filtered"])
def test_search_on_the_jax_graph_matches_jax(built, entry, mode):
    """Labels equal (no near-tie exception was needed: overlap 1.0),
    distances allclose 1e-5, hop and evaluation counts equal."""
    x, q, jidx, _, loaded, _, _ = built
    kw = {}
    dead = list(range(0, 200, 7))
    if mode == "deleted":
        for lab in dead:
            jidx.mark_deleted(lab)
            loaded.mark_deleted(lab)
    elif mode == "filtered":
        kw["filter_ids"] = np.arange(N) % 3 != 0
    try:
        for i in (jidx, loaded):
            i.metric_hops = i.metric_distance_computations = 0
        jl, jd = jidx.knn_query(q, k=10, ef=48, entry=entry, **kw)
        tl, td = loaded.knn_query(q, k=10, ef=48, entry=entry, **kw)
    finally:
        if mode == "deleted":
            for lab in dead:
                jidx.unmark_deleted(lab)
                loaded.unmark_deleted(lab)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, **TOL)
    assert loaded.metric_hops == jidx.metric_hops > 0
    assert (loaded.metric_distance_computations
            == jidx.metric_distance_computations)
    if mode == "deleted":
        assert not np.isin(tl, dead).any()
    if mode == "filtered":
        assert (tl % 3 != 0).all()


def test_port_file_read_by_the_jax_package(built, tmp_path):
    """The other direction: the port's .npz loads in the JAX package and
    both answer alike."""
    x, q, _, tidx, _, _, _ = built
    path = str(tmp_path / "t.npz")
    tidx.save(path)
    back = JHNSW.load(path)
    assert back.n == tidx.n and back.ep == tidx.ep
    assert back.max_level == tidx.max_level
    np.testing.assert_array_equal(np.asarray(back.adj0[:N]),
                                  tidx.adj0.numpy())
    jl, jd = back.knn_query(q, k=10, ef=48)
    tl, td = tidx.knn_query(q, k=10, ef=48)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, **TOL)


def test_save_load_roundtrip_and_append(built, tmp_path):
    x, q, _, tidx, _, _, path = built
    p = str(tmp_path / "t.npz")
    tidx.save(p)
    back = HNSWIndex.load(p, max_elements=N + 100, device="cpu")
    l1, _ = tidx.knn_query(q, k=5, ef=32)
    l2, _ = back.knn_query(q, k=5, ef=32)
    np.testing.assert_array_equal(l1, l2)
    extra = np.random.default_rng(9).standard_normal((100, D)).astype(
        np.float32)
    back.add_items(extra, np.arange(5000, 5100))
    assert back.n == N + 100 and back.check_integrity()
    lab, _ = back.knn_query(extra[:20], k=1, ef=32)
    assert (lab[:, 0] == np.arange(5000, 5020)).mean() >= 0.9


# -- (c) build parity from one seed ------------------------------------------

def test_build_matches_jax(built):
    """Levels, enterpoint and the adjacency of every level equal the JAX
    build's (measured: every row of every level). The batches are those
    the JAX package does not pad: in a padded batch its dummy rows take
    intra-batch candidate slots, which the port does not copy. A near-tied
    occlusion test may flip under another f32 summation order, so a row in
    a hundred may differ before this fails."""
    _, _, jidx, tidx, _, _, _ = built
    np.testing.assert_array_equal(tidx.levels[:N], jidx.levels[:N])
    assert (tidx.ep, tidx.max_level) == (jidx.ep, jidx.max_level)
    assert tidx.max_level >= 2
    for lvl in range(jidx.max_level + 1):
        ja = np.asarray(jidx._adj_at(lvl))[:N]
        ta = tidx._adj_at(lvl)[:N].numpy()
        assert (ja == ta).all(1).mean() >= 0.99, lvl


@pytest.mark.parametrize("which", ["jax graph", "port build", "port default"])
def test_builds_are_sound_and_recall_agrees(built, which):
    """check_integrity, a BFS from the enterpoint that reaches every node,
    and recall@10 at ef=64 within 0.01 of the JAX build's. "port default"
    is one add_items call (cold-start doubling, a ragged last batch)."""
    x, q, jidx, tidx, loaded, gt, _ = built
    jl, _ = jidx.knn_query(q, k=10, ef=64)
    if which == "port default":
        idx = HNSWIndex(D, N, HNSWConfig(M=M, ef_construction=EFC),
                        device="cpu")
        idx.add_items(x, batch_size=300)
    else:
        idx = loaded if which == "jax graph" else tidx
    assert idx.n == N and idx.check_integrity()
    assert _bfs_reach(idx) == N
    tl, _ = idx.knn_query(q, k=10, ef=64)
    assert abs(recall(tl, gt) - recall(jl, gt)) <= 0.01
    assert recall(tl, gt) >= 0.9


def test_link_dist_cache_gives_the_same_graph(built):
    """With the level-0 link distances cached the build is the one that
    recomputes them, and the cache holds each link's exact distance."""
    x, _, _, tidx, _, _, _ = built
    idx = HNSWIndex(D, N, HNSWConfig(M=M, ef_construction=EFC,
                                     link_dist_cache=True), device="cpu")
    _add_chunked(idx, x)
    assert torch.equal(idx.adj0, tidx.adj0)
    adj = idx.adj0.numpy()
    rows, cols = np.nonzero(adj >= 0)
    true_d = ((x[rows] - x[adj[rows, cols]]) ** 2).sum(-1)
    np.testing.assert_allclose(idx.adj0_d.numpy()[rows, cols], true_d,
                               rtol=1e-4, atol=1e-4)


# -- (d) the hnswlib binary format -------------------------------------------

def test_stock_hnswlib_file_answers_as_in_jax():
    """tests/test_stock_hnswlib.py's fixture (written by stock hnswlib,
    M=8, two deleted labels): the port reads it, answers within the same
    overlap of the stock engine's results, and equals the JAX package's
    answer."""
    path = os.path.join(DATA, "stock_hnswlib_m8.bin")
    data = np.fromfile(os.path.join(DATA, "stock_hnswlib_data.bin"),
                       np.float32).reshape(2000, 16)
    queries = np.fromfile(os.path.join(DATA, "stock_hnswlib_queries.bin"),
                          np.float32).reshape(20, 16)
    results = np.fromfile(os.path.join(DATA, "stock_hnswlib_results.bin"),
                          np.int64).reshape(20, 10)
    idx = HNSWIndex.load_hnswlib_format(path, device="cpu")
    assert (idx.n, idx.cfg.M, idx.max_level, idx.ep) == (2000, 8, 4, 1496)
    assert idx.num_deleted == 2
    labels, dists = idx.knn_query(queries, k=10, ef=80)
    overlap = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(labels, results)])
    assert overlap >= 0.95, overlap
    assert not np.isin(labels, [5, 17]).any()
    d0 = ((queries[0] - data[labels[0]]) ** 2).sum(-1)
    np.testing.assert_allclose(dists[0], d0, **TOL)
    jl, jd = JHNSW.load_hnswlib_format(path).knn_query(queries, k=10, ef=80)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(dists, jd, **TOL)


def test_hnswlib_format_bytes_equal_the_jax_writer(built, tmp_path):
    _, _, jidx, _, loaded, _, _ = built
    pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
    jidx.save_hnswlib_format(str(pj))
    loaded.save_hnswlib_format(str(pt))
    assert pj.read_bytes() == pt.read_bytes()
    back = HNSWIndex.load_hnswlib_format(str(pt), device="cpu")
    assert torch.equal(back.adj0, loaded.adj0)
    assert all(torch.equal(a, b) for a, b in zip(back.adj_up, loaded.adj_up))
    np.testing.assert_array_equal(back.levels, loaded.levels)


# -- (g) the port's own repairs ----------------------------------------------

def test_duplicated_points_build_one_graph_f_h6():
    """F-H6: a batch in which every point occurs three times makes exact
    distance ties in the intra-batch block, the pools and the router. Two
    builds of one seed are the same graph, it is sound, and a query finds
    a copy of its point."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((150, 8)).astype(np.float32)
    x = np.concatenate([base, base, base])[rng.permutation(450)]
    graphs = []
    for _ in range(2):
        idx = HNSWIndex(8, 450, HNSWConfig(M=6, ef_construction=24),
                        device="cpu")
        idx.add_items(x, batch_size=128)
        graphs.append(idx)
    a, b = graphs
    assert torch.equal(a.adj0, b.adj0)
    assert all(torch.equal(u, v) for u, v in zip(a.adj_up, b.adj_up))
    assert a.check_integrity() and _bfs_reach(a) == 450
    for entry in ("routed", "descend"):
        la, da = a.knn_query(base[:40], k=3, ef=24, entry=entry)
        lb, _ = b.knn_query(base[:40], k=3, ef=24, entry=entry)
        np.testing.assert_array_equal(la, lb)
        assert (da[:, 0] < 1e-5).mean() >= 0.9


def test_colliding_reverse_proposals_keep_the_last():
    """Several new nodes propose themselves into one (destination, column):
    the last in flattened order wins, id and distance alike."""
    from hnsw_nsg_tpu_torch.models.hnsw import _reverse_insert_round

    x = np.array([[0, 0], [1, 0], [0, 1], [1, 1], [3, 3]], np.float32)
    data = torch.from_numpy(x)
    norms = (data ** 2).sum(1)
    adj = torch.full((5, 2), -1, dtype=torch.int32)
    kept_i = torch.tensor([[0], [0], [0]], dtype=torch.int32)   # 1,2,3 -> 0
    kept_d = torch.tensor([[1.0], [1.0], [2.0]])
    src = torch.tensor([1, 2, 3], dtype=torch.int32)
    cols = torch.tensor([[1], [0], [1]])          # 1 and 3 collide on col 1
    _reverse_insert_round(adj, None, data, norms, kept_i, kept_d, cols, src,
                          torch.tensor([0], dtype=torch.int32), 2, "l2")
    assert sorted(adj[0].tolist()) == [2, 3]      # 3 (the later) beat 1


def test_repair_connectivity_never_cuts_off_an_attached_node():
    """Two in-edge-less nodes whose closest reachable node is full. The
    JAX package overwrites that node's last edge twice, which cuts the
    first node off again while its reach still counts it. The port
    attaches where there is room, and after an overwrite recomputes the
    reach: the graph ends connected."""
    x = np.array([[0, 0], [1, 0], [2, 0], [2.1, 0], [2.2, 0], [5, 0]],
                 np.float32)
    adj0 = np.array([[1, 5], [2, 0], [1, 0], [-1, -1], [-1, -1], [0, -1]],
                    np.int32)
    idx = HNSWIndex._from_arrays(
        x, adj0, [], np.zeros(6, np.int32), np.arange(6), np.zeros(6, bool),
        cap=6, cfg=HNSWConfig(M=1, ef_construction=4), metric="l2",
        max_level=0, ep=0, device="cpu")
    assert _bfs_reach(idx) == 4
    assert idx.repair_connectivity() == 2
    assert _bfs_reach(idx) == 6


# -- what waits --------------------------------------------------------------

def test_capacity_error_message():
    idx = HNSWIndex(4, 10, device="cpu")
    with pytest.raises(RuntimeError, match="exceeds the specified limit"):
        idx.add_items(np.zeros((11, 4), np.float32))


def test_resize_get_items_and_ids(built):
    x, _, _, _, loaded, _, path = built
    idx = HNSWIndex.load(path, device="cpu")
    with pytest.raises(ValueError):
        idx.resize_index(N - 1)
    idx.resize_index(N + 50)
    assert idx.cap == idx.max_elements == N + 50
    assert idx.adj0.shape[0] == N + 50 and len(idx.levels) == N + 50
    idx.add_items(x[:50] + 0.01, np.arange(9000, 9050))
    np.testing.assert_allclose(idx.get_items([9003])[0], x[3] + 0.01)
    assert set(idx.get_ids_list()) == set(range(N)) | set(range(9000, 9050))
    assert idx.is_marked_deleted(7) is False


def test_new_port_modules_import_without_jax():
    mods = ["hnsw_nsg_tpu_torch.models.hnsw",
            "hnsw_nsg_tpu_torch.models.hybrid", "hnsw_nsg_tpu_torch.api",
            "hnsw_nsg_tpu_torch.utils.hnswlib_format",
            "hnsw_nsg_tpu_torch.models.records",
            "hnsw_nsg_tpu_torch.models.inline_graph",
            "hnsw_nsg_tpu_torch.models.extensions",
            "hnsw_nsg_tpu_torch.models.nndescent",
            "hnsw_nsg_tpu_torch.models.rptree"]
    code = ("import sys; sys.modules['jax'] = None; import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
