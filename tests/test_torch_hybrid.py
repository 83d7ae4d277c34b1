"""The hybrid HNSW/NSG index of the PyTorch port vs the JAX package on
the CPU: one pair of files written by the JAX package is searched by
both (labels equal, distances allclose 1e-5), the port's files are read
back by the JAX package, and the port's own build is held to recall."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu.models.hybrid import HybridHNSWNSG as JHybrid  # noqa: E402
from hnsw_nsg_tpu.utils.params import HNSWConfig as JConfig  # noqa: E402
from hnsw_nsg_tpu.utils.params import NSGBuildConfig as JNSGConfig  # noqa: E402,E501
from hnsw_nsg_tpu_torch.models.hybrid import HybridHNSWNSG  # noqa: E402
from hnsw_nsg_tpu_torch.ops import (  # noqa: E402
    brute_force_topk, knn_graph_exact, recall)
from hnsw_nsg_tpu_torch.utils.params import HNSWConfig, NSGBuildConfig  # noqa: E402,E501

N, D, NQ, M, EFC = 1024, 16, 64, 8, 32
CHUNKS = [64] * 4 + [256] * 3          # batches the JAX package pads nothing in
NSG = dict(L=24, R=16, C=100)
TOL = dict(rtol=1e-5, atol=1e-5)
# search_from_enterpoint starts from 1 + R + 2R = 49 ids; up to that width
# it adds no random fill, whose draws differ between the packages
L_SEARCH = 40


def _add_chunked(hyb, x):
    s = 0
    for c in CHUNKS:
        hyb.add_points(x[s : s + c], batch_size=c)
        s += c


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    jh = JHybrid(D, N, JConfig(M=M, ef_construction=EFC), JNSGConfig(**NSG))
    _add_chunked(jh, x)
    jh.build_nsg_layer()
    prefix = str(tmp_path_factory.mktemp("hybrid") / "j")
    jh.save(prefix)
    loaded = HybridHNSWNSG.load(prefix, device="cpu")
    th = HybridHNSWNSG(D, N, HNSWConfig(M=M, ef_construction=EFC),
                       NSGBuildConfig(**NSG), device="cpu")
    _add_chunked(th, x)
    th.build_nsg_layer()
    _, gt = brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    return x, q, jh, loaded, th, gt.numpy()


@pytest.mark.parametrize("entry", ["routed", "descend"])
def test_search_on_the_jax_files_matches_jax(built, entry):
    _, q, jh, loaded, _, _ = built
    np.testing.assert_array_equal(loaded.nsg.adj.numpy(),
                                  np.asarray(jh.nsg.adj))
    assert loaded.nsg.ep == jh.nsg.ep and loaded.metric == jh.metric
    jl, jd = jh.search_knn(q, k=10, l_search=L_SEARCH, entry=entry)
    tl, td = loaded.search_knn(q, k=10, l_search=L_SEARCH, entry=entry)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, **TOL)


def test_entries_match_jax(built):
    """The routed entry (bf16 rows) and the descended entry are the same
    nodes in both packages."""
    import jax.numpy as jnp

    _, q, jh, loaded, _, _ = built
    tq = torch.from_numpy(q)
    np.testing.assert_array_equal(
        loaded.hnsw._entry_points(tq).numpy(),
        np.asarray(jh.hnsw._entry_points(jnp.asarray(q))))
    np.testing.assert_array_equal(
        loaded.hnsw._descend_entry(tq).numpy(),
        np.asarray(jh.hnsw._descend_entry(jnp.asarray(q))))


def test_port_build_recall_and_files_read_by_jax(built, tmp_path):
    """The port's own hybrid: recall@10 within 0.01 of the JAX build's at
    one width, and its two files load in the JAX package, which then
    answers as the port does."""
    x, q, jh, _, th, gt = built
    assert th.n == N and th.nsg.adj.shape == (N, NSG["R"])
    jl, _ = jh.search_knn(q, k=10, l_search=L_SEARCH)
    tl, td = th.search_knn(q, k=10, l_search=L_SEARCH)
    assert abs(recall(tl, gt) - recall(jl, gt)) <= 0.01
    assert recall(tl, gt) >= 0.9
    true_d = ((q[0] - x[tl[0]]) ** 2).sum(-1)
    np.testing.assert_allclose(td[0], true_d, rtol=1e-4, atol=1e-4)
    prefix = str(tmp_path / "t")
    th.save(prefix)
    back = JHybrid.load(prefix)
    bl, bd = back.search_knn(q, k=10, l_search=L_SEARCH)
    np.testing.assert_array_equal(bl, tl)
    np.testing.assert_allclose(bd, td, **TOL)


def test_labels_and_stale_base_layer(built):
    x, q, _, _, _, _ = built
    h = HybridHNSWNSG(D, 301, HNSWConfig(M=M, ef_construction=EFC),
                      NSGBuildConfig(**NSG), device="cpu")
    with pytest.raises(RuntimeError, match="build_nsg_layer"):
        h.search_knn(q)
    h.add_points(x[:300], labels=np.arange(7000, 7300), batch_size=100)
    h.build_nsg_layer()
    labels, _ = h.search_knn(x[:20], k=1, l_search=32)
    assert (labels[:, 0] == np.arange(7000, 7020)).mean() >= 0.9
    h.add_points(x[300:301])                  # the base layer is stale now
    assert h.nsg is None and h.n == 301
    with pytest.raises(RuntimeError, match="build_nsg_layer"):
        h.search_knn(q)


def test_load_without_a_base_layer(built, tmp_path):
    _, _, _, _, th, _ = built
    th.hnsw.save(str(tmp_path / "h_hnsw.npz"))
    back = HybridHNSWNSG.load(str(tmp_path / "h"), device="cpu")
    assert back.nsg is None and back.n == N


def test_knn_graph_source_by_size(built):
    """The kNN graph's source follows N as in the JAX package: exact up
    to 8,192, rp-trees refined by nn-descent above (here 8,200 rows, a
    small NSG configuration to keep the CPU build short), and any [N, K]
    graph passed in is taken."""
    x, _, _, _, th, _ = built
    n = 8200
    rows = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, 8)).astype(np.float32))
    big = HybridHNSWNSG.__new__(HybridHNSWNSG)
    big.hnsw = type("H", (), {"n": n, "data": rows,
                              "device": torch.device("cpu")})()
    cfg = NSGBuildConfig(L=10, R=8, C=32)
    big.nsg_cfg, big.metric, big.nsg = cfg, "l2", None
    stats = {}
    big.build_nsg_layer(stats=stats)
    assert {"rp_trees", "nndescent", "knn"} <= set(stats)
    knn = stats["knn_adj"]
    assert knn.shape == (n, cfg.L + 10)
    assert recall(knn[:1000], knn_graph_exact(rows, cfg.L + 10)[:1000]) \
        >= 0.9
    assert big.nsg.adj.shape == (n, cfg.R)
    adj = big.nsg.adj.numpy()
    seen = np.zeros(n, bool)
    frontier = np.array([big.nsg.ep])
    seen[frontier] = True
    while len(frontier):
        nxt = np.unique(adj[frontier].reshape(-1))
        nxt = nxt[(nxt >= 0) & ~seen[np.clip(nxt, 0, None)]]
        seen[nxt] = True
        frontier = nxt
    assert seen.all()
    knn = th.nsg.adj.numpy()                  # any [N, K] graph is taken
    th2 = HybridHNSWNSG.__new__(HybridHNSWNSG)
    th2.hnsw, th2.nsg_cfg, th2.metric = th.hnsw, th.nsg_cfg, "l2"
    th2.build_nsg_layer(knn_adj=knn)
    assert th2.nsg.adj.shape == (N, NSG["R"])
