"""nn-descent and incremental insertion (GraphAdd) of the PyTorch port vs
the JAX package on the CPU. What both packages compute from the same
numpy draws must be EQUAL on integer-valued data: ``_pools_from_adj`` and
the seed pools (``iters=0``: the numpy init, random or warm). The
iterations and ``graph_add`` draw their samples from different
generators, so both packages' graphs are held to ``knn_graph_exact``:
their recalls within 0.02 of each other. Then the counterparts of
tests/test_nndescent.py on the port alone."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import nndescent as jnnd  # noqa: E402
from hnsw_nsg_tpu.ops import squared_norms as j_sq  # noqa: E402
from hnsw_nsg_tpu.utils.params import NNDescentConfig as JCfg  # noqa: E402
from hnsw_nsg_tpu_torch.models import nndescent as tnnd  # noqa: E402
from hnsw_nsg_tpu_torch.models.beam import beam_search  # noqa: E402
from hnsw_nsg_tpu_torch.ops import knn_graph_exact, recall  # noqa: E402
from hnsw_nsg_tpu_torch.ops import squared_norms  # noqa: E402
from hnsw_nsg_tpu_torch.ops.topk import scatter_last  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import NNDescentConfig  # noqa: E402

RECALL_GAP = 0.02   # |port recall - JAX recall| against the exact graph


@pytest.fixture(scope="module")
def data():
    """tests/test_nndescent.py's fixture: 4000 x 24 N(0, 1) rows (seed 3),
    and their exact 10-NN graph."""
    x = np.random.default_rng(3).standard_normal((4000, 24)).astype(
        np.float32)
    return x, knn_graph_exact(torch.from_numpy(x), 10,
                              query_block=2048).numpy()


@pytest.fixture(scope="module")
def int_data():
    """Integer-valued rows (every distance exact in f32) and a graph with
    PAD slots, duplicates and self edges."""
    rng = np.random.default_rng(11)
    x = rng.integers(-5, 6, (600, 12)).astype(np.float32)
    adj = rng.integers(0, 600, (600, 9)).astype(np.int32)
    adj[rng.random(adj.shape) < 0.1] = -1
    return x, adj


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pools_from_adj_matches_jax(int_data, metric):
    x, adj = int_data
    jp = jnnd._pools_from_adj(jnp.asarray(x), j_sq(jnp.asarray(x)),
                              jnp.asarray(adj), metric, 200)
    xt = torch.from_numpy(x)
    tp = tnnd._pools_from_adj(xt, squared_norms(xt), torch.from_numpy(adj),
                              metric, 128)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("warm", [False, True])
def test_seed_pools_match_jax(int_data, warm):
    """iters=0 returns the seed pools: the numpy init (random ids, or the
    warm start's columns filled with random ids) merged into empty pools.
    Ids equal, every tie kept in the JAX package's order."""
    x, adj = int_data
    cfg = dict(K=8, L=16, iters=0, S=4, R=8)
    kw = dict(seed=5, init_adj=adj if warm else None)
    ja = jnnd.nn_descent(x, JCfg(**cfg), chunk=256, **kw)
    ta = tnnd.nn_descent(x, NNDescentConfig(**cfg), chunk=100, device="cpu",
                         **kw)
    np.testing.assert_array_equal(ta, ja)


def test_nn_descent_recall_matches_jax(data):
    x, gt = data
    cfg = dict(K=10, L=24, iters=4, S=8, R=8)
    rj = recall(jnnd.nn_descent(x, JCfg(**cfg), seed=2), gt)
    rt = recall(tnnd.nn_descent(x, NNDescentConfig(**cfg), seed=2,
                                device="cpu"), gt)
    assert abs(rt - rj) <= RECALL_GAP, (rt, rj)
    assert rt > 0.6          # 4 iterations: ~0.70 in both


def test_graph_add_recall_matches_jax(data, added):
    x, gt = data
    n0 = 3000
    base = knn_graph_exact(torch.from_numpy(x[:n0]), 10,
                           query_block=2048).numpy()
    _, ja = jnnd.graph_add(x[:n0], base, x[n0:], seed=7, batch=256,
                           l_add=96)
    _, ta = added
    rj, rt = recall(ja[n0:], gt[n0:]), recall(ta[n0:], gt[n0:])
    assert abs(rt - rj) <= RECALL_GAP, (rt, rj)


def test_scatter_last_keeps_the_last_proposal():
    dst = torch.tensor([[0, 1, 0], [0, 5, -1]])
    col = torch.tensor([[2, 0, 2], [2, 1, 1]])
    vals = torch.tensor([[10, 11, 12], [13, 14, 15]])
    (out,) = scatter_last(3, 3, dst, col, (vals, -1))
    assert out.tolist() == [[-1, -1, 13], [11, -1, -1], [-1, -1, -1]]


def test_sample_masked_takes_only_masked_slots():
    gen = torch.Generator().manual_seed(0)
    mask = torch.rand((50, 20), generator=gen) < 0.3
    idx, got = tnnd._sample_masked(gen, mask, 4)
    assert torch.equal(got, torch.gather(mask, 1, idx))
    assert torch.equal(got.sum(1), mask.sum(1).clamp(max=4))
    assert (idx.sort(1).values.diff(1) > 0).all()       # distinct slots


# -- counterparts of tests/test_nndescent.py -----------------------------------

def test_converges_to_high_graph_recall(data):
    x, gt = data
    stats = {}
    adj = tnnd.nn_descent(x, NNDescentConfig(K=10, L=24, iters=8, S=8, R=8),
                          seed=1, device="cpu", eval_recall_every=2,
                          stats=stats)
    r = recall(adj, gt)
    assert r >= 0.9, f"graph recall {r}"
    its = stats["iterations"]
    assert [it["recall"] is not None for it in its] == [
        i % 2 == 1 for i in range(len(its))]
    assert its[-1]["changed"] >= 0 and its[0]["seconds"] > 0


def test_no_self_edges_no_dups(data):
    x, _ = data
    adj = tnnd.nn_descent(x, NNDescentConfig(K=10, L=24, iters=4, S=8, R=8),
                          seed=2, device="cpu")
    assert adj.dtype == np.int32
    assert (adj != np.arange(len(adj))[:, None]).all()
    for row in adj[:200]:
        v = row[row >= 0]
        assert len(np.unique(v)) == len(v)


def test_warm_start_refine(data):
    """RefineGraph semantics: a noisy init improves."""
    x, gt = data
    rng = np.random.default_rng(9)
    noisy = gt.copy()
    noise_rows = rng.random(noisy.shape) < 0.5
    noisy[noise_rows] = rng.integers(0, len(x), noise_rows.sum())
    r0 = recall(noisy, gt)
    adj = tnnd.nn_descent(x, NNDescentConfig(K=10, L=24, iters=4, S=8, R=8),
                          seed=3, init_adj=noisy, device="cpu")
    assert recall(adj, gt) > r0 + 0.2


def test_ip_metric(data):
    x, _ = data
    adj = tnnd.nn_descent(x, NNDescentConfig(K=10, L=24, iters=6, S=8, R=8),
                          metric="ip", seed=4, device="cpu")
    gt = knn_graph_exact(torch.from_numpy(x), 10, metric="ip",
                         query_block=2048).numpy()
    assert recall(adj, gt) >= 0.8


@pytest.fixture(scope="module")
def added(data):
    """tests/test_nndescent.py's GraphAdd case: the exact graph of the
    first 3000 rows, then the last 1000 inserted (batch 256, l_add 96)."""
    x, gt = data
    n0 = 3000
    base = knn_graph_exact(torch.from_numpy(x[:n0]), 10,
                           query_block=2048).numpy()
    return tnnd.graph_add(x[:n0], base, x[n0:], seed=7, batch=256, l_add=96,
                          device="cpu")


class TestGraphAdd:
    """Incremental insertion (GraphAdd, index_graph.cpp:379-498)."""

    def test_new_nodes_get_good_edges(self, data, added):
        x, gt = data
        data_all, adj = added
        np.testing.assert_array_equal(data_all, x)
        assert adj.shape == (len(x), 10)
        r_new = recall(adj[3000:], gt[3000:])
        assert r_new >= 0.72, f"new-node edge recall {r_new}"

    def test_reverse_edges_reach_old_nodes(self, added):
        _, adj = added
        n0 = 3000
        back = (adj[:n0] >= n0).any(axis=1).mean()
        assert back > 0.05, f"only {back:.3f} of old rows link new nodes"
        assert (adj != np.arange(len(adj))[:, None]).all()
        assert adj.max() < len(adj)

    def test_graph_still_searchable(self, data, added):
        """A beam over the grown graph finds the new points about as often
        as one over the exact graph of the full set (plain kNN graphs lack
        long-range links, so even the exact graph stalls some walks)."""
        x, _ = data
        n0 = 3000
        data_all, adj = added
        xd = torch.from_numpy(data_all)
        q = xd[n0 : n0 + 64]
        init = torch.from_numpy(np.random.default_rng(5).integers(
            0, len(data_all), (64, 64), dtype=np.int32))

        def findability(graph):
            res = beam_search(q, xd, squared_norms(xd),
                              torch.as_tensor(graph), init, width=64)
            ids = res.ids[:, :10].numpy()
            return (ids == np.arange(n0, n0 + 64)[:, None]).any(1).mean()

        exact = knn_graph_exact(xd, 10, query_block=2048)
        assert findability(adj) >= findability(exact) - 0.10
