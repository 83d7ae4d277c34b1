"""The rp-tree kNN-graph builder and the throughput scan of the PyTorch
port vs the JAX package on the CPU. EQUAL: ``_rp_permutation`` given the
JAX package's projection directions (on rows with one nonzero integer
coordinate, whose projections are one rounded product in both packages,
ties included), and ``_leaf_topk_impl`` at leaves under 256 rows on
integer-valued data, where the JAX package takes the exact
``lax.top_k``. By recall against ``knn_graph_exact``, within 0.02 of the
JAX package's (their directions come from different generators):
``knn_graph_rp`` with and without refinement. Under ``allclose`` with the
id overlap stated: ``brute_force_topk_approx``. Then the counterparts of
tests/test_rptree.py on the port alone."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import rptree as jrp  # noqa: E402
from hnsw_nsg_tpu.ops import brute_force_topk_approx as j_approx  # noqa: E402
from hnsw_nsg_tpu.utils.params import NNDescentConfig as JCfg  # noqa: E402
from hnsw_nsg_tpu_torch.models import rptree as trp  # noqa: E402
from hnsw_nsg_tpu_torch.ops import (  # noqa: E402
    brute_force_topk_approx, knn_graph_exact, recall)
from hnsw_nsg_tpu_torch.utils.params import NNDescentConfig  # noqa: E402

RECALL_GAP = 0.02   # |port recall - JAX recall| against the exact graph


@pytest.fixture(scope="module")
def data():
    """tests/test_rptree.py's fixture: 4000 x 24 N(0, 1) rows (seed 5),
    and their exact 10-NN graph."""
    x = np.random.default_rng(5).standard_normal((4000, 24)).astype(
        np.float32)
    return x, knn_graph_exact(torch.from_numpy(x), 10,
                              query_block=2048).numpy()


@pytest.mark.parametrize("levels", [1, 4])
def test_rp_permutation_matches_jax(levels):
    """The JAX function draws its directions from the key; the port is
    given the same directions. Many rows project to equal values: both
    keep them in position order."""
    rng = np.random.default_rng(2)
    n, d = 2048, 16
    x = np.zeros((n, d), np.float32)
    x[np.arange(n), rng.integers(0, d, n)] = rng.integers(-6, 7, n)
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, levels)
    vecs = np.stack([np.asarray(jax.random.normal(keys[lvl], (d,),
                                                  dtype=jnp.float32))
                     for lvl in range(levels)])
    jp = np.asarray(jrp._rp_permutation(key, jnp.asarray(x), levels))
    tp = trp._rp_permutation(torch.from_numpy(x), torch.from_numpy(vecs))
    np.testing.assert_array_equal(tp.numpy(), jp)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_leaf_topk_matches_jax(metric):
    """Leaves of 128 rows (exact top-k in both), integer-valued rows: the
    bf16 rows and f32 sums are exact, so distances and ids are equal,
    ties in position order."""
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, (1024, 12)).astype(np.float32)
    perm = rng.permutation(1024).astype(np.int32)
    jd, ji = jrp._leaf_topk_impl(jnp.asarray(x), jnp.asarray(perm), 128, 10,
                                 metric, 4)
    td, ti = trp._leaf_topk_impl(torch.from_numpy(x),
                                 torch.from_numpy(perm).long(), 128, 10,
                                 metric, 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("refine", [False, True])
def test_knn_graph_rp_recall_matches_jax(data, refine):
    x, gt = data
    kw = dict(n_trees=3, leaf_size=256, seed=2)
    cfg = dict(K=10, L=24, iters=2, S=8, R=8)
    rj = recall(jrp.knn_graph_rp(x, 10, refine=JCfg(**cfg) if refine
                                 else None, **kw), gt)
    rt = recall(trp.knn_graph_rp(x, 10, refine=NNDescentConfig(**cfg)
                                 if refine else None, device="cpu", **kw), gt)
    assert abs(rt - rj) <= RECALL_GAP, (rt, rj)


@pytest.mark.parametrize("metric,use_bf16", [("l2", True), ("ip", True),
                                             ("l2", False)])
def test_brute_force_topk_approx_matches_jax(metric, use_bf16):
    """The port's top-k is exact where the JAX package's is approx_max_k
    (exact on the CPU too): distances allclose (rtol 1e-5, atol 1e-3 for
    f32 sums over d = 32 in another order), ids equal at >= 99.5% of the
    slots (they may differ only among near-equal distances)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    jd, ji = j_approx(jnp.asarray(q), jnp.asarray(x), 10, metric=metric,
                      tile=1024, use_bf16=use_bf16)
    td, ti = brute_force_topk_approx(torch.from_numpy(q), torch.from_numpy(x),
                                     10, metric=metric, tile=1000,
                                     use_bf16=use_bf16)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-3)
    assert (ti.numpy() == np.asarray(ji)).mean() >= 0.995
    assert ti.dtype == torch.int64 and (td[:, 1:] >= td[:, :-1]).all()


# -- counterparts of tests/test_rptree.py -------------------------------------

def test_recall_grows_with_trees(data):
    x, gt = data
    r4 = recall(trp.knn_graph_rp(x, 10, n_trees=4, leaf_size=256, seed=1,
                                 device="cpu"), gt)
    r8 = recall(trp.knn_graph_rp(x, 10, n_trees=8, leaf_size=256, seed=1,
                                 device="cpu"), gt)
    assert r8 > r4 > 0.5
    assert r8 > 0.9


def test_refinement_improves(data):
    x, gt = data
    stats = {}
    base = trp.knn_graph_rp(x, 10, n_trees=3, leaf_size=256, seed=2,
                            device="cpu")
    refined = trp.knn_graph_rp(
        x, 10, n_trees=3, leaf_size=256, seed=2, device="cpu", stats=stats,
        refine=NNDescentConfig(K=10, L=24, iters=3, S=8, R=8))
    assert recall(refined, gt) > recall(base, gt)
    assert set(stats) == {"rp_trees", "nndescent"}


def test_no_self_edges_valid_ids(data):
    x, _ = data
    adj = trp.knn_graph_rp(x, 10, n_trees=4, leaf_size=256, seed=3,
                           device="cpu")
    n = len(adj)
    assert adj.shape == (n, 10) and adj.dtype == np.int32
    assert (adj != np.arange(n)[:, None]).all()
    assert (adj < n).all()


def test_non_power_of_two_n():
    """The padding path: N not divisible by the leaves."""
    x = np.random.default_rng(7).standard_normal((1037, 16)).astype(
        np.float32)
    adj = trp.knn_graph_rp(x, 5, n_trees=4, leaf_size=128, seed=4,
                           device="cpu")
    assert adj.shape == (1037, 5)
    assert (adj < 1037).all()
    gt = knn_graph_exact(torch.from_numpy(x), 5, query_block=1037).numpy()
    assert recall(adj, gt) > 0.7
