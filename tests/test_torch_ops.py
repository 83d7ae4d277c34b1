"""PyTorch port vs the JAX package: distances, top-k, brute force, recall,
synthetic data. Same numpy inputs through both; f32 on the CPU."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from hnsw_nsg_tpu import ops as jops  # noqa: E402
from hnsw_nsg_tpu_torch import ops as tops  # noqa: E402
from hnsw_nsg_tpu_torch.utils.synth import make_data  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)   # f32 sums in another order


def _data(seed, n=300, nq=40, d=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("exact", [True, False])
def test_pairwise_dists_matches_jax(metric, exact):
    x, q = _data(0)
    want = np.asarray(jops.pairwise_dists(jnp.asarray(q), jnp.asarray(x),
                                          metric, exact=exact))
    got = tops.pairwise_dists(torch.from_numpy(q), torch.from_numpy(x),
                              metric, exact=exact).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_squared_norms_matches_jax():
    x, _ = _data(1)
    np.testing.assert_allclose(
        tops.squared_norms(torch.from_numpy(x)).numpy(),
        np.asarray(jops.squared_norms(jnp.asarray(x))), **TOL)


def test_topk_smallest_tie_order_matches_jax():
    """F-H6: equal distances keep position order, as jax.lax.top_k."""
    rng = np.random.default_rng(2)
    d = rng.integers(0, 6, (30, 50)).astype(np.float32)   # many ties
    ids = rng.permutation(30 * 50).reshape(30, 50).astype(np.int32)
    jd, ji = jops.topk_smallest(jnp.asarray(d), jnp.asarray(ids), 12)
    td, ti = tops.topk_smallest(torch.from_numpy(d), torch.from_numpy(ids), 12)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("tile,valid_n", [(65536, None), (64, None),
                                          (64, 250)])
def test_brute_force_topk_matches_jax(metric, tile, valid_n):
    x, q = _data(3)
    jd, ji = jops.brute_force_topk(
        jnp.asarray(q), jnp.asarray(x), 10, metric=metric, tile=tile,
        valid_n=None if valid_n is None else jnp.int32(valid_n))
    td, ti = tops.brute_force_topk(
        torch.from_numpy(q), torch.from_numpy(x), 10, metric=metric,
        tile=tile, valid_n=valid_n)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_recall_matches_jax():
    rng = np.random.default_rng(4)
    gt = rng.integers(0, 50, (64, 10)).astype(np.int32)
    found = np.where(rng.random((64, 10)) < 0.7, gt,
                     rng.integers(0, 50, (64, 10))).astype(np.int32)
    gt[:5, 7:] = -1          # ragged ground truth rows
    for k in (None, 5):
        want = jops.recall(found, gt, k=k)
        got = tops.recall(torch.from_numpy(found), gt, k=k)
        assert abs(got - want) < 1e-6, (k, got, want)   # f32 vs f64 mean


@pytest.mark.parametrize("kw", [dict(metric="l2"), dict(metric="ip"),
                                dict(metric="l2", uint8=True),
                                dict(metric="l2", uniform=True)])
def test_make_data_byte_identical_to_bench(kw):
    a = bench.make_data(5000, 16, 32, seed=0, **kw)
    b = make_data(5000, 16, 32, seed=0, **kw)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
