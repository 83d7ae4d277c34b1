"""k-means of the PyTorch port vs the JAX package, on the same numpy data."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu.models.kmeans import kmeans as jkmeans  # noqa: E402
from hnsw_nsg_tpu_torch.models.kmeans import kmeans as tkmeans  # noqa: E402


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((24, 16)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 24, 6000)]
         + rng.standard_normal((6000, 16))).astype(np.float32)
    return x


def _inertia(x, cents, assign):
    return float(((x - cents[assign]) ** 2).sum(-1).mean())


@pytest.mark.parametrize("seed", [0, 3])
def test_same_seed_same_initial_centroids(clustered, seed):
    """iters=0 returns the seeded draw itself: same rows in both."""
    jc, ja = jkmeans(clustered, 24, iters=0, seed=seed, chunk=2048)
    tc, ta = tkmeans(torch.from_numpy(clustered), 24, iters=0, seed=seed,
                     chunk=2048)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (ta.numpy() == np.asarray(ja)).mean() >= 0.99


@pytest.mark.parametrize("chunk", [65536, 2048])
def test_iterations_agree_with_jax(clustered, chunk):
    """After the iterations: >= 99% equal assignments, inertia within 1%
    (f32 update sums in another order; bf16 assignment GEMM in both)."""
    jc, ja = jkmeans(clustered, 24, iters=8, seed=0, chunk=chunk)
    tc, ta = tkmeans(torch.from_numpy(clustered), 24, iters=8, seed=0,
                     chunk=chunk)
    ja, ta = np.asarray(ja), ta.numpy()
    assert (ja == ta).mean() >= 0.99
    ij = _inertia(clustered, np.asarray(jc), ja)
    it = _inertia(clustered, tc.numpy(), ta)
    assert abs(it - ij) <= 0.01 * ij, (it, ij)


def test_empty_clusters_reseeded():
    """More clusters than distinct points: empties take the farthest
    points, as in the reference, and no centroid stays undefined."""
    rng = np.random.default_rng(1)
    x = np.repeat(rng.standard_normal((5, 8)).astype(np.float32), 40, axis=0)
    x += 1e-3 * rng.standard_normal(x.shape).astype(np.float32)
    jc, ja = jkmeans(x, 12, iters=4, seed=0)
    tc, ta = tkmeans(torch.from_numpy(x), 12, iters=4, seed=0)
    assert np.isfinite(tc.numpy()).all()
    assert (ta.numpy() == np.asarray(ja)).mean() >= 0.99
