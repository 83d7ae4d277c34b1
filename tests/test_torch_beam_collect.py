"""The while-loop collect beam of the PyTorch port vs the JAX package
(``beam_search_collect``, hnsw_nsg_tpu/models/beam.py:414-470) on the CPU.
On integer-valued rows every product and sum is exact in f32, so the
beam's ids, distances, hops and evals and the pool's ids and distances
must be EQUAL."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import beam as jbeam  # noqa: E402
from hnsw_nsg_tpu.ops import knn_graph_exact as j_knn_exact  # noqa: E402
from hnsw_nsg_tpu.ops import squared_norms as j_sq  # noqa: E402
from hnsw_nsg_tpu_torch.models import beam as tbeam  # noqa: E402
from hnsw_nsg_tpu_torch.ops import squared_norms  # noqa: E402

N, D, R, Q = 1200, 16, 10, 20


@pytest.fixture(scope="module")
def graphed():
    rng = np.random.default_rng(21)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (Q, D)).astype(np.float32)
    adj = np.array(j_knn_exact(x, R, query_block=N))
    init = rng.integers(0, N, (Q, 4)).astype(np.int32)
    init[-2:] = -1                     # rows with no entry at all
    return x, q, adj, init


def _run_both(graphed, **kw):
    x, q, adj, init = graphed
    jx = jnp.asarray(x)
    want = jbeam.beam_search_collect(jnp.asarray(q), jx, j_sq(jx),
                                     jnp.asarray(adj), jnp.asarray(init),
                                     **kw)
    xt = torch.from_numpy(x)
    got = tbeam.beam_search_collect(torch.from_numpy(q), xt,
                                    squared_norms(xt), torch.from_numpy(adj),
                                    torch.from_numpy(init), **kw)
    return got, want


@pytest.mark.parametrize("kw", [
    dict(width=24, collect=64),
    dict(width=16, collect=100, expand=2),
    dict(width=32, collect=48, max_hops=5),     # stopped by the hop cap
])
def test_collect_matches_jax(graphed, kw):
    (res, p_i, p_d), (jres, jp_i, jp_d) = _run_both(graphed, **kw)
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_array_equal(res.dists.numpy(), np.asarray(jres.dists))
    np.testing.assert_array_equal(res.hops.numpy(), np.asarray(jres.hops))
    np.testing.assert_array_equal(res.evals.numpy(), np.asarray(jres.evals))
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(jp_i))
    np.testing.assert_allclose(p_d.numpy(), np.asarray(jp_d), rtol=1e-5)


def test_collect_pool_is_sorted_and_distinct(graphed):
    (res, p_i, p_d), _ = _run_both(graphed, width=24, collect=64)
    assert p_i.shape == (Q, 64)
    assert bool((p_d[:, 1:] >= p_d[:, :-1]).all())
    for row in p_i.numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    # the pool holds the beam's retset: every retset id was evaluated
    for r_row, p_row in zip(res.ids.numpy(), p_i.numpy()):
        assert set(r_row[r_row >= 0][:10]) <= set(p_row.tolist())
    assert bool((p_i[-2:] < 0).all())   # rows with no entry collect nothing
