"""The inline neighbour-record layout, its beam and the exact re-rank of
the PyTorch port vs the JAX package on the CPU, on the same numpy inputs
from a seed. On integer-valued data (exact in bf16, every product and
f32 sum exact) the beams return equal ids, distances, hops and evals."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import inline_graph as jin  # noqa: E402
from hnsw_nsg_tpu_torch.models import inline_graph as tin  # noqa: E402

# float data: f32 sums of exact products in another order
TOL = dict(rtol=1e-5, atol=1e-4)
N, D, R, NQ = 1000, 24, 12, 40


def _data(seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (N, D)).astype(np.float32)
        q = rng.integers(-8, 9, (NQ, D)).astype(np.float32)
    else:
        x = rng.standard_normal((N, D)).astype(np.float32)
        q = rng.standard_normal((NQ, D)).astype(np.float32)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    adj = np.argsort(d2, axis=1, kind="stable")[:, :R].astype(np.int32)
    adj[rng.random((N, R)) < 0.05] = -1           # PAD slots
    init = rng.integers(0, N, (NQ, 6)).astype(np.int32)
    nrm = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return x, q, adj, init, nrm


def _graphs(x, adj, nrm):
    jg = jin.build_inline_graph(jnp.asarray(x), jnp.asarray(adj),
                                jnp.asarray(nrm), chunk=300)
    tg = tin.build_inline_graph(torch.from_numpy(x), torch.from_numpy(adj),
                                torch.from_numpy(nrm), chunk=300)
    return jg, tg


def test_build_layout_matches_jax():
    x, _, adj, _, nrm = _data(1, integer=False)
    jg, tg = _graphs(x, adj, nrm)
    assert tg.recs.dtype == torch.bfloat16
    assert (tg.n, tg.degree, tg.nbytes()) == (jg.n, jg.degree, jg.nbytes())
    np.testing.assert_array_equal(
        tg.recs.float().numpy(), np.asarray(jg.recs.astype(jnp.float32)))
    np.testing.assert_array_equal(tg.nids.numpy(), np.asarray(jg.nids))
    np.testing.assert_array_equal(tg.nnorms.numpy(), np.asarray(jg.nnorms))
    # norms left out are computed from the data
    tg2 = tin.build_inline_graph(torch.from_numpy(x), torch.from_numpy(adj))
    np.testing.assert_allclose(tg2.nnorms.numpy(), tg.nnorms.numpy(),
                               rtol=1e-6)


def _search_both(x, q, adj, init, nrm, **kw):
    jg, tg = _graphs(x, adj, nrm)
    jr = jin.beam_search_inline(jnp.asarray(q), jnp.asarray(x),
                                jnp.asarray(nrm), jg, jnp.asarray(init), **kw)
    tr = tin.beam_search_inline(torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(nrm), tg,
                                torch.from_numpy(init), **kw)
    return [np.asarray(a) for a in jr], [t.numpy() for t in tr]


@pytest.mark.parametrize("metric,expand", [("l2", 1), ("l2", 3), ("ip", 1)])
def test_beam_search_inline_equals_jax_on_integer_data(metric, expand):
    x, q, adj, init, nrm = _data(2, integer=True)
    jr, tr = _search_both(x, q, adj, init, nrm, width=20, metric=metric,
                          max_hops=96, expand=expand)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b, a)


def test_beam_search_inline_float_data():
    """bf16 products summed in another order: ids at >= 99% of the slots,
    distances within TOL where they agree; hops and evals within 2% in
    all (a swapped near-tie can change a query's walk)."""
    x, q, adj, init, nrm = _data(3, integer=False)
    jr, tr = _search_both(x, q, adj, init, nrm, width=20, max_hops=96)
    same = tr[1] == jr[1]
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tr[0][same], jr[0][same], **TOL)
    assert abs(int(tr[2].sum()) - int(jr[2].sum())) <= 0.02 * jr[2].sum()


def test_compaction_and_chunking_change_no_result():
    x, q, adj, init, nrm = _data(4, integer=False)
    _, tg = _graphs(x, adj, nrm)
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(nrm),
            tg, torch.from_numpy(init))
    a = tin.beam_search_inline(*args, width=24, max_hops=96,
                               min_compact=NQ + 1)
    b = tin.beam_search_inline(*args, width=24, max_hops=96, chunk_hops=3,
                               min_compact=2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rerank_exact_matches_jax(metric):
    """Exact f32 re-distance of candidate ids (PAD slots included) and the
    stable top-k: ids equal, values equal to float64 within f32
    rounding and to the JAX package's within TOL."""
    x, q, _, _, nrm = _data(5, integer=False)
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, N, (NQ, 30)).astype(np.int32)
    jd, ji = jin.rerank_exact(jnp.asarray(q), jnp.asarray(x),
                              jnp.asarray(nrm), jnp.asarray(ids), 8,
                              metric=metric)
    td, ti = tin.rerank_exact(torch.from_numpy(q), torch.from_numpy(x),
                              torch.from_numpy(nrm), torch.from_numpy(ids), 8,
                              metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    xi = x[ti.numpy()].astype(np.float64)
    q64 = q.astype(np.float64)[:, None, :]
    want = ((q64 - xi) ** 2).sum(-1) if metric == "l2" else \
        1.0 - (q64 * xi).sum(-1)
    np.testing.assert_allclose(td.numpy(), want, rtol=1e-5, atol=1e-4)
