"""Beam search and occlusion pruning of the PyTorch port vs the JAX
package, on the same numpy inputs and the same JAX-built graph."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import beam as jbeam  # noqa: E402
from hnsw_nsg_tpu.models.prune import occlusion_prune as j_prune  # noqa: E402
from hnsw_nsg_tpu.ops import knn_graph_exact as j_knn_exact  # noqa: E402
from hnsw_nsg_tpu.ops import distance as jdist  # noqa: E402
from hnsw_nsg_tpu_torch.models import beam as tbeam  # noqa: E402
from hnsw_nsg_tpu_torch.models.prune import (  # noqa: E402
    occlusion_prune, occlusion_prune_padded)
from hnsw_nsg_tpu_torch.ops import distance as tdist  # noqa: E402
from hnsw_nsg_tpu_torch.ops import merge_select as tms  # noqa: E402

T = torch.from_numpy


def _pool(rng, x, b, c, n_dup=3):
    """Random candidate pools with exact l2 distances, PADs and repeats."""
    n = len(x)
    nodes = rng.choice(n, b, replace=False)
    cand = rng.integers(0, n, (b, c)).astype(np.int32)
    cand[:, -n_dup:] = cand[:, :n_dup]            # repeated candidates
    cand[rng.random((b, c)) < 0.1] = -1
    cand[:, 0] = nodes                            # the node itself
    d = ((x[np.clip(cand, 0, None)] - x[nodes][:, None]) ** 2).sum(-1)
    d = np.where(cand >= 0, d, 3.4e37).astype(np.float32)
    return nodes.astype(np.int32), cand, d


def test_prune_matches_scalar_sync_prune(rng):
    """tests/test_nsg.py's scalar transcription of sync_prune
    (index_nsg.cpp:326-345), through the port."""
    x = rng.standard_normal((200, 16)).astype(np.float32)
    node = 0
    cand = np.arange(1, 60, dtype=np.int32)
    cd = ((x[cand] - x[node]) ** 2).sum(-1).astype(np.float32)
    kept = []
    for j in np.argsort(cd)[:50]:
        p, dp = cand[j], cd[j]
        if not any(((x[t] - x[p]) ** 2).sum() < dp for t in kept):
            kept.append(int(p))
        if len(kept) == 8:
            break
    xt = T(x)
    got_i, _ = occlusion_prune(xt[:1], T(cand[None]), T(cd[None]), xt,
                               tdist.squared_norms(xt), max_keep=8,
                               scan_cap=50)
    assert [i for i in got_i[0].tolist() if i >= 0] == kept
    want_i, _ = j_prune(jnp.asarray(x[:1]), jnp.asarray(cand[None]),
                        jnp.asarray(cd[None]), jnp.asarray(x),
                        jdist.squared_norms(jnp.asarray(x)), max_keep=8,
                        scan_cap=50)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_prune_batch_matches_jax(metric):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 12)).astype(np.float32)
    nodes, cand, d = _pool(rng, x, 37, 60)
    if metric == "ip":
        d = np.where(cand >= 0, 1.0 - (x[np.clip(cand, 0, None)]
                                       * x[nodes][:, None]).sum(-1),
                     3.4e37).astype(np.float32)
    want_i, want_d = j_prune(
        jnp.asarray(x[nodes]), jnp.asarray(cand), jnp.asarray(d),
        jnp.asarray(x), jdist.squared_norms(jnp.asarray(x)), max_keep=10,
        scan_cap=48, metric=metric, self_ids=jnp.asarray(nodes))
    xt = T(x)
    got_i, got_d = occlusion_prune(
        xt[nodes], T(cand), T(d), xt, tdist.squared_norms(xt), max_keep=10,
        scan_cap=48, metric=metric, self_ids=T(nodes))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    ids = got_i.numpy()
    assert (ids != nodes[:, None]).all()           # self dropped
    if metric == "l2":     # a repeat of a kept id has pair distance 0
        for row in ids:
            v = row[row >= 0]
            assert len(np.unique(v)) == len(v)
    # the padded entry point is the same rule
    pi, pd = occlusion_prune_padded(
        xt[nodes], T(cand), T(d), xt, tdist.squared_norms(xt), max_keep=10,
        scan_cap=48, metric=metric, self_ids=T(nodes))
    assert torch.equal(pi, got_i) and torch.equal(pd, got_d)


@pytest.fixture(scope="module")
def graph():
    """A JAX-built graph (exact 16-NN) over clustered data, queries, and
    random init ids, all numpy."""
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((12, 24)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 12, 2000)]
         + rng.standard_normal((2000, 24))).astype(np.float32)
    q = (centers[rng.integers(0, 12, 96)]
         + rng.standard_normal((96, 24))).astype(np.float32)
    adj = np.array(j_knn_exact(jnp.asarray(x), 16, query_block=1024))
    init = rng.integers(0, 2000, (96, 20)).astype(np.int32)
    init[:, -2:] = -1
    return x, q, adj, init


def _agree(got_d, got_i, want_d, want_i):
    got_i, want_i = got_i.numpy(), np.asarray(want_i)
    assert (got_i == want_i).mean() >= 0.99
    same = got_i == want_i
    np.testing.assert_allclose(got_d.numpy()[same], np.asarray(want_d)[same],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("expand", [1, 2])
def test_beam_search_chunked_matches_jax(graph, expand):
    """Same graph and init ids; short chunks and a small compaction floor
    so that converged queries leave the batch mid-search."""
    x, q, adj, init = graph
    kw = dict(width=32, metric="l2", expand=expand, chunk_hops=4,
              min_compact=8)
    want = jbeam.beam_search_chunked(
        jnp.asarray(q), jnp.asarray(x), jdist.squared_norms(jnp.asarray(x)),
        jnp.asarray(adj), jnp.asarray(init), use_kernel=False, **kw)
    xt = T(x)
    before = tms.launches
    got = tbeam.beam_search_chunked(T(q), xt, tdist.squared_norms(xt),
                                    T(adj), T(init), **kw)
    assert tms.launches == before
    _agree(got.dists, got.ids, want.dists, want.ids)
    assert (got.hops.numpy() == np.asarray(want.hops)).mean() >= 0.99
    assert (got.evals.numpy() == np.asarray(want.evals)).mean() >= 0.99


def test_beam_search_collect_chunked_matches_jax(graph):
    x, q, adj, init = graph
    kw = dict(width=24, collect=120, metric="l2", chunk_hops=8)
    want_res, want_pi, want_pd = jbeam.beam_search_collect_chunked(
        jnp.asarray(q), jnp.asarray(x), jdist.squared_norms(jnp.asarray(x)),
        jnp.asarray(adj), jnp.asarray(init), use_kernel=False, **kw)
    xt = T(x)
    got_res, got_pi, got_pd = tbeam.beam_search_collect_chunked(
        T(q), xt, tdist.squared_norms(xt), T(adj), T(init), **kw)
    _agree(got_res.dists, got_res.ids, want_res.dists, want_res.ids)
    _agree(got_pd, got_pi, want_pd, want_pi)


def test_select_frontier_matches_jax():
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, 100, (13, 20)).astype(np.int32)
    exp = rng.random((13, 20)) < 0.7
    exp[0] = True
    for e in (1, 3, 7):
        want = jbeam._select_frontier(jnp.asarray(ids), jnp.asarray(exp), e)
        got = tbeam._select_frontier(T(ids), T(exp), e)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("exact", [False, True])
def test_gathered_and_point_dists_match_jax(metric, exact):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    ids = rng.integers(-1, 50, (6, 9)).astype(np.int32)
    want = jdist.gathered_dists(jnp.asarray(q), jnp.asarray(x),
                                jnp.asarray(ids), metric,
                                jdist.squared_norms(jnp.asarray(x)), exact)
    xt = T(x)
    got = tdist.gathered_dists(T(q), xt, T(ids), metric,
                               tdist.squared_norms(xt), exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(
        tdist.point_dists(T(q), xt[:6], metric).numpy(),
        np.asarray(jdist.point_dists(jnp.asarray(q), jnp.asarray(x[:6]),
                                     metric)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tdist.exact_from_fast(got, T(q), metric).numpy(),
        np.asarray(jdist.exact_from_fast(want, jnp.asarray(q), metric)),
        rtol=1e-5, atol=1e-4)
