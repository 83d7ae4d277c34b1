"""Cluster join and the cluster-join kNN graph of the PyTorch port vs the
JAX package, on the same numpy inputs."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.ops import knn_graph_exact as j_knn_exact  # noqa: E402
from hnsw_nsg_tpu.ops.pallas_scan import (  # noqa: E402
    cluster_join_topk as j_join)
from hnsw_nsg_tpu_torch.models.knn_ivf import knn_graph_ivf  # noqa: E402
from hnsw_nsg_tpu_torch.models.nsg import build_nsg  # noqa: E402
from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall  # noqa: E402
from hnsw_nsg_tpu_torch.ops import cluster_scan as cs  # noqa: E402
from hnsw_nsg_tpu_torch.ops.bruteforce import knn_graph_exact  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import NSGBuildConfig  # noqa: E402

# f32 sums of d = 16 products in another order: values agree to a few
# ulps of |bias| (~2d for N(0,1) rows)
TOL = dict(rtol=1e-5, atol=1e-4)


def _join_case(seed, c, maxc, mm, d, dtype, metric):
    rng = np.random.default_rng(seed)
    qv = rng.standard_normal((c, maxc, d)).astype(np.float32)
    st = rng.standard_normal((c, mm, d)).astype(np.float32)
    if dtype == "bf16":   # round once; both packages then get equal values
        qv = np.array(jnp.asarray(qv, jnp.bfloat16).astype(jnp.float32))
        st = np.array(jnp.asarray(st, jnp.bfloat16).astype(jnp.float32))
    valid = rng.random((c, mm)) < 0.85
    if metric == "l2":
        base, scale = (st.astype(np.float64) ** 2).sum(-1), 2.0
    else:
        base, scale = np.ones((c, mm)), 1.0
    bias = np.where(valid, base, np.inf).astype(np.float32)
    return qv, st, bias, scale


def _run_both(qv, st, bias, k, scale, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jv, ji = j_join(jnp.asarray(qv, jdt), jnp.asarray(st, jdt),
                    jnp.asarray(bias), k, scale, interpret=True)
    before = cs.join_launches
    tv, ti = cs.cluster_join_topk(torch.from_numpy(qv).to(tdt),
                                  torch.from_numpy(st).to(tdt),
                                  torch.from_numpy(bias), k, scale)
    assert cs.join_launches == before     # CPU tensors never launch
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


# (mm, k) pairs chosen so that the bucket rule picks each group width
@pytest.mark.parametrize("group,mm,k", [(1, 128, 4), (2, 256, 4),
                                        (4, 512, 4), (8, 1024, 4)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cluster_join_matches_jax_interpret(group, mm, k, dtype):
    assert cs.join_group(mm, k) == group
    qv, st, bias, scale = _join_case(group * 10 + len(dtype), 3, 16, mm, 16,
                                     dtype, "l2")
    (jv, ji), (tv, ti) = _run_both(qv, st, bias, k, scale, dtype)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], **TOL)
    np.testing.assert_array_equal(ti[fin], ji[fin])


@pytest.mark.parametrize("group,mm,k", [(1, 2048, 65), (4, 8192, 65),
                                        (1, 4096, 102), (2, 16384, 202)])
def test_cluster_join_past_k64_matches_jax_interpret(group, mm, k):
    """k past 64, the tensor-core kernel's former limit (on the card 64
    rows a block from k = 77 at d <= 128): the plain version takes any k
    up to the bucket count."""
    assert cs.join_group(mm, k) == group
    qv, st, bias, scale = _join_case(k + group, 2, 8, mm, 16, "f32", "l2")
    (jv, ji), (tv, ti) = _run_both(qv, st, bias, k, scale, "f32")
    assert tv.shape == (2, 8, k)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], **TOL)
    np.testing.assert_array_equal(ti[fin], ji[fin])


def test_cluster_join_ip_and_inf_tail():
    """ip metric; and k larger than the finite buckets of a sparse
    cluster: the tail is +inf in both, ids compared where finite."""
    qv, st, bias, scale = _join_case(7, 2, 8, 64, 16, "f32", "ip")
    bias[1, 5:] = np.inf                      # 5 finite slots, k = 8
    (jv, ji), (tv, ti) = _run_both(qv, st, bias, 8, scale, "f32")
    fin = np.isfinite(jv)
    assert not fin[1].all() and fin[0].all()
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], **TOL)
    np.testing.assert_array_equal(ti[fin], ji[fin])


def test_cluster_join_dead_slab_tails_match_jax_interpret():
    """f32 l2 over stacks of M = 8 slabs of 300 rows, each slab with a
    +inf tail (group 8: bucket b of slab e is slot e * 300 + b), so that
    whole 128-bucket slices of one e are +inf, some slabs wholly so, and
    in the second cluster every slot of most buckets: the rule that lets
    the card's f32 kernel skip such slices (their distances are +inf and
    never lower a bucket's minimum) holds in the TPU kernel too. The
    buckets past the finite ones come out as (+inf, b), lowest b first."""
    qv, st, bias, scale = _join_case(31, 2, 8, 2400, 16, "f32", "l2")
    assert cs.join_group(2400, 4) == 8
    slab = bias.reshape(2, 8, 300)
    for e, size in enumerate([300, 0, 128, 5, 256, 0, 200, 130]):
        slab[0, e, size:] = np.inf
    slab[1] = np.inf
    slab[1, 3, :2] = 1.0                      # two finite buckets, k = 4
    (jv, ji), (tv, ti) = _run_both(qv, st, bias, 4, scale, "f32")
    fin = np.isfinite(jv)
    assert fin[0].all() and fin[1, :, :2].all() and not fin[1, :, 2:].any()
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], **TOL)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    all_inf = np.flatnonzero(np.isinf(slab[1]).all(0))[:2]
    np.testing.assert_array_equal(ti[1, :, 2:], np.broadcast_to(all_inf,
                                                                (8, 2)))


def test_join_group_rule_matches_jax_shapes():
    # the 1M build shape: maxc 2112, M = 8, k = 52 -> group 8
    assert cs.join_group(8 * 2112, 52) == 8
    assert cs.join_group(100, 52) == 1


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((24, 32)).astype(np.float32)
    x = (centers[rng.integers(0, 24, 4000)]
         + rng.standard_normal((4000, 32))).astype(np.float32)
    return x


def test_knn_graph_exact_matches_jax(clustered):
    x = clustered[:1500]
    want = np.asarray(j_knn_exact(jnp.asarray(x), 10, query_block=512))
    got = knn_graph_exact(torch.from_numpy(x), 10, query_block=512).numpy()
    assert got.dtype == np.int32
    assert (got == want).mean() >= 0.999     # f32 near-ties may swap


def test_knn_graph_ivf_quality(clustered):
    """tests/test_knn_ivf.py's quality bar at a fast size: recall >= 0.9
    against the exact graph, no self edges, ids in range."""
    x = clustered
    adj = knn_graph_ivf(x, 10, n_clusters=8, probes=5, seed=0, device="cpu")
    gt = knn_graph_exact(torch.from_numpy(x), 10, query_block=2048)
    r = recall(adj, gt)
    assert r >= 0.9, f"cluster-join graph recall {r}"
    n = len(adj)
    assert adj.dtype == np.int32 and adj.shape == (n, 10)
    assert (adj != np.arange(n)[:, None]).all()
    assert adj.max() < n and adj.min() >= 0


def test_knn_graph_and_nsg_past_the_join_limit(clustered):
    """knn_graph_ivf(x, 70) joins at k = 72, past the fast kernels' 64,
    and an NSG with L = 60 builds on it and searches (1000 points: the
    plain merge of the NSG's collect beam is slow on the CPU)."""
    x = clustered[:1000]
    adj = knn_graph_ivf(x, 70, n_clusters=4, probes=3, seed=0, device="cpu")
    assert adj.dtype == np.int32 and adj.shape == (len(x), 70)
    gt = knn_graph_exact(torch.from_numpy(x), 70, query_block=1024)
    r = recall(adj, gt)
    assert r >= 0.9, f"cluster-join graph recall {r}"
    idx = build_nsg(x, adj, NSGBuildConfig(L=60, R=16, C=80), device="cpu")
    q = x[:100] + 0.1
    _, ids = idx.search(q, k=10, l_search=64)
    _, want = brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    assert recall(ids, want) >= 0.9
