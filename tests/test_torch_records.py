"""The packed int8 records of the PyTorch port vs the JAX package on the
CPU: the same numpy inputs from a seed go through both. Record rows are
byte-equal; on integer-valued data (every int8 and bf16 product and every
f32 sum exact) the beams return equal ids, distances, hops and evals;
NSG, hybrid and HNSW searches over records agree on a graph carried
across by the JAX package's files; accelerated inserts build the same
graph; and the rules that drop the records hold."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import records as jrec  # noqa: E402
from hnsw_nsg_tpu.models.hnsw import HNSWIndex as JHNSW  # noqa: E402
from hnsw_nsg_tpu.models.hybrid import HybridHNSWNSG as JHybrid  # noqa: E402
from hnsw_nsg_tpu.models.nsg import NSGIndex as JNSG  # noqa: E402
from hnsw_nsg_tpu.utils.params import HNSWConfig as JConfig  # noqa: E402
from hnsw_nsg_tpu.utils.params import NSGBuildConfig as JNSGConfig  # noqa: E402
from hnsw_nsg_tpu_torch.models import records as trec  # noqa: E402
from hnsw_nsg_tpu_torch.models.hnsw import HNSWIndex  # noqa: E402
from hnsw_nsg_tpu_torch.models.hybrid import HybridHNSWNSG  # noqa: E402
from hnsw_nsg_tpu_torch.models.nsg import NSGIndex  # noqa: E402
from hnsw_nsg_tpu_torch.ops import merge_select  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import HNSWConfig  # noqa: E402

# float data: f32 sums of exact products in another order
TOL = dict(rtol=1e-5, atol=1e-4)
N, D, R, NQ = 1200, 20, 14, 48


def _int_data(seed, n=N, d=D, nq=NQ):
    """Integer-valued rows in [-6, 6]: quantized exactly at scale 1 (or
    within half a step at the data's own scale), exact in bf16, and
    every dot and norm an exact f32 integer."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-6, 7, (n, d)).astype(np.float32),
            rng.integers(-6, 7, (nq, d)).astype(np.float32))


def _knn_adj(x, r, pad_frac=0.0, seed=0):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    adj = np.argsort(d2, axis=1, kind="stable")[:, :r].astype(np.int32)
    if pad_frac:
        rng = np.random.default_rng(seed)
        cut = rng.random(adj.shape) < pad_frac
        adj = np.where(np.cumsum(cut, 1) > 0, -1, adj).astype(np.int32)
    return adj


def _norms(x):
    return (x.astype(np.float64) ** 2).sum(1).astype(np.float32)


def _both_graphs(x, adj, scale=None):
    nrm = _norms(x)
    jg = jrec.build_record_graph(jnp.asarray(x), jnp.asarray(adj),
                                 jnp.asarray(nrm), scale=scale, chunk=512)
    tg = trec.build_record_graph(torch.from_numpy(x), torch.from_numpy(adj),
                                 torch.from_numpy(nrm), scale=scale,
                                 chunk=512)
    return jg, tg


@pytest.mark.parametrize("r,d", [(16, 64), (30, 128), (32, 128), (50, 128),
                                 (13, 30), (7, 5)])
def test_layout_matches_jax(r, d):
    assert trec._layout(r, d) == jrec._layout(r, d)


@pytest.mark.parametrize("n,d,r,pad,scale", [
    (700, 30, 13, 0.2, None),      # d % 4 != 0, PAD slots, data scale
    (512, 64, 16, 0.0, None),
    (300, 7, 9, 0.3, 0.02),        # d < 4 nw, a given scale that clips
    (1100, 128, 30, 0.1, None),    # HNSW's one 4 KB row
])
def test_record_rows_byte_equal_jax(n, d, r, pad, scale):
    rng = np.random.default_rng(n + d)
    x = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    adj = _knn_adj(x, r, pad, seed=n)
    jg, tg = _both_graphs(x, adj, scale)
    assert tg.rows.dtype == torch.int32 and tg.rows.shape == jg.rows.shape
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    assert tg.scale == float(jg.scale) and (tg.r, tg.d) == (jg.r, jg.d)
    assert tg.nbytes() == jg.nbytes() and tg.s == jg.s
    nw, _ = trec._layout(r, d)
    for s in (tg.scale, 0.37):
        jq = np.asarray(jrec.quantize_rows(jnp.asarray(x), jnp.float32(s),
                                           nw=nw))
        tq = trec.quantize_rows(torch.from_numpy(x), s, nw)
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy().astype(np.int32), jq)


def test_update_record_rows_byte_equal_jax():
    x, _ = _int_data(2, n=400)
    x = x * 1.7
    adj = _knn_adj(x, 12)
    jg, tg = _both_graphs(x, adj)
    nw, _ = trec._layout(12, D)
    rng = np.random.default_rng(5)
    row_ids = rng.choice(400, 60, replace=False).astype(np.int32)
    row_ids[::7] = -1                          # dropped entries
    new_adj = rng.integers(-1, 400, (60, 12)).astype(np.int32)
    nrm = _norms(x)
    jq = jrec.quantize_rows(jnp.asarray(x), jg.scale, nw=nw)
    jrows = jrec.update_record_rows(jg.rows, jq, jnp.asarray(nrm),
                                    jnp.asarray(new_adj),
                                    jnp.asarray(row_ids), nw=nw)
    tq = trec.quantize_rows(torch.from_numpy(x), tg.scale, nw)
    trows = trec.update_record_rows(tg.rows, tq, torch.from_numpy(nrm),
                                    torch.from_numpy(new_adj),
                                    torch.from_numpy(row_ids), nw)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))


def _search_both(x, q, adj, init, scale, **kw):
    nrm = _norms(x)
    jg, tg = _both_graphs(x, adj, scale)
    jr = jrec.beam_search_records(jnp.asarray(q), jnp.asarray(x),
                                  jnp.asarray(nrm), jg, jnp.asarray(init),
                                  **kw)
    tr = trec.beam_search_records(torch.from_numpy(q), torch.from_numpy(x),
                                  torch.from_numpy(nrm), tg,
                                  torch.from_numpy(init), **kw)
    return [np.asarray(a) for a in jr], [t.numpy() for t in tr]


@pytest.mark.parametrize("metric,expand,scale", [
    ("l2", 1, 1.0), ("l2", 2, 1.0), ("ip", 1, 1.0), ("l2", 1, None)])
def test_beam_search_records_equals_jax_on_integer_data(metric, expand,
                                                        scale):
    """Integer-valued data at scale 1 quantizes exactly and every value is
    exact: all four outputs equal. At the data's own scale (max 6 ->
    6/127) the int8 dots are still exact integers, the same in both
    packages, but scaling them rounds (the two packages' compilers
    round that product at different places): ids, hops and evals equal,
    distances within TOL."""
    x, q = _int_data(3)
    adj = _knn_adj(x, R, 0.1, seed=3)
    init = np.random.default_rng(4).integers(0, N, (NQ, 8)).astype(np.int32)
    jr, tr = _search_both(x, q, adj, init, scale, width=24, metric=metric,
                          max_hops=128, expand=expand)
    for a, b in zip(jr[1:], tr[1:]):
        np.testing.assert_array_equal(b, a)
    if scale == 1.0:
        np.testing.assert_array_equal(tr[0], jr[0])
    else:
        np.testing.assert_allclose(tr[0], jr[0], **TOL)


def test_beam_search_records_float_data():
    """Float data: the sums differ in order, so distances agree to TOL and
    ids at >= 99% of the slots."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    adj = _knn_adj(x, R)
    init = rng.integers(0, N, (NQ, 8)).astype(np.int32)
    jr, tr = _search_both(x, q, adj, init, None, width=24, max_hops=128)
    assert (tr[1] == jr[1]).mean() >= 0.99
    same = tr[1] == jr[1]
    np.testing.assert_allclose(tr[0][same], jr[0][same], **TOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_record_pad_slots_stay_pad_dist_f_h5(metric):
    """F-H5: the int8 rescale must not move PAD slots off PAD_DIST; the
    real slots equal the JAX package's distances."""
    x, q = _int_data(12, n=200, nq=6)
    adj = _knn_adj(x, 9, 0.4, seed=12)
    jg, tg = _both_graphs(x, adj, 1.0)
    nw, _ = trec._layout(9, D)
    sel = np.random.default_rng(2).integers(0, 200, (6, 2))
    td, ti = trec._record_dists(
        trec._byte_order(trec._split_query(torch.from_numpy(q), D, nw)),
        tg.rows[torch.from_numpy(sel)], tg.scale, 9, nw, metric)
    jd, ji = jrec._record_dists(
        jrec._split_query(jnp.asarray(q), D, nw), jg.rows[sel], jg.scale,
        9, nw, metric)
    pad = ti.numpy() < 0
    assert pad.any() and (td.numpy()[pad] == np.float32(3.4e37)).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_compaction_identical_results():
    """Converged-query compaction changes no query's result (the port of
    tests/test_records.py's test of the same name)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    adj = _knn_adj(x, R)
    init = torch.from_numpy(rng.integers(0, N, (NQ, 8)).astype(np.int32))
    _, tg = _both_graphs(x, adj)
    args = (torch.from_numpy(q), torch.from_numpy(x),
            torch.from_numpy(_norms(x)), tg, init)
    plain = trec.beam_search_records(*args, width=32, max_hops=128,
                                     min_compact=NQ + 1)
    compacted = trec.beam_search_records(*args, width=32, max_hops=128,
                                         chunk_hops=2, min_compact=2)
    for a, b in zip(plain, compacted):
        assert torch.equal(a, b)


def test_cpu_records_beam_launches_no_kernel():
    x, q = _int_data(8, n=300, nq=8)
    _, tg = _both_graphs(x, _knn_adj(x, 8), 1.0)
    before = merge_select.launches
    trec.beam_search_records(torch.from_numpy(q), torch.from_numpy(x),
                             torch.from_numpy(_norms(x)), tg,
                             torch.zeros((8, 1), dtype=torch.int32), width=16)
    assert merge_select.launches == before == 0


# -- the engines over records -------------------------------------------------

@pytest.mark.parametrize("l_search,entry", [(16, False), (32, True)])
def test_nsg_build_accel_search_matches_jax(tmp_path, l_search, entry):
    """One graph carried across by the JAX package's .npz; both packages
    build their records and search them (no random fill: the medoid's R
    neighbours cover l_search = 16, the 2-hop init the larger ones)."""
    x, q = _int_data(9)
    adj = _knn_adj(x, 16, 0.1, seed=9)
    jidx = JNSG(jnp.asarray(x), jnp.asarray(_norms(x)), jnp.asarray(adj), 5)
    path = str(tmp_path / "g.npz")
    jidx.save(path)
    tidx = NSGIndex.load(path, x, device="cpu")
    jidx.build_accel(chunk=512)
    tidx.build_accel(chunk=512)
    np.testing.assert_array_equal(tidx.records.rows.numpy(),
                                  np.asarray(jidx.records.rows))
    if entry:
        ent = np.random.default_rng(1).integers(0, N, NQ).astype(np.int32)
        jd, ji = jidx.search_from_enterpoint(jnp.asarray(q),
                                             jnp.asarray(ent), k=10,
                                             l_search=l_search)
        td, ti = tidx.search_from_enterpoint(torch.from_numpy(q),
                                             torch.from_numpy(ent), k=10,
                                             l_search=l_search)
    else:
        jd, ji = jidx.search(jnp.asarray(q), k=10, l_search=l_search)
        td, ti = tidx.search(torch.from_numpy(q), k=10, l_search=l_search)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


CHUNKS = [64] * 2 + [128] * 3   # batches the JAX package pads nothing in


def _add_chunked(idx, x, accel):
    s = 0
    for c in CHUNKS:
        idx.add_items(x[s : s + c], batch_size=c, accel=accel)
        s += c


@pytest.fixture(scope="module")
def hnsw_pair(tmp_path_factory):
    """One seed's integer-valued data inserted by both packages with
    add_items(accel=True), and the JAX graph's .npz."""
    x, q = _int_data(11, n=512, d=16, nq=32)
    jidx = JHNSW(16, 512, JConfig(M=8, ef_construction=32))
    _add_chunked(jidx, x, True)
    tidx = HNSWIndex(16, 512, HNSWConfig(M=8, ef_construction=32),
                     device="cpu")
    _add_chunked(tidx, x, True)
    path = str(tmp_path_factory.mktemp("hnsw") / "j.npz")
    jidx.save(path)
    return x, q, jidx, tidx, path


def test_accel_insert_builds_the_jax_graph(hnsw_pair):
    """add_items(accel=True): the same adjacency at every level, the same
    maintained rows as the JAX package's, and those equal a fresh pack of
    the final graph at the same scale."""
    x, _, jidx, tidx, _ = hnsw_pair
    assert (tidx.ep, tidx.max_level) == (jidx.ep, jidx.max_level)
    n = tidx.n    # the JAX arena has power-of-two rows: compare n of them
    np.testing.assert_array_equal(tidx.adj0.numpy(),
                                  np.asarray(jidx.adj0)[:n])
    assert len(tidx.adj_up) == len(jidx.adj_up)
    for a, b in zip(tidx.adj_up, jidx.adj_up):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:n])
    g = tidx._records
    assert tidx._maintain_records and g.scale == float(jidx._records.scale)
    np.testing.assert_array_equal(g.rows.numpy(),
                                  np.asarray(jidx._records.rows)[:n])
    np.testing.assert_array_equal(tidx._dataq.numpy().astype(np.int32),
                                  np.asarray(jidx._dataq)[:n])
    fresh = trec.build_record_graph(tidx.data, tidx.adj0[:, : g.r],
                                    tidx.norms, scale=g.scale)
    assert torch.equal(fresh.rows, g.rows)
    assert tidx.check_integrity()


def test_accel_knn_query_matches_jax(hnsw_pair):
    """knn_query over the maintained records (no deletes, no filter):
    labels, exact distances and the hop/evaluation counters equal."""
    _, q, jidx, tidx, _ = hnsw_pair
    for ef, k in ((32, 10),):
        h0, e0 = tidx.metric_hops, tidx.metric_distance_computations
        jh0, je0 = jidx.metric_hops, jidx.metric_distance_computations
        jl, jd = jidx.knn_query(q, k=k, ef=ef)
        tl, td = tidx.knn_query(q, k=k, ef=ef)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(td, jd)
        assert tidx.metric_hops - h0 == jidx.metric_hops - jh0 > 0
        assert (tidx.metric_distance_computations - e0
                == jidx.metric_distance_computations - je0)


def test_build_accel_knn_query_matches_jax(hnsw_pair):
    """build_accel on a graph carried by the .npz, then knn_query."""
    _, q, _, _, path = hnsw_pair
    jidx = JHNSW.load(path)
    tidx = HNSWIndex.load(path, device="cpu")
    assert tidx._records is None
    jidx.build_accel()
    tidx.build_accel()
    np.testing.assert_array_equal(tidx._records.rows.numpy(),
                                  np.asarray(jidx._records.rows))
    for entry in ("routed", "descend"):
        jl, jd = jidx.knn_query(q, k=10, ef=48, entry=entry)
        tl, td = tidx.knn_query(q, k=10, ef=48, entry=entry)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(td, jd)


def test_records_invalidation_rules(hnsw_pair):
    """A mutation without accel drops the records; with accel they stay
    maintained; resize drops them; deletes and filters bypass them."""
    x, q, _, _, path = hnsw_pair
    idx = HNSWIndex.load(path, max_elements=600, device="cpu")
    idx.build_accel()
    idx.add_items(x[:8] + 0.5, np.arange(5000, 5008))
    assert idx._records is None and not idx._maintain_records
    idx.build_accel()
    idx.repair_connectivity()
    assert idx._records is None
    idx.add_items(x[8:16] + 0.5, np.arange(6000, 6008), accel=True)
    assert idx._maintain_records and idx._records is not None
    g = idx._records
    fresh = trec.build_record_graph(idx.data, idx.adj0[:, : g.r], idx.norms,
                                    scale=g.scale)
    assert torch.equal(fresh.rows, g.rows)
    idx.add_items(x[16:24] + 0.5, np.arange(7000, 7008))   # still maintained
    assert idx._records is not None
    assert torch.equal(trec.build_record_graph(
        idx.data, idx.adj0[:, : g.r], idx.norms, scale=g.scale).rows,
        idx._records.rows)
    idx.mark_deleted(5000)                     # deletes bypass the records
    labels, _ = idx.knn_query(q, k=10, ef=32)
    assert 5000 not in labels
    idx.resize_index(700)
    assert idx._records is None and idx._dataq is None
    idx.build_accel()
    idx.clear_accel()
    assert idx._records is None
    assert HNSWIndex.load(path, device="cpu")._records is None


def test_hybrid_build_accel_search_matches_jax(hnsw_pair, tmp_path):
    """The JAX package's hybrid over the fixture's graph (its NSG layer
    from the exact kNN graph), carried across by its files."""
    _, q, _, _, path = hnsw_pair
    jh = JHybrid.__new__(JHybrid)
    jh.hnsw, jh.metric, jh.nsg = JHNSW.load(path), "l2", None
    jh.nsg_cfg = JNSGConfig(L=24, R=16, C=80)
    jh.build_nsg_layer()
    prefix = str(tmp_path / "h")
    jh.save(prefix)
    th = HybridHNSWNSG.load(prefix, device="cpu")
    jh.build_accel()
    th.build_accel()
    np.testing.assert_array_equal(th.nsg.records.rows.numpy(),
                                  np.asarray(jh.nsg.records.rows))
    jl, jd = jh.search_knn(q, k=10, l_search=32)
    tl, td = th.search_knn(q, k=10, l_search=32)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td, jd)
    th.nsg = None
    with pytest.raises(RuntimeError, match="build_nsg_layer"):
        th.build_accel()
