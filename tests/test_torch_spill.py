"""Host-spill CNNS search of the PyTorch port: tests/test_cnns.py's
TestSpill on the port, parity with the JAX package's SpillCNNSIndex (ids
and stats), the qscale >= 2 pad slots (F-R2, F-H5) and that the spill
index lets the resident index go."""

import gc
import weakref

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.models import cnns as jc  # noqa: E402
from hnsw_nsg_tpu.models import spill as js  # noqa: E402
from hnsw_nsg_tpu.utils.params import CNNSConfig  # noqa: E402
from hnsw_nsg_tpu_torch.models import cnns as tc  # noqa: E402
from hnsw_nsg_tpu_torch.models import spill as ts  # noqa: E402
from hnsw_nsg_tpu_torch.ops import PAD_DIST, brute_force_topk, recall  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)   # f32 sums in another order


def _blobs(seed, n_centers, d, n, nq, scale):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * scale
    x = (centers[rng.integers(0, n_centers, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, nq)]
         + rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


def _slab_nbytes(idx):
    return idx.data_c[0].numel() * idx.data_c.element_size()


def test_budgeted_matches_resident_and_respects_budget():
    """tests/test_cnns.py:264-299: the spill search over several groups
    equals the resident per-query probe search on the same visit list
    (ids equal, distances within TOL), no group passes the budget, and
    recall@10 > 0.85."""
    x, q = _blobs(11, 32, 32, 20_000, 128, 2.5)
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=48, m=2, kmeans_iters=6),
                        device="cpu")
    budget = 10 * _slab_nbytes(idx)          # forces several groups
    sp = ts.SpillCNNSIndex(idx, hbm_budget_bytes=budget, group_pad=4)
    qt = torch.from_numpy(q)
    sd, si = sp.search(qt, k=10, nprobe=6)
    visit = idx._route(qt, 6)
    rd, ri = tc._flat_probe_search(qt, visit, idx.data_c, idx.ids_c,
                                   idx.cnorms_c, 10, idx.metric)
    assert torch.equal(si, ri)
    np.testing.assert_allclose(sd.numpy(), rd.numpy(), **TOL)
    assert sp.stats.transfer_rounds >= 2
    assert sp.stats.peak_group_bytes <= budget
    _, gt = brute_force_topk(qt, torch.from_numpy(x), 10)
    assert recall(si, gt) > 0.85


def test_replicated_spill_matches_resident_search():
    """tests/test_cnns.py:301-331 (F-H3): a replicated index holds
    boundary points in two slabs; the spill search carries 2k candidates
    and dedups, so it equals the resident search and holds no duplicate
    id."""
    x, q = _blobs(13, 16, 24, 12_000, 96, 2.0)
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=24, m=2, kmeans_iters=6,
                                      replicate=True), device="cpu")
    assert idx.replicated
    sp = ts.SpillCNNSIndex(idx, hbm_budget_bytes=8 * _slab_nbytes(idx),
                           group_pad=4)
    qt = torch.from_numpy(q)
    sd, si = sp.search(qt, k=10, nprobe=6)
    rd, ri = idx.search(qt, k=10, nprobe=6)
    assert torch.equal(si, ri)
    np.testing.assert_allclose(sd.numpy(), rd.numpy(), **TOL)
    assert all(len(np.unique(r[r >= 0])) == (r >= 0).sum()
               for r in si.numpy()), "duplicate ids in deduped spill results"
    assert sp.stats.transfer_rounds >= 2


def test_budget_too_small_raises():
    x = np.random.default_rng(12).standard_normal((2_000, 16)).astype(
        np.float32)
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=8, m=1, kmeans_iters=3),
                        device="cpu")
    with pytest.raises(ValueError, match="below one 4-slab group"):
        ts.SpillCNNSIndex(idx, hbm_budget_bytes=1, group_pad=4)


@pytest.mark.parametrize("rep", [False, True])
def test_spill_matches_jax_spill(tmp_path, rep):
    """A JAX-built index cross-loaded into the port: the two packages'
    SpillCNNSIndex give the same ids (distances within TOL) and the same
    stats, field by field, with the same group size."""
    x, q = _blobs(11, 32, 32, 20_000, 128, 2.5)
    ji = jc.build_cnns(x, CNNSConfig(n_clusters=48, m=2, kmeans_iters=6,
                                     replicate=rep))
    p = str(tmp_path / "s.npz")
    ji.save(p)
    ji, ti = jc.CNNSIndex.load(p), tc.CNNSIndex.load(p, device="cpu")
    budget = 10 * _slab_nbytes(ti)
    jsp = js.SpillCNNSIndex(ji, budget, group_pad=4)
    tsp = ts.SpillCNNSIndex(ti, budget, group_pad=4)
    assert (tsp.group_size, tsp.slab_bytes) == (jsp.group_size,
                                                jsp.slab_bytes)
    for nprobe in (2, 6):
        jd, jid = jsp.search(q, k=10, nprobe=nprobe)
        td, tid = tsp.search(torch.from_numpy(q), k=10, nprobe=nprobe)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert tsp.stats == ts.SpillStats(**vars(jsp.stats))
    assert tsp.stats.transfer_rounds >= 4


def test_sq8_spill_pad_slots_stay_pad_dist(tmp_path):
    """F-R2's spill half and F-H5: an SQ8 index at qscale >= 2 whose
    results hold unfilled slots (k above what one probed cluster holds)
    returns PAD_DIST there, not inf, and finite distances everywhere;
    the same slots as the JAX package's spill search."""
    x, q = _blobs(31, 20, 16, 300, 8, 4.0)
    x, q = x * 100, q * 100
    ji = jc.build_cnns(x, CNNSConfig(n_clusters=16, m=2, kmeans_iters=4),
                       slab_dtype=jnp.int8)
    p = str(tmp_path / "sq8.npz")
    ji.save(p)
    ti = tc.CNNSIndex.load(p, device="cpu")
    assert ti.qscale >= 2.0 and ti.data_c.dtype == torch.int8
    budget = 4 * (_slab_nbytes(ti) + 2 * 4 * ti.maxc)
    tsp = ts.SpillCNNSIndex(ti, budget, group_pad=4)
    td, tid = tsp.search(torch.from_numpy(q), k=48, nprobe=1)
    pad = tid < 0
    assert pad.any()
    assert bool((td[pad] == float(PAD_DIST)).all())
    assert bool(torch.isfinite(td).all())
    jd, jid = js.SpillCNNSIndex(jc.CNNSIndex.load(p), budget,
                                group_pad=4).search(q, k=48, nprobe=1)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    rd, ri = ti.search(torch.from_numpy(q), k=48, nprobe=1, group=False)
    assert torch.equal(tid, ri)


def test_spill_index_lets_the_resident_index_go():
    """The spill index keeps copies of the slabs, ids and norms and the
    router's state only: once the caller drops the resident index, its
    slab tensor is freed, and the spill index still searches."""
    x, q = _blobs(12, 8, 16, 3_000, 16, 3.0)
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=8, m=2, kmeans_iters=3),
                        device="cpu")
    qt = torch.from_numpy(q)
    want = idx.search(qt, k=5, nprobe=3, group=False)
    sp = ts.SpillCNNSIndex(idx, hbm_budget_bytes=4 * 4 * _slab_nbytes(idx),
                           group_pad=4)
    refs = [weakref.ref(t) for t in (idx.data_c, idx.ids_c, idx.cnorms_c)]
    del idx
    gc.collect()
    assert all(r() is None for r in refs)
    got = sp.search(qt, k=5, nprobe=3)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
