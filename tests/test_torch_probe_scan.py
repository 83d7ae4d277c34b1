"""The per-query probe path's scoring on the CPU (``ops/probe_scan.py``):
the plain version ``probe_topk`` takes for CPU tensors, the path
``_flat_probe_search`` chooses, ``probe_counts``, the wrapper's checks,
the spill index that runs the same path, and the JAX package's answers
in ``tests/data/probe_jax_ref.npz``. The kernel itself is held to the
plain version and to that file in ``tests/test_torch_cuda.py``."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu_torch.models import cnns as tc  # noqa: E402
from hnsw_nsg_tpu_torch.models import spill as ts  # noqa: E402
from hnsw_nsg_tpu_torch.ops import probe_scan  # noqa: E402
from hnsw_nsg_tpu_torch.ops.distance import (  # noqa: E402
    PAD_DIST, PAD_ID, f32_dots, squared_norms)
from hnsw_nsg_tpu_torch.ops.topk import topk_smallest  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig  # noqa: E402


def _parents_flat_probe_search(q, visit, data_c, ids_c, cnorms_c, k, metric,
                               q_block=2048, q_round=True):
    """``_flat_probe_search`` as it stood before the probe kernel, kept
    here so that the CPU path can be held to it bit for bit."""
    def slab_dist(qe, xe, nrm=None):
        dots = f32_dots(qe[:, None, :], xe)[:, 0, :]
        if metric in ("ip", "cosine"):
            return 1.0 - dots
        return nrm - 2.0 * dots

    out_d, out_i = [], []
    for s in range(0, q.shape[0], q_block):
        qf = q[s : s + q_block].float()
        vb = visit[s : s + q_block]
        b = qf.shape[0]
        qn = (squared_norms(qf) if metric == "l2"
              else torch.zeros(b, device=q.device))
        qc = tc._cast_q(qf, data_c.dtype, q_round)
        best_d = torch.full((b, k), float(PAD_DIST), device=q.device)
        best_i = torch.full((b, k), PAD_ID, dtype=ids_c.dtype,
                            device=q.device)
        for j in range(vb.shape[1]):
            cid = vb[:, j]
            ok = cid >= 0
            safe = torch.where(ok, cid, 0)
            ic = ids_c[safe]
            nrm = cnorms_c[safe] if metric == "l2" else None
            d = slab_dist(qc, data_c[safe], nrm)
            if metric == "l2":
                d = d + qn[:, None]
            valid = (ic >= 0) & ok[:, None]
            d = torch.where(valid, d, PAD_DIST)
            ic = torch.where(valid, ic, PAD_ID)
            best_d, best_i = topk_smallest(
                torch.cat([best_d, d], 1), torch.cat([best_i, ic], 1), k)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def _probe_case(seed, qn, c, maxc, d, npr, slab_dtype, ties=False):
    """Slabs with dead rows and an all-dead cluster, queries, and visits
    with PAD slots, a query with no live slot and a repeated cluster."""
    rng = np.random.default_rng(seed)
    if slab_dtype == torch.int8:
        x = rng.integers(-20, 21, (c, maxc, d)).astype(np.float32)
        q = rng.integers(-20, 21, (qn, d)).astype(np.float32)
    else:
        x = rng.standard_normal((c, maxc, d)).astype(np.float32)
        q = rng.standard_normal((qn, d)).astype(np.float32)
    if ties:
        # exact ties: rows repeated within and across slabs
        x[1, 3] = x[1, 0]
        x[2, 5] = x[1, 0]
        x[:, 7] = x[0, 2]
    data_c = torch.from_numpy(x).to(slab_dtype)
    ids = rng.permutation(c * maxc).reshape(c, maxc).astype(np.int32)
    ids[rng.random((c, maxc)) < 0.2] = PAD_ID
    ids[c - 1] = PAD_ID
    ids_c = torch.from_numpy(ids)
    cnorms = squared_norms(data_c)
    visit = torch.from_numpy(np.stack(
        [rng.permutation(c)[:npr] for _ in range(qn)])).long()
    visit[rng.random((qn, npr)) < 0.2] = PAD_ID
    visit[0] = PAD_ID
    if npr > 1:
        visit[1] = PAD_ID
        visit[1, :2] = 2
    return torch.from_numpy(q), visit, data_c, ids_c, cnorms


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("slab_dtype,q_round", [
    (torch.float32, True), (torch.bfloat16, True), (torch.int8, True),
    (torch.int8, False)])
@pytest.mark.parametrize("k,npr,q_block", [(1, 3, 2048), (10, 4, 7),
                                           (20, 1, 2048), (200, 2, 16)])
def test_cpu_probe_search_is_the_parents(metric, slab_dtype, q_round, k, npr,
                                         q_block):
    """On the CPU _flat_probe_search gives the parent's dists and ids bit
    for bit, through PAD slots, dead rows, a repeated cluster, exact ties
    and a k past every live row."""
    q, visit, data_c, ids_c, cnorms = _probe_case(k + npr, 37, 6, 40, 24,
                                                  npr, slab_dtype,
                                                  ties=True)
    got = tc._flat_probe_search(q, visit, data_c, ids_c, cnorms, k, metric,
                                q_block=q_block, q_round=q_round)
    want = _parents_flat_probe_search(q, visit, data_c, ids_c, cnorms, k,
                                      metric, q_block=q_block,
                                      q_round=q_round)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def test_cpu_probe_search_counts_plain_pairs():
    q, visit, data_c, ids_c, cnorms = _probe_case(0, 9, 5, 16, 8, 3,
                                                  torch.bfloat16)
    before = dict(tc.probe_counts)
    tc._flat_probe_search(q, visit, data_c, ids_c, cnorms, 4, "l2",
                          q_block=4)
    assert tc.probe_counts["plain"] == before.get("plain", 0) + 9 * 3
    assert tc.probe_counts["kernel"] == before.get("kernel", 0)
    assert not probe_scan.launches_by_kernel


def test_probe_counts_count_the_per_query_path_alone():
    x = np.random.default_rng(2).standard_normal((3000, 16)).astype(
        np.float32)
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=64, m=2, kmeans_iters=2),
                        slab_dtype=torch.bfloat16, device="cpu")
    q = torch.from_numpy(x[:50])
    before = dict(tc.probe_counts)
    idx.search(q, k=5, nprobe=3, group=True)
    assert dict(tc.probe_counts) == before
    idx.search(q, k=5, nprobe=3, group=False)
    assert tc.probe_counts["plain"] - before.get("plain", 0) == 50 * 3


def test_probe_topk_on_cpu_is_the_plain_version_ties_by_slot_then_row():
    """probe_topk on CPU bf16 tensors is probe_topk_reference, the order
    the kernel is held to: ascending, equal values by (probe slot, row)
    (a repeated cluster's rows come twice, the earlier slot first), PAD
    past the live rows."""
    q, visit, data_c, ids_c, cnorms = _probe_case(5, 12, 5, 16, 8, 3,
                                                  torch.bfloat16, ties=True)
    qc, qn = q.to(torch.bfloat16), squared_norms(q)
    args = (qc, visit, data_c, ids_c, cnorms, qn, 60, "l2")
    got = probe_scan.probe_topk(*args)
    want = probe_scan.probe_topk_reference(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the query with every slot PAD: all padding
    assert bool((got[0][0] == PAD_DIST).all() and (got[1][0] == PAD_ID).all())
    # query 1 probes cluster 2 in slots 0 and 1: each live row twice, in
    # adjacent places, with one distance
    i1, d1 = got[1][1], got[0][1]
    live2 = ids_c[2][ids_c[2] >= 0]
    for gid in live2.tolist():
        at = (i1 == gid).nonzero()[:, 0]
        assert at.numel() == 2 and d1[at[0]] == d1[at[1]]
    # ties by (slot, row): wherever two neighbours are equal, the earlier
    # one's (slot, row) is the lower
    pos = {}
    for j in range(visit.shape[1]):
        cid = int(visit[3, j])
        if cid >= 0:
            for r in range(ids_c.shape[1]):
                pos.setdefault(int(ids_c[cid, r]), (j, r))
    d3, i3 = got[0][3], got[1][3]
    for a in range(59):
        if d3[a] == d3[a + 1] and i3[a + 1] >= 0:
            assert pos[int(i3[a])] < pos[int(i3[a + 1])]


@pytest.mark.parametrize("case,err", [
    ("query f32", TypeError), ("slabs f32", TypeError),
    ("ids int64", TypeError), ("visit float", TypeError),
    ("cnorms f64", TypeError), ("qnorm f64", TypeError),
    ("query width", ValueError), ("visit rows", ValueError),
    ("ids shape", ValueError), ("cnorms shape", ValueError),
    ("qnorm shape", ValueError), ("l2 without norms", ValueError),
    ("k 0", ValueError), ("metric", ValueError), ("query 3-d", ValueError),
    ("mixed devices", ValueError)])
def test_probe_topk_raises_on_what_it_does_not_take(case, err):
    q, visit, data_c, ids_c, cnorms = _probe_case(1, 6, 4, 8, 16, 2,
                                                  torch.bfloat16)
    qc, qn = q.to(torch.bfloat16), squared_norms(q)
    args = dict(qc=qc, visit=visit, data_c=data_c, ids_c=ids_c,
                cnorms=cnorms, qnorm=qn, k=3, metric="l2")
    bad = {"query f32": dict(qc=q),
           "slabs f32": dict(data_c=data_c.float()),
           "ids int64": dict(ids_c=ids_c.long()),
           "visit float": dict(visit=visit.float()),
           "cnorms f64": dict(cnorms=cnorms.double()),
           "qnorm f64": dict(qnorm=qn.double()),
           "query width": dict(qc=qc[:, :8]),
           "visit rows": dict(visit=visit[:5]),
           "ids shape": dict(ids_c=ids_c[:, :7]),
           "cnorms shape": dict(cnorms=cnorms[:3]),
           "qnorm shape": dict(qnorm=qn[:5]),
           "l2 without norms": dict(cnorms=None),
           "k 0": dict(k=0),
           "metric": dict(metric="hamming"),
           "query 3-d": dict(qc=qc[None]),
           "mixed devices": dict(qnorm=qn.to("meta"))}[case]
    with pytest.raises(err):
        probe_scan.probe_topk(**{**args, **bad})


@pytest.mark.parametrize("metric,replicate", [("l2", False), ("ip", True)])
def test_spill_search_on_cpu_is_the_parents(monkeypatch, metric, replicate):
    """SpillCNNSIndex on the CPU gives what it gave with the parent's
    per-query search, bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6000, 20)).astype(np.float32)
    if metric == "ip":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    idx = tc.build_cnns(x, CNNSConfig(n_clusters=24, m=2, kmeans_iters=3,
                                      replicate=replicate), metric=metric,
                        slab_dtype=torch.bfloat16, device="cpu")
    sp = ts.SpillCNNSIndex(idx, 6 * idx.data_c[0].numel() * 2, group_pad=2)
    q = torch.from_numpy(x[:40] + 0.1 * rng.standard_normal(
        (40, 20)).astype(np.float32))
    got = sp.search(q, k=10, nprobe=5)
    monkeypatch.setattr(ts, "_flat_probe_search", _parents_flat_probe_search)
    want = sp.search(q, k=10, nprobe=5)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


JAX_FIXTURE = pathlib.Path(__file__).parent / "data" / "probe_jax_ref.npz"


@pytest.mark.parametrize("metric,k", [(m, k) for m in ("l2", "ip")
                                      for k in (1, 10, 32, 200)])
def test_probe_fixture_is_the_jax_packages_flat_probe_search(metric, k):
    """``tests/data/probe_jax_ref.npz`` (``scripts/make_probe_jax_fixture.py``)
    holds what the JAX package's ``_flat_probe_search`` returns on the
    file's integer inputs, and the port's CPU path returns it bit for bit;
    the card's kernel is held to the same file in tests/test_torch_cuda.py."""
    spec = importlib.util.spec_from_file_location(
        "make_probe_jax_fixture", pathlib.Path(__file__).parent.parent
        / "scripts" / "make_probe_jax_fixture.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    f = np.load(JAX_FIXTURE)
    want_d, want_i = f[f"d_{metric}_{k}"], f[f"i_{metric}_{k}"]
    jd, ji = fixture.jax_outputs(f, metric, k)
    assert np.array_equal(jd.view(np.int32), want_d.view(np.int32))
    assert np.array_equal(ji, want_i)
    data_c = torch.from_numpy(f["slabs"].astype(np.float32)).to(
        torch.bfloat16)
    gd, gi = tc._flat_probe_search(
        torch.from_numpy(f["q"]), torch.from_numpy(f["visit"]), data_c,
        torch.from_numpy(f["ids"]), squared_norms(data_c), k, metric)
    assert np.array_equal(gd.numpy().view(np.int32), want_d.view(np.int32))
    assert np.array_equal(gi.numpy(), want_i)
