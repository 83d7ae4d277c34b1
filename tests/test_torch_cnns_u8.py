"""uint8 rows and queries through the port's CNNS path (models/cnns.py):
``build_cnns`` on a uint8 array builds the index of the same values as
f32, uint8 queries answer as f32 queries of the same values, the answers
at every slab are the exact top-k of the benchmark's uint8 reference
(annbench/references/exact_knn_u8.py), which agrees with a float64 brute
force, and the index equals the JAX package's build of the f32 values."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from annbench import spec  # noqa: E402
from hnsw_nsg_tpu.models import cnns as jc  # noqa: E402
from hnsw_nsg_tpu.utils.params import CNNSConfig as JCNNSConfig  # noqa: E402
from hnsw_nsg_tpu_torch.models import cnns as tc  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig  # noqa: E402

ref = spec.load_module("references", "exact_knn_u8")

N, NQ, D = 3000, 64, 128
CFG = dict(n_clusters=12, m=4, kmeans_iters=5)
FIELDS = ("data_c", "ids_c", "cnorms_c", "reps", "flat_adj")
# name -> (slab dtype, replicate, local index)
BUILDS = {
    "int8_rep": (torch.int8, True, "flat"),
    "int8": (torch.int8, False, "flat"),
    "bf16_rep": (torch.bfloat16, True, "flat"),
    "f32": (torch.float32, False, "flat"),
    "int8_nsg": (torch.int8, False, "nsg"),
}


@pytest.fixture(scope="module")
def draws():
    """Raw f32 draws of a Gaussian mixture (as the benchmark draws them)
    and their uint8 map: (x, q, xu, qu), torch tensors."""
    g = torch.Generator().manual_seed(2024)
    centers = torch.randn((10, D), generator=g)
    x = centers[torch.randint(0, 10, (N,), generator=g)] + torch.randn(
        (N, D), generator=g)
    q = centers[torch.randint(0, 10, (NQ,), generator=g)] + torch.randn(
        (NQ, D), generator=g)
    return x, q, ref.uint8_rows(x), ref.uint8_rows(q)


_built = {}


def _build(draws, name, rows):
    """The index ``name`` over ``rows`` ("u8": the numpy uint8 array,
    "u8_tensor": the uint8 tensor, "f32": its values as f32), built
    once a module."""
    key = (name, rows)
    if key not in _built:
        xu = draws[2]
        data = {"u8": xu.numpy(), "u8_tensor": xu,
                "f32": xu.numpy().astype(np.float32)}[rows]
        sdt, rep, local = BUILDS[name]
        _built[key] = tc.build_cnns(
            data, CNNSConfig(replicate=rep, **CFG), slab_dtype=sdt,
            local_index=local, device="cpu")
    return _built[key]


def _same(a, b):
    """Equal dtype, shape and bits."""
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("rows", ["u8", "u8_tensor"])
@pytest.mark.parametrize("name", list(BUILDS))
def test_uint8_rows_build_the_index_of_their_f32_values(draws, name, rows):
    a, b = _build(draws, name, rows), _build(draws, name, "f32")
    for f in FIELDS:
        assert _same(getattr(a, f), getattr(b, f)), f
    np.testing.assert_array_equal(a.sizes, b.sizes)
    np.testing.assert_array_equal(a.qshift, b.qshift)
    assert (a.qscale, a.n_real, a.replicated) == (b.qscale, b.n_real,
                                                  b.replicated)
    assert a.qshift == (128.0 if BUILDS[name][0] == torch.int8 else 0.0)
    if name == "int8_nsg":
        np.testing.assert_array_equal(a.eps_flat, b.eps_flat)


# (index, group, router, the queries' form)
SEARCHES = {
    "int8_grouped": ("int8_rep", True, "flat", "tensor"),
    "int8_per_query": ("int8_rep", False, "flat", "tensor"),
    "int8_numpy": ("int8_rep", None, "flat", "numpy"),
    "int8_hnsw_router": ("int8", True, "hnsw", "tensor"),
    "int8_one_row": ("int8", False, "flat", "row"),
    "int8_nsg": ("int8_nsg", None, "flat", "tensor"),
    "bf16_grouped": ("bf16_rep", True, "flat", "tensor"),
    "f32_per_query": ("f32", False, "flat", "tensor"),
}


@pytest.mark.parametrize("case", list(SEARCHES))
def test_uint8_queries_answer_as_f32_queries(draws, case):
    name, group, router, form = SEARCHES[case]
    idx = _build(draws, name, "u8")
    qu = draws[3]
    if form == "row":
        qu = qu[5]
    q8 = qu.numpy() if form == "numpy" else qu
    kw = dict(k=10, nprobe=4, group=group, router=router)
    d8, i8 = idx.search(q8, **kw)
    d32, i32 = idx.search(qu.float(), **kw)
    assert torch.equal(i8, i32)
    assert torch.equal(d8.view(torch.int32), d32.view(torch.int32))


def test_uint8_queries_reach_the_scan_as_int8(draws, monkeypatch):
    idx = _build(draws, "int8_rep", "u8")
    seen = []
    scan = tc.grouped_cluster_topk_gq

    def spy(qc, *a, **kw):
        seen.append(qc)
        return scan(qc, *a, **kw)

    monkeypatch.setattr(tc, "grouped_cluster_topk_gq", spy)
    qu = draws[3]
    idx.search(qu, k=10, nprobe=4, group=True)
    assert seen[0].dtype == torch.int8
    assert torch.equal(seen[0], (qu.to(torch.int16) - 128).to(torch.int8))


@pytest.mark.parametrize("group", [True, False])
def test_every_slab_gives_the_exact_top_k_of_the_reference(draws, group):
    """At nprobe = every slab the answers are exact: the distances equal
    the reference's exact top-k distances, and each id is at its own
    distance (so ids differ only among ties at the k-th distance)."""
    x, q, _, qu = draws
    idx = _build(draws, "int8_rep", "u8")
    dd, ii = idx.search(qu, k=10, nprobe=idx.n_real, group=group)
    gt = ref.topk(x, q, 10, "l2")
    d_gt, _ = ref.pair_dists(x, q, gt, "l2")
    d_own, _ = ref.pair_dists(x, q, ii.long(), "l2")
    assert bool((ii >= 0).all())
    assert torch.equal(dd.double(), d_gt)
    assert torch.equal(dd.double(), d_own)


def test_the_reference_agrees_with_a_float64_brute_force(draws):
    x, q, xu, qu = draws
    a = xu.numpy().astype(np.float64)
    b = qu.numpy().astype(np.float64)
    full = ((b[:, None, :] - a[None, :, :]) ** 2).sum(-1)
    exact = np.sort(full, axis=1)[:, :10]
    gt = ref.topk(x, q, 10, "l2").numpy()
    np.testing.assert_array_equal(
        np.take_along_axis(full, gt, axis=1), exact)
    dist, scale = ref.pair_dists(x, q, torch.from_numpy(gt), "l2")
    np.testing.assert_array_equal(dist.numpy(), exact)
    np.testing.assert_allclose(
        scale.numpy(), np.linalg.norm(b, axis=1)[:, None]
        * np.linalg.norm(a[gt], axis=2), rtol=1e-12)
    # the control's search over unquantized rows is the exact search
    sd, si = ref.search(xu.float(), q, 10, "l2")
    np.testing.assert_array_equal(sd.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("replicate", [False, True])
def test_uint8_build_equals_the_jax_build_of_its_f32_values(draws,
                                                            replicate):
    xu = draws[2].numpy()
    ji = jc.build_cnns(xu.astype(np.float32),
                       JCNNSConfig(replicate=replicate, **CFG),
                       slab_dtype=jnp.int8)
    ti = _build(draws, "int8_rep" if replicate else "int8", "u8")
    assert ji.qshift == ti.qshift == 128.0 and ji.qscale == ti.qscale
    np.testing.assert_array_equal(np.asarray(ji.reps), ti.reps.numpy())
    jd, jids = np.asarray(ji.data_c), np.asarray(ji.ids_c)
    td, tids = ti.data_c.numpy(), ti.ids_c.numpy()
    if replicate:
        # two replicas at one distance may take their pad slots in the
        # other order (ties in the replica fill): each slab holds the same
        # (id, row) pairs, in the slot order of its ids
        jo = np.argsort(jids, axis=1, kind="stable")
        to = np.argsort(tids, axis=1, kind="stable")
        jids, tids = (np.take_along_axis(a, o, 1)
                      for a, o in ((jids, jo), (tids, to)))
        jd, td = (np.take_along_axis(a, o[:, :, None], 1)
                  for a, o in ((jd, jo), (td, to)))
    np.testing.assert_array_equal(jids, tids)
    np.testing.assert_array_equal(jd, td)
