"""The grouped cluster scan of the PyTorch port vs the JAX package's Pallas
kernels (interpret mode on the CPU), and the wrapper's dispatch rules.

On the CPU the wrappers take the plain PyTorch versions; the CUDA kernel
is compared with them on the card by tests/test_torch_cuda.py and by
chip_smoke.py."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.ops import pallas_scan as jps  # noqa: E402
from hnsw_nsg_tpu_torch.ops import cluster_scan as cs  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)   # f32 sums in another order

_J = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
_T = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
# (query dtype, slab dtype) pairs of pallas_scan.py:_dots
PAIRS = [("f32", "f32"), ("bf16", "bf16"), ("int8", "int8"),
         ("bf16", "int8")]


def _case(seed, qd, sd, metric, c=4, cap=16, maxc=64, d=32, qn=50):
    """numpy inputs: rows rounded to the dtype they are stored in (so both
    packages see the same values), ragged valid slots, -1 query pads."""
    rng = np.random.default_rng(seed)

    def vals(shape, dt):
        if dt == "int8":
            return rng.integers(-128, 128, shape).astype(np.int8)
        v = rng.standard_normal(shape).astype(np.float32)
        if dt == "bf16":
            v = np.asarray(jnp.asarray(v).astype(jnp.bfloat16), np.float32)
        return v

    qc = vals((qn, d), qd)
    slabs = vals((c, maxc, d), sd)
    valid = rng.random((c, maxc)) < 0.8
    valid[-1] = False                         # an all-pad cluster
    if metric == "l2":
        base = (slabs.astype(np.float32) ** 2).sum(-1)
        scale = 2.0
    else:
        base = np.ones((c, maxc), np.float32)
        scale = 1.0
    bias = np.where(valid, base, np.inf).astype(np.float32)
    qidx = rng.integers(0, qn, (c, cap)).astype(np.int32)
    qidx[rng.random((c, cap)) < 0.2] = -1
    return qc, qidx, slabs, bias, scale


def _to_j(a, dt):
    return jnp.asarray(a).astype(_J[dt]) if dt != "int8" else jnp.asarray(a)


def _to_t(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(_T[dt])


def _compare(got, want, qidx, bf16, full):
    """vals allclose on live rows; ids equal where the reference value is
    finite — in bf16, a differing id must be a tie within tolerance (its
    own distance equals the reference value at that rank)."""
    tv, ti = (t.numpy() for t in got)
    jv, ji = (np.asarray(a) for a in want)
    live = np.broadcast_to((qidx >= 0)[:, :, None], jv.shape)
    fin = live & np.isfinite(jv)
    np.testing.assert_array_equal(np.isinf(tv[live]), np.isinf(jv[live]))
    np.testing.assert_allclose(tv[fin], jv[fin], **TOL)
    if not bf16:
        np.testing.assert_array_equal(ti[fin], ji[fin])
    else:
        own = np.take_along_axis(full, ti.astype(np.int64), axis=2)
        np.testing.assert_allclose(own[fin], jv[fin], **TOL)


def _full(qc, qidx, slabs, bias, scale):
    qv = np.where((qidx >= 0)[:, :, None], qc[np.maximum(qidx, 0)], 0)
    dots = np.einsum("cjd,cmd->cjm", qv.astype(np.float64),
                     slabs.astype(np.float64))
    return bias[:, None, :] - scale * dots


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qd,sd", PAIRS)
def test_gq_plain_matches_pallas(qd, sd, metric):
    qc, qidx, slabs, bias, scale = _case(10, qd, sd, metric)
    want = jps.grouped_cluster_topk_gq(
        _to_j(qc, qd), jnp.asarray(qidx), _to_j(slabs, sd),
        jnp.asarray(bias), 10, scale, interpret=True)
    got = cs.grouped_cluster_topk_gq(
        _to_t(qc, qd), torch.from_numpy(qidx), _to_t(slabs, sd),
        torch.from_numpy(bias), 10, scale)
    _compare(got, want, qidx, "bf16" in (qd, sd),
             _full(qc, qidx, slabs, bias, scale))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qd,sd", PAIRS)
def test_gq_dblk_plain_matches_pallas(qd, sd, metric):
    qc, qidx, slabs, bias, scale = _case(11, qd, sd, metric, d=40)
    want = jps.grouped_cluster_topk_gq_dblk(
        _to_j(qc, qd), jnp.asarray(qidx), _to_j(slabs, sd),
        jnp.asarray(bias), 10, scale, dblk=16, interpret=True)
    got = cs.grouped_cluster_topk_gq_dblk(
        _to_t(qc, qd), torch.from_numpy(qidx), _to_t(slabs, sd),
        torch.from_numpy(bias), 10, scale, dblk=16)
    _compare(got, want, qidx, "bf16" in (qd, sd),
             _full(qc, qidx, slabs, bias, scale))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qd,sd", PAIRS)
def test_pregathered_plain_matches_pallas(qd, sd, metric):
    qc, qidx, slabs, bias, scale = _case(12, qd, sd, metric)
    qidx[:] = np.abs(qidx)                     # every slot live
    qv = qc[qidx]
    want = jps.grouped_cluster_topk(
        _to_j(qv, qd), _to_j(slabs, sd), jnp.asarray(bias), 10, scale,
        interpret=True)
    got = cs.grouped_cluster_topk(
        _to_t(qv, qd), _to_t(slabs, sd), torch.from_numpy(bias), 10, scale)
    _compare(got, want, qidx, "bf16" in (qd, sd),
             _full(qc, qidx, slabs, bias, scale))


def test_cpu_wrapper_takes_plain_path_and_counts_nothing():
    qc, qidx, slabs, bias, scale = _case(13, "f32", "f32", "l2")
    args = (torch.from_numpy(qc), torch.from_numpy(qidx),
            torch.from_numpy(slabs), torch.from_numpy(bias), 10, scale)
    before = cs.launches
    got = cs.grouped_cluster_topk_gq(*args)
    want = cs.grouped_cluster_topk_gq_reference(*args)
    assert cs.launches == before == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    qc, qidx, slabs, bias, scale = _case(14, "f32", "f32", "l2")
    t = (torch.from_numpy(qc), torch.from_numpy(qidx),
         torch.from_numpy(slabs), torch.from_numpy(bias))
    with pytest.raises(TypeError):        # f32 queries x int8 slabs
        cs.grouped_cluster_topk_gq(t[0], t[1], t[2].to(torch.int8), t[3],
                                   10, scale)
    with pytest.raises(ValueError):       # k above the kernel's 32
        cs.grouped_cluster_topk_gq(*t, 33, scale)
    with pytest.raises(ValueError):       # bias shape
        cs.grouped_cluster_topk_gq(t[0], t[1], t[2], t[3][:, :-1], 10, scale)
    with pytest.raises(ValueError):       # a device the port has no path for
        cs.grouped_cluster_topk_gq(t[0].to("meta"), *t[1:], 10, scale)


def test_port_imports_without_jax_or_triton():
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)
        sys.modules["jax"] = None
        sys.modules["triton"] = None
        import hnsw_nsg_tpu_torch
        import hnsw_nsg_tpu_torch.ops.cluster_scan
        import hnsw_nsg_tpu_torch.ops._build
        import hnsw_nsg_tpu_torch.models.cnns
        import hnsw_nsg_tpu_torch.utils.synth
        bad = [m for m in set(sys.modules) - before
               if sys.modules[m] is not None and m.split(".")[0] in ("jax", "jaxlib", "triton",
                                      "hnsw_nsg_tpu")]
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr

