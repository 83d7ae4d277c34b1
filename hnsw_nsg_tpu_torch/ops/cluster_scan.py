"""Grouped cluster scan with fused exact top-k
(counterpart of hnsw_nsg_tpu/ops/pallas_scan.py:244-537).

Three entry points with the JAX package's signatures, one CUDA kernel
(``csrc/grouped_scan.cu``) behind all three:

  * ``grouped_cluster_topk_gq(qc, qidx, slabs, bias, k, scale)``: for each
    cluster c, the query rows ``qc[qidx[c]]`` (zero where qidx < 0) are
    scored ``dist = bias[c] - scale * (q . slabs[c]^T)`` and reduced to
    the k smallest per row, ascending, ties to the lowest slot;
  * ``grouped_cluster_topk_gq_dblk``: the same function (the TPU blocked d
    to fit VMEM; the kernel's d loop serves every d);
  * ``grouped_cluster_topk(qv, slabs, bias, k, scale)``: the same from
    pre-gathered query rows qv [C, cap, d].

Each returns (vals [C, cap, k] f32, idx [C, cap, k] int32 local slots).

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version beside each wrapper (``*_reference``); CUDA tensors launch
the kernel, or the wrapper raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .distance import f32_dots

# kernel launches made by the wrappers of this module (CUDA tensors only)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (query dtype, slab dtype) pairs of pallas_scan.py:_dots
_PAIRS = {
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.int8),
    (torch.bfloat16, torch.int8),
}
MAX_K = 32


def _check(qc, qidx, slabs, bias, k):
    if (qc.dtype, slabs.dtype) not in _PAIRS:
        raise TypeError(
            f"unsupported (query, slab) dtypes ({qc.dtype}, {slabs.dtype})")
    if qc.ndim != 2 or slabs.ndim != 3 or qidx.ndim != 2 or bias.ndim != 2:
        raise ValueError("expected qc [qn, d], qidx [C, cap], "
                         "slabs [C, maxc, d], bias [C, maxc]")
    c, maxc, d = slabs.shape
    if qc.shape[1] != d or qidx.shape[0] != c or tuple(bias.shape) != (c, maxc):
        raise ValueError(
            f"shape mismatch: qc {tuple(qc.shape)}, qidx {tuple(qidx.shape)}, "
            f"slabs {tuple(slabs.shape)}, bias {tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    if not 1 <= k <= min(MAX_K, maxc):
        raise ValueError(f"k={k} outside [1, min({MAX_K}, maxc={maxc})]")


def _on_cpu(*ts) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: "
                     f"{[str(t.device) for t in ts]}")


def _launch(qc, qidx, slabs, bias, k: int, scale: float):
    """Run the CUDA kernel on device tensors. Raises on anything it does
    not take, and if the launch reports a CUDA error."""
    global launches
    from ._build import load_library

    if qidx.dtype != torch.int32:
        raise TypeError("qidx must be int32")
    for name, t in (("qc", qc), ("qidx", qidx), ("slabs", slabs),
                    ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    c, cap = qidx.shape
    qn, d = qc.shape
    maxc = slabs.shape[1]
    vals = torch.empty((c, cap, k), dtype=torch.float32, device=qc.device)
    idx = torch.empty((c, cap, k), dtype=torch.int32, device=qc.device)
    if c == 0 or cap == 0 or qn == 0:
        return vals.fill_(float("inf")), idx.zero_()
    lib = load_library()
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    rc = lib.grouped_scan(
        qc.data_ptr(), qidx.data_ptr(), slabs.data_ptr(), bias.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), c, cap, qn, d, maxc, k,
        float(scale), _DTYPE_CODE[qc.dtype], _DTYPE_CODE[slabs.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"grouped_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return vals, idx


# ---- plain PyTorch versions -------------------------------------------------

def _dots_reference(q, s, dblk: int | None = None):
    """q [C, cap, d] x s [C, maxc, d]^T -> f32 [C, cap, maxc] with the
    arithmetic of pallas_scan.py:_dots. int8 x int8 is summed exactly in
    float64 (every partial sum is an integer far below 2^53) and then
    rounded to f32, as the TPU's s32 sum is. The other pairs are f32 sums
    of exact products. ``dblk`` sums the contraction in d blocks, in the
    order of the d-blocked TPU kernel."""
    if q.dtype == torch.int8 and s.dtype == torch.int8:
        return torch.matmul(q.double(), s.double().transpose(1, 2)).float()
    if dblk is None or dblk >= q.shape[-1]:
        return f32_dots(q, s)
    acc = None
    for d0 in range(0, q.shape[-1], dblk):
        part = f32_dots(q[..., d0 : d0 + dblk], s[..., d0 : d0 + dblk])
        acc = part if acc is None else acc + part
    return acc


def _select_reference(dots, bias, k: int, scale: float):
    dist = bias[:, None, :] - scale * dots
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32)


def _gather_queries(qc, qidx):
    qv = qc[qidx.clamp(min=0).long()]
    return qv.masked_fill((qidx < 0)[..., None], 0)


def grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k: int,
                                      scale: float):
    """Plain version of grouped_cluster_topk_gq: gather, f32 product (exact
    integer sums for int8 x int8), bias, stable sort."""
    _check(qc, qidx, slabs, bias, k)
    dots = _dots_reference(_gather_queries(qc, qidx), slabs)
    return _select_reference(dots, bias, k, scale)


def grouped_cluster_topk_gq_dblk_reference(qc, qidx, slabs, bias, k: int,
                                           scale: float, dblk: int = 256):
    """Plain version of grouped_cluster_topk_gq_dblk (d summed in blocks)."""
    _check(qc, qidx, slabs, bias, k)
    dots = _dots_reference(_gather_queries(qc, qidx), slabs, dblk=dblk)
    return _select_reference(dots, bias, k, scale)


def grouped_cluster_topk_reference(qv, slabs, bias, k: int, scale: float):
    """Plain version of grouped_cluster_topk (pre-gathered qv [C, cap, d])."""
    c, cap, d = qv.shape
    _check(qv.reshape(c * cap, d), torch.zeros((c, cap), dtype=torch.int32),
           slabs, bias, k)
    return _select_reference(_dots_reference(qv, slabs), bias, k, scale)


# ---- wrappers ---------------------------------------------------------------

def grouped_cluster_topk_gq(qc, qidx, slabs, bias, k: int, scale: float):
    """qc [qn, d], qidx [C, cap] (-1 pad), slabs [C, maxc, d], bias [C, maxc]
    f32 (+inf on pad slots) -> (vals, idx) [C, cap, k]. Rows with qidx < 0
    carry unspecified results the caller must mask."""
    if _on_cpu(qc, qidx, slabs, bias):
        return grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                 scale)
    _check(qc, qidx, slabs, bias, k)
    return _launch(qc, qidx, slabs, bias, k, scale)


def grouped_cluster_topk_gq_dblk(qc, qidx, slabs, bias, k: int, scale: float,
                                 dblk: int = 256):
    """grouped_cluster_topk_gq for large d. On the card it is the same
    kernel (its d loop replaces the TPU's grid-blocked d); ``dblk`` only
    sets the summation blocks of the plain version."""
    if _on_cpu(qc, qidx, slabs, bias):
        return grouped_cluster_topk_gq_dblk_reference(
            qc, qidx, slabs, bias, k, scale, dblk)
    _check(qc, qidx, slabs, bias, k)
    return _launch(qc, qidx, slabs, bias, k, scale)


def grouped_cluster_topk(qv, slabs, bias, k: int, scale: float):
    """Per-(cluster, query-slot) exact top-k from pre-gathered rows
    qv [C, cap, d]. On the card: the gq kernel with
    ``qc = qv.reshape(C * cap, d)`` and ``qidx[c, j] = c * cap + j``."""
    if _on_cpu(qv, slabs, bias):
        return grouped_cluster_topk_reference(qv, slabs, bias, k, scale)
    c, cap, d = qv.shape
    qc = qv.reshape(c * cap, d)
    qidx = torch.arange(c * cap, dtype=torch.int32,
                        device=qv.device).reshape(c, cap)
    _check(qc, qidx, slabs, bias, k)
    return _launch(qc, qidx, slabs, bias, k, scale)
