"""The per-query probe path's scoring (``models/cnns.py``
``_flat_probe_search``) as one hand-written kernel pair on the card.

``probe_topk(qc, visit, data_c, ids_c, cnorms, qnorm, k, metric)``
returns, for each query row of ``qc`` [Q, d] (bf16), the k smallest
distances to the live rows of its probed slabs ``data_c[visit[q, j]]``
(``data_c`` [C, maxc, d] bf16, ``visit`` [Q, npr] cluster ids, PAD_ID
padded) with their global ids (``ids_c`` [C, maxc] int32): f32 [Q, k]
ascending and int32 [Q, k], equal values in the order of (probe slot,
row), PAD_DIST and PAD_ID past the live rows. l2 is ``(cnorms - 2 dot) +
qnorm`` (``cnorms`` [C, maxc] and ``qnorm`` [Q], f32), ip and cosine
``1 - dot`` (both may be None).

Dispatch is by what the slabs show (``on_kernel``): bf16 slabs on the
card launch ``csrc/probe_scan.cu``; everything else, the CPU and f32 and
int8 slabs, takes the plain version (``probe_topk_reference``: each probe
slot's slabs gathered, an f32 product of the upcast values without TF32, a
stable running merge). On the card each probed slab is read where it lies:
``probe_scan`` takes a (pair, row split) a block, in the order of the
pairs sorted by cluster (one ``argsort`` on the card, no host sync), and
sums in f32 FMAs of exact bf16 products, so a distance differs from the
plain one only by the order of its sum; ``probe_merge`` folds each
query's items into its k best. ``launches_by_kernel`` counts both
kernels' launches by name (``probe_scan``, ``probe_merge``).
"""

from __future__ import annotations

from collections import Counter

import torch

from .cluster_scan import _on_cpu
from .distance import PAD_DIST, PAD_ID, VALID_METRICS, f32_dots
from .topk import topk_smallest

# kernel launches made by probe_topk, by kernel name
launches_by_kernel: Counter = Counter()
# the query dtypes each slab dtype takes (``models/cnns.py`` ``_cast_q``)
_QUERY_DTYPES = {torch.bfloat16: (torch.bfloat16,),
                 torch.float32: (torch.float32,),
                 torch.int8: (torch.int8, torch.bfloat16)}


def on_kernel(data_c) -> bool:
    """Whether probe_topk scores these slabs with the kernel: bf16 slabs
    on the card."""
    return data_c.is_cuda and data_c.dtype == torch.bfloat16


def slab_dist(qe, xe, metric, nrm=None):
    """Per-row distances of qe [B, d] to its own slab xe [B, maxc, d]:
    FastL2 (``nrm - 2 dots``) or ``1 - dots``. Operands upcast to f32
    (exact for int8 and bf16 values), product in f32 without TF32, as the
    JAX package's einsum with an f32 result (``_einsum_operands``)."""
    dots = f32_dots(qe[:, None, :], xe)[:, 0, :]
    if metric in ("ip", "cosine"):
        return 1.0 - dots
    return nrm - 2.0 * dots


def _check(qc, visit, data_c, ids_c, cnorms, qnorm, k: int,
           metric: str) -> bool:
    """Raises on what neither version takes; returns whether the tensors
    lie on the CPU."""
    if metric not in VALID_METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if qc.ndim != 2 or visit.ndim != 2 or data_c.ndim != 3 or ids_c.ndim != 2:
        raise ValueError("expected qc [Q, d], visit [Q, npr], "
                         "data_c [C, maxc, d], ids_c [C, maxc]")
    c, maxc, d = data_c.shape
    if (qc.shape[1] != d or visit.shape[0] != qc.shape[0]
            or tuple(ids_c.shape) != (c, maxc)):
        raise ValueError(f"shape mismatch: qc {tuple(qc.shape)}, visit "
                         f"{tuple(visit.shape)}, data_c {tuple(data_c.shape)}, "
                         f"ids_c {tuple(ids_c.shape)}")
    if qc.dtype not in _QUERY_DTYPES.get(data_c.dtype, ()):
        raise TypeError(f"{data_c.dtype} slabs take no {qc.dtype} queries")
    if visit.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"visit must be int32 or int64, got {visit.dtype}")
    if ids_c.dtype != torch.int32:
        raise TypeError(f"ids_c must be int32, got {ids_c.dtype}")
    if metric == "l2":
        if cnorms is None or qnorm is None:
            raise ValueError("l2 needs cnorms and qnorm")
    for name, t, shape in (("cnorms", cnorms, (c, maxc)),
                           ("qnorm", qnorm, (qc.shape[0],))):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if k < 1:
        raise ValueError(f"k={k} below 1")
    return _on_cpu(*(t for t in (qc, visit, data_c, ids_c, cnorms, qnorm)
                     if t is not None))


def probe_topk_reference(qc, visit, data_c, ids_c, cnorms, qnorm, k: int,
                         metric: str):
    """Plain version of probe_topk, for any slab dtype: a loop over probe
    slots, each gathering the slot's slabs, their distances (``slab_dist``)
    and a stable merge into the running top-k."""
    _check(qc, visit, data_c, ids_c, cnorms, qnorm, k, metric)
    b, dev = qc.shape[0], qc.device
    best_d = torch.full((b, k), float(PAD_DIST), device=dev)
    best_i = torch.full((b, k), PAD_ID, dtype=ids_c.dtype, device=dev)
    for j in range(visit.shape[1]):
        cid = visit[:, j]
        ok = cid >= 0
        safe = torch.where(ok, cid, 0)
        ic = ids_c[safe]                             # [B, maxc]
        nrm = cnorms[safe] if metric == "l2" else None
        d = slab_dist(qc, data_c[safe], metric, nrm)
        if metric == "l2":
            d = d + qnorm[:, None]
        valid = (ic >= 0) & ok[:, None]
        d = torch.where(valid, d, PAD_DIST)
        ic = torch.where(valid, ic, PAD_ID)
        best_d, best_i = topk_smallest(
            torch.cat([best_d, d], 1), torch.cat([best_i, ic], 1), k)
    return best_d, best_i


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(qc, visit, data_c, ids_c, cnorms, qnorm, k: int, scale: float):
    from ._build import load_library, scratch

    for name, t in (("qc", qc), ("data_c", data_c), ("ids_c", ids_c),
                    ("cnorms", cnorms), ("qnorm", qnorm)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    qn, npr = visit.shape
    c, maxc, d = data_c.shape
    dev = qc.device
    out_d = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    if qn == 0:
        return out_d, out_i
    if npr == 0:
        return out_d.fill_(PAD_DIST), out_i.fill_(PAD_ID)
    visit = visit.to(torch.int64).contiguous()
    # the scan's block order: the pairs sorted by cluster, so that the
    # pairs of one slab run side by side (PAD pairs first: they exit)
    order = torch.argsort(visit.reshape(-1))
    lib = load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = lib.probe_scan_rows(qn * npr, maxc, d, sms)
    buf, buf_ptr = scratch(lib.probe_scan_scratch(qn, npr, maxc, k, rows),
                           dev)
    rc = lib.probe_scan(qc.data_ptr(), _ptr(qnorm), visit.data_ptr(),
                        order.data_ptr(), data_c.data_ptr(), ids_c.data_ptr(),
                        _ptr(cnorms), out_d.data_ptr(), out_i.data_ptr(),
                        buf_ptr, qn, npr, c, maxc, d, k, rows, float(scale),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_scan kernel launch failed: CUDA error {rc}")
    launches_by_kernel["probe_scan"] += 1
    launches_by_kernel["probe_merge"] += 1
    return out_d, out_i


def probe_topk(qc, visit, data_c, ids_c, cnorms, qnorm, k: int, metric: str):
    """qc [Q, d], visit [Q, npr], data_c [C, maxc, d], ids_c [C, maxc]
    int32, cnorms [C, maxc] and qnorm [Q] f32 (l2; else None) -> (f32
    [Q, k], int32 [Q, k]): each query's k nearest live rows of its probed
    slabs, ascending, ties by (probe slot, row), PAD past them. bf16 slabs
    on the card launch the kernel, all else takes the plain version."""
    on_cpu = _check(qc, visit, data_c, ids_c, cnorms, qnorm, k, metric)
    if on_cpu or not on_kernel(data_c):
        return probe_topk_reference(qc, visit, data_c, ids_c, cnorms, qnorm,
                                    k, metric)
    l2 = metric == "l2"
    return _launch(qc, visit, data_c, ids_c, cnorms if l2 else None,
                   qnorm if l2 else None, k, 2.0 if l2 else 1.0)
