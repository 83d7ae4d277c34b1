"""The flat router's representative product and selection
(``models/cnns.py`` ``_route_clusters``) as one kernel on the card.

``route_topk(q, reps, bias, n_rep, n_real, scale)`` returns, for each
query row of ``q`` [Q, d] (bf16), the ``n_rep`` columns j of the flat
representatives ``reps`` [n, d] (bf16) with the smallest
``bias[j] - scale * <q, reps[j]>`` (bias [n] f32), int64 [Q, n_rep], in
the order of a stable sort of the row: ascending, equal values by the
lower column, NaN after every number. Columns at or past ``n_real`` (the
representatives of slab-count padding clusters, F-H2) read ``PAD_DIST``
whatever their product.

Dispatch is by the device of the tensors: CPU tensors take the plain
version (``route_topk_reference``: an f32 product of the bf16 values
without TF32, one rounding in ``torch.add(bias, dots, alpha=-scale)``, a
stable sort); CUDA tensors launch ``csrc/route.cu``, or the wrapper
raises. There the products run on bf16 tensor cores with f32 sums, so
a distance differs from the plain one only by the order of its sum, and
the selection keeps each query row's running ``n_rep`` best in the
GEMM's epilogue, so the [Q, n] distance block never leaves the chip: a
sorted list a row across a warp's lanes for ``n_rep`` <= 32,
``select_topk.cuh``'s buffers above. The columns are split over blocks to
fill the card; where there is more than one split, a second launch
merges the splits' lists. ``launches`` counts both kernels' launches and
``launches_by_kernel`` splits them by name (``route_topk``,
``route_merge``).
"""

from __future__ import annotations

from collections import Counter

import torch

from .cluster_scan import _on_cpu
from .distance import PAD_DIST, f32_dots
from .topk import topk_smallest

# kernel launches made by route_topk (CUDA tensors only)
launches = 0
launches_by_kernel: Counter = Counter()   # kernel name -> launches


def _check(q, reps, bias, n_rep: int, n_real: int):
    if q.dtype != torch.bfloat16 or reps.dtype != torch.bfloat16:
        raise TypeError(f"q and reps must be bfloat16, got ({q.dtype}, "
                        f"{reps.dtype})")
    if bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    if q.ndim != 2 or reps.ndim != 2 or bias.ndim != 1:
        raise ValueError("expected q [Q, d], reps [n, d], bias [n]")
    n = reps.shape[0]
    if q.shape[1] != reps.shape[1] or bias.shape[0] != n:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, reps "
                         f"{tuple(reps.shape)}, bias {tuple(bias.shape)}")
    if not 1 <= n_rep <= n:
        raise ValueError(f"n_rep={n_rep} outside [1, n={n}]")
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real={n_real} outside [0, n={n}]")


def route_topk_reference(q, reps, bias, n_rep: int, n_real: int,
                         scale: float):
    """Plain version of route_topk: the arithmetic of the router's plain
    path (``pairwise_dists`` on the bf16 values, FastL2 or ``1 - dot``)."""
    _check(q, reps, bias, n_rep, n_real)
    dots = f32_dots(q, reps)
    dist = torch.add(bias[None, :], dots, alpha=-scale)
    col = torch.arange(reps.shape[0], device=q.device)
    if n_real < reps.shape[0]:
        dist = torch.where(col[None, :] >= n_real, PAD_DIST, dist)
    return topk_smallest(dist, col.expand(q.shape[0], -1), n_rep)[1]


def _launch(q, reps, bias, n_rep: int, n_real: int, scale: float):
    global launches
    from ._build import load_library, scratch

    for name, t in (("q", q), ("reps", reps), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    qn, d = q.shape
    out = torch.empty((qn, n_rep), dtype=torch.int64, device=q.device)
    if qn == 0:
        return out
    # past the real columns only the first n_rep padding ones can be taken
    n_cols = min(reps.shape[0], n_real + n_rep)
    lib = load_library()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = lib.route_topk_splits(qn, n_cols, sms)
    buf, buf_ptr = scratch(
        lib.route_topk_scratch(qn, n_cols, n_rep, splits), q.device)
    rc = lib.route_topk(q.data_ptr(), reps.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), buf_ptr, qn, d, n_real, n_cols,
                        n_rep, splits, float(scale),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"route_topk kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_by_kernel["route_topk"] += 1
    if splits > 1:
        launches += 1
        launches_by_kernel["route_merge"] += 1
    return out


def route_topk(q, reps, bias, n_rep: int, n_real: int, scale: float):
    """q [Q, d] bf16, reps [n, d] bf16, bias [n] f32 -> int64 [Q, n_rep]:
    each row's n_rep columns of smallest ``bias - scale * q . reps^T``,
    ascending, ties to the lower column, columns >= n_real at PAD_DIST."""
    _check(q, reps, bias, n_rep, n_real)
    if _on_cpu(q, reps, bias):
        return route_topk_reference(q, reps, bias, n_rep, n_real, scale)
    return _launch(q, reps, bias, n_rep, n_real, scale)
