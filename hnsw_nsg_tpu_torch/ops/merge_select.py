"""Fused retset merge + frontier select, the graph hop's kernel
(counterpart of hnsw_nsg_tpu/ops/merge_select.py).

``fused_merge_select(r_d, r_i, r_e, c_d, c_i, expand)`` is, bit for bit::

    r_d, r_i, r_e = merge_into_retset(r_d, r_i, r_e, c_d, c_i)
    sel_ids, sel_valid, r_e = _select_frontier(r_i, r_e, expand)

including the tie order (retset before candidates, then position), the
PAD_DIST/PAD_ID handling and PAD_ID in invalid select slots. CPU tensors
take that composition (``merge_select_reference``); CUDA tensors launch
one of the two hand-written kernels of ``csrc/merge_select.cu``, or the
wrapper raises:

  * L <= ``MAX_L`` = 1024 and C <= ``MAX_C`` = 1024: a warp per query,
    the retset ids in the lanes' registers (up to 32 a lane), every
    candidate broadcast and compared with them, a rank sort of the kept
    candidates, a merge path;
  * anything wider (an HNSW search with ``ef`` above 1024, a beam whose
    expand * R passes 1024): the general kernel, a block of
    ceil(max(L, C) / 8) threads per query, each holding 8 retset ids in
    registers and comparing every candidate with them; the arrays in
    shared memory, or in global scratch that this wrapper allocates when
    they pass the 227 KB a block may have (L above ~25,000 at C = 50).
    Any L and C are taken, as by the JAX function.

``launches`` counts the launches of both, ``launches_by_shape`` splits
the same count by (Q, L, C, expand) and ``general_launches`` is the
general kernel's share.

Not carried over from the TPU wrapper, none of which changes a result:
the power-of-two padding of L + C and the 16-bit position/expanded
packing that its bitonic network needed, the scoped-VMEM block budget,
and the padding of Q to a block multiple (the kernel masks its ragged
last block).
"""

from __future__ import annotations

from collections import Counter

import torch

from .cluster_scan import _on_cpu
from .topk import merge_into_retset

# kernel launches made by fused_merge_select (CUDA tensors only)
launches = 0
launches_by_shape: Counter = Counter()   # (Q, L, C, expand) -> launches
general_launches = 0                     # of them, the general kernel's
MAX_L, MAX_C = 1024, 1024                # the warp-per-query kernel


def merge_select_reference(r_d, r_i, r_e, c_d, c_i, expand: int):
    """The plain composition the kernel replaces (CPU path and oracle)."""
    from ..models.beam import _select_frontier

    r_d, r_i, r_e = merge_into_retset(r_d, r_i, r_e, c_d, c_i)
    sel_ids, sel_valid, r_e = _select_frontier(r_i, r_e, expand)
    return r_d, r_i, r_e, sel_ids, sel_valid


def _check(r_d, r_i, r_e, c_d, c_i, expand: int):
    want = ((r_d, torch.float32), (r_i, torch.int32), (r_e, torch.bool),
            (c_d, torch.float32), (c_i, torch.int32))
    for name, (t, dt) in zip(("r_d", "r_i", "r_e", "c_d", "c_i"), want):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-d tensor")
    q, l = r_d.shape
    if r_i.shape != (q, l) or r_e.shape != (q, l):
        raise ValueError("r_d, r_i, r_e must share one [Q, L] shape")
    if c_d.shape != c_i.shape or c_d.shape[0] != q:
        raise ValueError("c_d, c_i must share one [Q, C] shape")
    if not 1 <= expand <= l:
        raise ValueError(f"expand={expand} outside [1, L={l}]")


def _launch(r_d, r_i, r_e, c_d, c_i, expand: int):
    global launches, general_launches
    from ._build import load_library, scratch

    q, l = r_d.shape
    dev = r_d.device
    o_d = torch.empty((q, l), dtype=torch.float32, device=dev)
    o_i = torch.empty((q, l), dtype=torch.int32, device=dev)
    o_e = torch.empty((q, l), dtype=torch.bool, device=dev)
    sel_i = torch.empty((q, expand), dtype=torch.int32, device=dev)
    sel_v = torch.empty((q, expand), dtype=torch.bool, device=dev)
    if q == 0:
        return o_d, o_i, o_e, sel_i, sel_v
    lib = load_library()
    c = c_d.shape[1]
    ptrs = (r_d.data_ptr(), r_i.data_ptr(), r_e.data_ptr(), c_d.data_ptr(),
            c_i.data_ptr(), o_d.data_ptr(), o_i.data_ptr(), o_e.data_ptr(),
            sel_i.data_ptr(), sel_v.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    general = l > MAX_L or c > MAX_C
    if general:
        buf, buf_ptr = scratch(q * lib.merge_select_general_scratch(l, c),
                               dev)
        rc = lib.merge_select_general(*ptrs, buf_ptr, q, l, c, expand,
                                      stream)
    else:
        rc = lib.merge_select(*ptrs, q, l, c, expand, stream)
    if rc != 0:
        raise RuntimeError(f"merge_select kernel launch failed: CUDA error {rc}")
    launches += 1
    general_launches += general
    launches_by_shape[(q, l, c, expand)] += 1
    return o_d, o_i, o_e, sel_i, sel_v


def occupancy(l: int, c: int) -> int:
    """Queries (warps) that one SM holds at once for retset width ``l`` and
    ``c`` candidates, as the CUDA runtime reports it for the launch of the
    warp-per-query kernel (L <= 1024, C <= 1024). Needs the card."""
    from ._build import load_library

    warps = load_library().merge_select_occupancy(l, c)
    if warps < 0:
        raise RuntimeError(f"merge_select occupancy query failed ({warps})")
    return warps


def fused_merge_select(r_d, r_i, r_e, c_d, c_i, expand: int):
    """Merge candidates into the sorted retset and select the next frontier.

    r_d/r_i/r_e: [Q, L] retset (f32 ascending, int32 PAD-padded, bool
    expanded). c_d/c_i: [Q, C] candidates (PAD_ID and duplicates allowed).
    Returns (r_d, r_i, r_e, sel_ids [Q, expand], sel_valid [Q, expand])."""
    if _on_cpu(r_d, r_i, r_e, c_d, c_i):
        return merge_select_reference(r_d, r_i, r_e, c_d, c_i, expand)
    _check(r_d, r_i, r_e, c_d, c_i, expand)
    return _launch(r_d, r_i, r_e, c_d, c_i, expand)
