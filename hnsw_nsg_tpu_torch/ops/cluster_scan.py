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
the kernel, or the wrapper raises. Any 1 <= k <= maxc is taken, as by
the JAX functions. Every kernel runs on one ring pipeline (the slab
streamed through a cp.async ring); the kernel goes by the dtype pair, d
and k alone (``scan_kernel``), each pair of kernels one for k <=
``MAX_K`` = 32 and one above:

  * a bf16 query with a bf16 or an int8 slab (SQ8) up to
    d = ``MAX_D_BF16`` = 1920 on bf16 tensor cores, ``scan_mma`` and
    ``scan_general_mma``;
  * int8 x int8 (uint8 data stored shift-by-128) up to d = ``MAX_D_I8`` =
    3840 on s8 tensor cores, exact s32 sums, ``scan_i8`` and
    ``scan_general_i8``;
  * f32 x f32 up to d = ``MAX_D_F32`` = 960 in exact FMAs, ``scan_f32``
    and ``scan_general_f32``;
  * each pair past its width, ``scan_wide`` and ``scan_general_wide``: the
    same kernels, whose 32 query rows no longer fit shared memory beside
    the ring, so each ring stage carries their d chunk beside the slab's
    (the streamed mode; the same arithmetic, so f32 keeps its bits and
    int8 x int8 stays exact).

The kernels for k > 32 (``CNNSIndex.search``'s default k = 100) keep each
row's running k smallest in a buffer, in global scratch that the wrapper
allocates when k passes what shared memory holds. ``launches`` counts
kernel launches and ``launches_by_kernel`` splits them by those eight
names.

The cluster join of the kNN-graph builder lives here too, as in the JAX
package: ``cluster_join_topk(qv, stacks, bias, k, scale)`` scores every
member row of each cluster against the cluster's stacked candidate slabs
and returns the k smallest per-bucket minima. ``csrc/cluster_join.cu``
has one kernel a dtype, each for any k up to the bucket count: bf16 on
tensor cores (``join_mma_kernel``: 128 member rows a block while their
top-k heaps fit shared memory (k <= 110 at d <= 128), else 64, whose
heaps move to global scratch that the wrapper allocates past k = 285
(279 when d > 128)), f32 in exact FMAs on CUDA cores
(``join_f32_kernel``: 128 rows a block, 8 x 8 register tiles as in an
SGEMM, slices of all +inf bias skipped, per-row heaps in shared memory
up to k = 107 at d <= 128 (140 above) and in global scratch that the
wrapper allocates past that). ``join_launches`` counts the
join's launches and ``join_launches_by_kernel`` splits them by kernel
name. The TPU's row-chunk shrink for scoped VMEM (pallas_scan.py:197-200)
is not carried over; the bucket rule (``join_group``) is, because it
decides which slots can come back.
"""

from __future__ import annotations

from collections import Counter

import torch

from .distance import f32_dots

# kernel launches made by the wrappers of this module (CUDA tensors only):
# the grouped scan and the cluster join, each also by kernel
launches = 0
launches_by_kernel: Counter = Counter()        # scan kernel name -> launches
join_launches = 0
join_launches_by_kernel: Counter = Counter()   # kernel name -> launches

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (query dtype, slab dtype) pairs of pallas_scan.py:_dots
_PAIRS = {
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.int8),
    (torch.bfloat16, torch.int8),
}
MAX_K = 32          # the heap kernels' k; the general kernels take any k
# the widest d whose query tile (32 rows of up to 3,840 bytes) stays in
# shared memory; wider d streams it through the ring (the wide kernels)
MAX_D_BF16 = 1920   # a bf16 query (bf16 or SQ8 int8 slabs), tensor cores
MAX_D_I8 = 3840     # int8 x int8, s8 tensor cores
MAX_D_F32 = 960     # f32 x f32, exact FMAs


def scan_kernel(q_dtype, s_dtype, d: int, k: int) -> str:
    """The name of the scan kernel that a (query, slab) dtype pair, d and
    k launch on the card, the rule of ``csrc/grouped_scan.cu``'s entry
    points."""
    if (q_dtype == torch.bfloat16 and s_dtype in (torch.bfloat16, torch.int8)
            and d <= MAX_D_BF16):
        names = ("scan_mma", "scan_general_mma")
    elif q_dtype == s_dtype == torch.int8 and d <= MAX_D_I8:
        names = ("scan_i8", "scan_general_i8")
    elif q_dtype == s_dtype == torch.float32 and d <= MAX_D_F32:
        names = ("scan_f32", "scan_general_f32")
    else:   # any pair past its width: the query streamed through the ring
        names = ("scan_wide", "scan_general_wide")
    return names[k > MAX_K]


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
    if not 1 <= k <= maxc:
        raise ValueError(f"k={k} outside [1, maxc={maxc}]")


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
    from ._build import load_library, scratch

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
    ptrs = (qc.data_ptr(), qidx.data_ptr(), slabs.data_ptr(),
            bias.data_ptr(), vals.data_ptr(), idx.data_ptr())
    shape = (c, cap, qn, d, maxc, k, float(scale), _DTYPE_CODE[qc.dtype],
             _DTYPE_CODE[slabs.dtype], stream)
    if k > MAX_K:
        buf, buf_ptr = scratch(lib.grouped_scan_general_scratch(
            c, cap, d, k, *shape[-3:-1]), qc.device)
        rc = lib.grouped_scan_general(*ptrs, buf_ptr, *shape)
    else:
        rc = lib.grouped_scan(*ptrs, *shape)
    if rc != 0:
        raise RuntimeError(f"grouped_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_by_kernel[scan_kernel(qc.dtype, slabs.dtype, d, k)] += 1
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
    f32 (+inf on pad slots) -> (vals, idx) [C, cap, k], 1 <= k <= maxc.
    Rows with qidx < 0 carry unspecified results the caller must mask."""
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


# ---- cluster join (kNN-graph build) ----------------------------------------

_JOIN_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
JOIN_KERNELS = {torch.float32: "join_f32_kernel",
                torch.bfloat16: "join_mma_kernel"}


def join_group(mm: int, k: int) -> int:
    """The bucket width of the join (pallas_scan.py:189-193): the largest
    group <= 8 dividing mm that leaves >= 25 k buckets, which caps the
    expected loss from two top-k slots sharing a bucket at ~2% of k."""
    group = 1
    while group < 8 and mm // (group * 2) >= 25 * k and mm % (group * 2) == 0:
        group *= 2
    return group


def _check_join(qv, stacks, bias, k):
    if qv.dtype != stacks.dtype or qv.dtype not in _JOIN_DTYPE_CODE:
        raise TypeError(f"qv/stacks must both be float32 or bfloat16, got "
                        f"({qv.dtype}, {stacks.dtype})")
    if qv.ndim != 3 or stacks.ndim != 3 or bias.ndim != 2:
        raise ValueError("expected qv [C, maxc, d], stacks [C, mm, d], "
                         "bias [C, mm]")
    c, _, d = qv.shape
    mm = stacks.shape[1]
    if (stacks.shape[0] != c or stacks.shape[2] != d
            or tuple(bias.shape) != (c, mm)):
        raise ValueError(f"shape mismatch: qv {tuple(qv.shape)}, stacks "
                         f"{tuple(stacks.shape)}, bias {tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    g = mm // join_group(mm, k)
    if not 1 <= k <= g:
        raise ValueError(f"k={k} outside [1, buckets={g}]")


def cluster_join_topk_reference(qv, stacks, bias, k: int, scale: float,
                                cluster_chunk: int | None = None):
    """Plain version of cluster_join_topk: f32 products, per-bucket minima
    (``min`` returns the first, i.e. lowest e, on ties), stable sort of the
    bucket minima. Runs ``cluster_chunk`` clusters at a time (default: a
    ~512 MB f32 distance block), since the whole [C, maxc, mm] block does
    not fit at build shapes."""
    _check_join(qv, stacks, bias, k)
    c, maxc, _ = qv.shape
    mm = stacks.shape[1]
    group = join_group(mm, k)
    g = mm // group
    chunk = cluster_chunk or max(1, (512 << 20) // (4 * maxc * mm))
    vals = torch.empty((c, maxc, k), dtype=torch.float32, device=qv.device)
    idx = torch.empty((c, maxc, k), dtype=torch.int32, device=qv.device)
    for s in range(0, c, chunk):
        e = min(s + chunk, c)
        dist = bias[s:e, None, :] - scale * f32_dots(qv[s:e], stacks[s:e])
        bmin, be = dist.view(e - s, maxc, group, g).min(dim=2)
        v, b = torch.sort(bmin, dim=-1, stable=True)
        b = b[..., :k]
        vals[s:e] = v[..., :k]
        idx[s:e] = (torch.gather(be, -1, b) * g + b).to(torch.int32)
    return vals, idx


def join_block_rows(d: int, k: int, dtype) -> int:
    """Member rows a block of the join kernel that (d, k, dtype) launches:
    128 or 64 on tensor cores (bf16), 128 on CUDA cores (f32). Needs the
    card's library."""
    from ._build import load_library

    return load_library().cluster_join_rows(d + (-d % 8), k,
                                            _JOIN_DTYPE_CODE[dtype])


def _launch_join(qv, stacks, bias, k: int, scale: float):
    global join_launches
    from ._build import load_library, scratch

    for name, t in (("qv", qv), ("stacks", stacks), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qv.dtype == torch.bfloat16:
        # the tensor-core kernel copies 16-byte row pieces: pad d to a
        # multiple of 8 with zeros (no dot changes) and align the bases
        pad = -qv.shape[2] % 8
        if pad:
            qv = torch.nn.functional.pad(qv, (0, pad))
            stacks = torch.nn.functional.pad(stacks, (0, pad))
        qv, stacks = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (qv, stacks))
    c, maxc, d = qv.shape
    mm = stacks.shape[1]
    vals = torch.empty((c, maxc, k), dtype=torch.float32, device=qv.device)
    idx = torch.empty((c, maxc, k), dtype=torch.int32, device=qv.device)
    if c == 0 or maxc == 0:
        return vals, idx
    lib = load_library()
    group = join_group(mm, k)
    ptrs = (qv.data_ptr(), stacks.data_ptr(), bias.data_ptr(),
            vals.data_ptr(), idx.data_ptr())
    code = _JOIN_DTYPE_CODE[qv.dtype]
    buf, buf_ptr = scratch(lib.cluster_join_scratch(c, maxc, d, k, code),
                           qv.device)
    rc = lib.cluster_join(*ptrs, buf_ptr, c, maxc, d, mm, k, group,
                          float(scale), code,
                          torch.cuda.current_stream(qv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cluster_join kernel launch failed: CUDA error {rc}")
    join_launches += 1
    join_launches_by_kernel[JOIN_KERNELS[qv.dtype]] += 1
    return vals, idx


def cluster_join_topk(qv, stacks, bias, k: int, scale: float):
    """qv [C, maxc, d] member rows, stacks [C, mm, d] stacked candidate
    slabs (same dtype, f32 or bf16), bias [C, mm] f32 (+inf on pads) ->
    (vals, idx) [C, maxc, k]: per row, the k smallest of the per-bucket
    minima of ``bias - scale * <row, slot>``, ascending, idx = the slot.
    Entries past the finite buckets are +inf; their idx are the buckets
    whose every slot has an infinite bias, lowest first, as the plain
    version gives them (with finite products)."""
    if _on_cpu(qv, stacks, bias):
        return cluster_join_topk_reference(qv, stacks, bias, k, scale)
    _check_join(qv, stacks, bias, k)
    return _launch_join(qv, stacks, bias, k, scale)
