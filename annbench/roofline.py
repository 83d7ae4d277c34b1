"""The least time the card could take for a call: published peaks and the
operations and bytes of a grouped scan call, counted from its inputs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W limit). A scan's bytes count each input read once and each output
written once; of the slabs and their bias only those that a live query
row probes (a slab whose query list is all pad needs no byte). Its
operations are the products of its live query rows at the peak of their
(query, slab) type: exact f32 runs on CUDA cores (no TF32), int8 x int8
on int8 tensor cores, an int8 slab with a bf16 query as bf16.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_OPS = {
    ("float32", "float32"): 67e12,
    ("bfloat16", "bfloat16"): PEAK_BF16_FLOPS,
    ("int8", "int8"): 1979e12,
    ("bfloat16", "int8"): PEAK_BF16_FLOPS,
}
_SIZE = {"float32": 4, "bfloat16": 2, "int8": 1, "int32": 4}


def bound(n_bytes: float, flops: float = 0.0,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time in seconds for the work: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type.
    Returns (seconds, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(qn: int, d: int, c: int, cap: int, maxc: int, k: int,
               live_rows: int, probed_slabs: int, q_dtype: str,
               s_dtype: str) -> tuple[float, str]:
    """The bound of one grouped scan call: queries [qn, d] of ``q_dtype``,
    query lists [c, cap] int32 of which ``live_rows`` are live and
    ``probed_slabs`` lists hold a live row, slabs [c, maxc, d] of
    ``s_dtype`` with an f32 bias [c, maxc], and outputs of f32 values and
    int32 slots [c, cap, k]."""
    flops = 2.0 * live_rows * maxc * d
    n_bytes = (qn * d * _SIZE[q_dtype] + c * cap * 4
               + c * cap * k * (4 + 4)
               + probed_slabs * maxc * (d * _SIZE[s_dtype] + 4))
    return bound(n_bytes, flops, PEAK_OPS[(q_dtype, s_dtype)])
