"""Batched distances on tensors (counterpart of hnsw_nsg_tpu/ops/distance.py).

Metric conventions follow the JAX package:
  * ``l2``     — squared L2;
  * ``ip``     — ``1 - <a, b>``;
  * ``cosine`` — ``ip`` over pre-normalized vectors.

FastL2 (``d = ||x||^2 - 2<q, x>``, per-query constant ``||q||^2``
dropped) is monotone per query, so every top-k is unaffected by it.

Matmul precision. JAX contracts bf16 operands with
``preferred_element_type=f32``: exact products, f32 sums. ``torch.matmul``
on bf16 tensors instead RETURNS bf16, which would round every distance to
8 mantissa bits. So every product here upcasts its operands to f32 first
(a bf16 or int8 value is exact in f32) and multiplies in f32 with TF32
off, matching the reference's arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

# Large-but-finite sentinel for padded / invalid distances (finite so that
# arithmetic stays NaN-free; anything real is strictly smaller).
PAD_DIST = np.float32(3.4e37)
# Sentinel id for padded slots.
PAD_ID = -1

VALID_METRICS = ("l2", "ip", "cosine")


def exact_f32_matmul() -> None:
    """Turn TF32 off for f32 products on the card. TF32 keeps ~3 decimal
    digits: an "exact" f32 scan or ground truth would silently return
    approximate distances (the Hopper analogue of the TPU MXU truncating
    f32 operands to bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_f32_queries(queries, device=None) -> torch.Tensor:
    """A query batch as an f32 [Q, d] tensor on ``device`` (default: where
    a tensor already lies, else the CPU). A tensor already on the device
    is not copied through the host."""
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=device, dtype=torch.float32)
    else:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        q = q.to(device) if device is not None else q
    if q.ndim == 1:
        q = q[None]
    return q


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-row squared L2 norm, computed in f32. x: [..., d] -> [...]."""
    xf = x.float()
    return (xf * xf).sum(-1)


def f32_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., m, d] x b [..., n, d]^T -> f32 [..., m, n]: operands upcast
    to f32 (exact for bf16 and int8 values), product in f32 without TF32.
    Every product of the port outside its kernel goes through here, so the
    brute-force ground truth and f32 slabs are true fp32 (F-H1)."""
    exact_f32_matmul()
    return torch.matmul(a.float(), b.float().transpose(-1, -2))


def pairwise_dists(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2",
    x_norms: torch.Tensor | None = None,
    exact: bool = True,
) -> torch.Tensor:
    """All-pairs distances, [Q, d] x [N, d] -> f32 [Q, N].

    With ``exact=False`` and metric="l2" the per-query constant ``||q||^2``
    is dropped (FastL2): ordering per query is unchanged."""
    if metric not in VALID_METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dots = f32_dots(q, x)
    if metric in ("ip", "cosine"):
        return 1.0 - dots
    if x_norms is None:
        x_norms = squared_norms(x)
    d = x_norms[None, :] - 2.0 * dots
    if exact:
        d = d + squared_norms(q)[:, None]
    return d
