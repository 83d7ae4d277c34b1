"""Row-wise top-k with the JAX package's tie order
(counterpart of hnsw_nsg_tpu/ops/topk.py:topk_smallest).

``jax.lax.top_k`` returns equal values in index order. ``torch.topk`` does
not promise any order among ties, so the port selects with a stable sort:
among equal distances the earlier position wins, as in the reference.
"""

from __future__ import annotations

import torch


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Row-wise k smallest (dist, id) pairs, sorted ascending; ties keep
    their position order."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    idx = idx[..., :k]
    return vals[..., :k], torch.gather(ids, -1, idx)
