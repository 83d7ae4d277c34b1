"""Tensor ops of the PyTorch port (counterpart of hnsw_nsg_tpu/ops)."""

from .bruteforce import brute_force_topk, recall
from .distance import (
    PAD_DIST, PAD_ID, as_f32_queries, pairwise_dists, squared_norms,
)
from .topk import topk_smallest

__all__ = [
    "PAD_DIST", "PAD_ID", "as_f32_queries", "brute_force_topk",
    "pairwise_dists", "recall", "squared_norms", "topk_smallest",
]
