"""Tensor ops of the PyTorch port (counterpart of hnsw_nsg_tpu/ops)."""

from .bruteforce import (brute_force_topk, brute_force_topk_approx,
                         knn_graph_exact, recall)
from .distance import (
    PAD_DIST, PAD_ID, as_f32_queries, exact_from_fast, gathered_dists,
    normalize, pairwise_dists, point_dists, squared_norms,
)
from .topk import (
    empty_retset, init_retset, mask_internal_dups, merge_into_retset,
    merge_into_retset_sorted, topk_smallest,
)

__all__ = [
    "PAD_DIST", "PAD_ID", "as_f32_queries", "brute_force_topk",
    "brute_force_topk_approx",
    "empty_retset", "exact_from_fast", "gathered_dists", "init_retset",
    "knn_graph_exact", "mask_internal_dups", "merge_into_retset",
    "merge_into_retset_sorted", "normalize", "pairwise_dists", "point_dists", "recall",
    "squared_norms", "topk_smallest",
]
