"""Random-projection-tree kNN-graph initialisation, EFANNA's tree stage
(counterpart of hnsw_nsg_tpu/models/rptree.py).

Reference: ``IndexKDtree`` (CNNS/efanna_graph/src/index_kdtree.cpp)
builds TreeNum randomised KD-trees (:23-74) and merges their leaves'
candidate sets into an initial kNN graph, which nn-descent then refines.

As in the JAX package the trees are balanced random-projection trees:

  * each level projects every point on one random direction and
    median-splits every segment, one stable sort by (segment,
    projection), so segments stay contiguous and exactly balanced;
  * after ``levels`` rounds the permutation lays the leaves out
    contiguously, and a leaf's all-pairs distances are one batched product
    over [leaf, leaf] tiles, with no gathers in the loop;
  * each tree's leaf top-k merges into the running pools with the sorted
    retset merge; ``nn_descent(init_adj=...)`` polishes the result
    (RefineGraph, index_graph.cpp:235-262).

The leaf products round the rows to bf16 and sum in f32, as the JAX
package does: the stage only proposes candidates. Its top-k is an exact
stable top-k (ties to the lower position) at every leaf width, where the
JAX package takes ``jax.lax.approx_max_k`` at leaves of 256 rows and
more: that is TPU scaffolding, dropped. The projection directions are
drawn by the caller of ``_rp_permutation`` (``knn_graph_rp`` from a
``torch.Generator`` seeded by ``seed``), so the trees differ from the
JAX package's, whose directions come from ``jax.random``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.distance import PAD_DIST, PAD_ID, f32_dots, squared_norms
from ..ops.topk import empty_retset, merge_into_retset_sorted, topk_smallest
from ..utils.params import NNDescentConfig
from .nndescent import nn_descent
from .nsg import _as_tensor


def _rp_permutation(data: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """The leaf layout of one tree: at level ``lvl`` the rows in the
    current order are projected on ``vecs[lvl]`` (f32 products) and
    stably sorted by (segment, projection), 2**lvl segments of equal size.
    Returns perm [N] (int64) such that perm reshaped [n_leaves, leaf]
    gives contiguous balanced leaves."""
    n = data.shape[0]
    dev = data.device
    perm = torch.arange(n, device=dev)
    pos = torch.arange(n, device=dev)
    for lvl in range(vecs.shape[0]):
        proj = f32_dots(data[perm], vecs[lvl][None])[:, 0]
        seg = pos // (n >> lvl)
        # lexsort by (seg, proj): a stable sort by the minor key, then by
        # the major one
        o = torch.sort(proj, stable=True).indices
        o = o[torch.sort(seg[o], stable=True).indices]
        perm = perm[o]
    return perm


def _leaf_topk_impl(data: torch.Tensor, perm: torch.Tensor, leaf: int,
                    k: int, metric: str, group: int):
    """Each leaf's all-pairs distances (bf16 rows, f32 sums; l2 norms from
    the f32 rows), self masked, and each row's min(k, leaf - 1) nearest by
    an exact stable top-k; ``group`` leaves a product. Returns (dists,
    global ids) [N, min(k, leaf - 1)] in the original row order."""
    n, d = data.shape
    n_leaves = n // leaf
    kk = min(k, leaf - 1)
    gids = perm.reshape(n_leaves, leaf)
    out_d = torch.empty((n, kk), device=data.device)
    out_i = torch.empty((n, kk), dtype=torch.int32, device=data.device)
    eye = torch.eye(leaf, dtype=torch.bool, device=data.device)
    for g in range(0, n_leaves, group):
        gb = gids[g : g + group]                      # [G, leaf]
        xb = data[gb]                                 # [G, leaf, d]
        xh = xb.to(torch.bfloat16)
        dots = f32_dots(xh, xh)
        if metric in ("ip", "cosine"):
            dist = 1.0 - dots
        else:
            nrm = squared_norms(xb)
            dist = nrm[:, :, None] + nrm[:, None, :] - 2.0 * dots
        dist = torch.where(eye, PAD_DIST, dist)
        cols = torch.arange(leaf, device=data.device).expand_as(dist)
        vals, idx = topk_smallest(dist, cols, kk)
        ids = torch.gather(gb[:, None, :].expand(-1, leaf, -1), 2, idx)
        rows = gb.reshape(-1)
        out_d[rows] = vals.reshape(-1, kk)
        out_i[rows] = ids.reshape(-1, kk).to(torch.int32)
    return out_d, out_i


def knn_graph_rp(
    data,
    k: int,
    metric: str = "l2",
    n_trees: int = 8,
    leaf_size: int = 1024,
    seed: int = 0,
    group: int = 8,
    refine: NNDescentConfig | None = None,
    pool_width: int | None = None,
    verbose: bool = False,
    refine_chunk: int = 4096,
    device=None,
    stats: dict | None = None,
) -> np.ndarray:
    """Approximate kNN graph from merged rp-tree leaves, optionally refined
    by nn-descent warm-started from it (EFANNA's tree + descent pipeline).
    Returns int32 [N, k] (numpy).

    data: numpy (placed on ``device``, default the card) or a tensor (used
    where it lies). N is padded to n_leaves x leaf with copies of row 0,
    which never become neighbours. ``n_trees`` trees with independent
    directions; recall grows with them. When ``stats`` is a dict it gets
    the wall seconds of the trees (``rp_trees``) and of the refinement
    (``nndescent``)."""
    x = _as_tensor(data, device, torch.float32)
    dev = x.device
    n_real, d = x.shape
    width = pool_width or k
    t0 = time.perf_counter()

    levels = max(int(np.floor(np.log2(max(n_real // leaf_size, 1)))), 0)
    n_leaves = 1 << levels
    leaf = -(-n_real // n_leaves)
    leaf = ((leaf + 7) // 8) * 8
    n = n_leaves * leaf
    xp = torch.cat([x, x[:1].expand(n - n_real, d)]) if n != n_real else x
    while n_leaves % group:
        group //= 2
    group = max(group, 1)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    r_d, r_i, r_e = empty_retset(n, width, dev)
    for t in range(n_trees):
        vecs = torch.randn((levels, d), generator=gen, device=dev)
        perm = _rp_permutation(xp, vecs)
        c_d, c_i = _leaf_topk_impl(xp, perm, leaf, k, metric, group)
        # padded copies of row 0 must not become neighbours of real rows
        c_i = torch.where(c_i >= n_real, PAD_ID, c_i)
        c_d = torch.where(c_i < 0, PAD_DIST, c_d)
        r_d, r_i, r_e = merge_into_retset_sorted(r_d, r_i, r_e, c_d, c_i)
        if verbose:
            print(f"rp-tree {t + 1}/{n_trees} merged")
    adj = r_i[:n_real, :k]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    if stats is not None:
        stats["rp_trees"] = t1 - t0
    if refine is None:
        return adj.cpu().numpy()
    adj = nn_descent(x, refine, metric=metric, seed=seed + 1, init_adj=adj,
                     verbose=verbose, chunk=refine_chunk)
    if stats is not None:
        stats["nndescent"] = time.perf_counter() - t1
    return adj
