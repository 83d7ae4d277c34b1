"""Cluster-join kNN-graph construction, the large-N build path
(counterpart of hnsw_nsg_tpu/models/knn_ivf.py).

The dataset is k-means-partitioned into padded cluster slabs (the CNNS
layout); each slab's member rows are scored against the concatenation of
its own and its (M-1) nearest slabs with ``cluster_join_topk``
(``ops/cluster_scan.py``, the CUDA kernel ``csrc/cluster_join.cu`` on a
card). A point's true neighbors lie in its own or a nearby cluster, so
recall tracks IVF recall at nprobe=M. Everything stays on the device of
the data; the host sees only the [N] assignment and the slab-id table.

Not carried over from the JAX package: the ``row_chunk`` and
``interpret`` switches (the join runs by the tensors' device; its VMEM
row chunking has no counterpart). The adjacency scatter filters the pad
rows with a mask where the TPU dropped them at a sentinel row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cluster_scan import cluster_join_topk
from ..ops.distance import PAD_DIST, PAD_ID, pairwise_dists, squared_norms
from ..utils.device import resolve_device
from .kmeans import kmeans


def _cluster_join(data_c, ids_c, cnorms_c, nbrs, k: int, metric: str):
    """For every slab's member rows, the top-k against the stacked slabs
    of its ``nbrs`` slabs. Returns (vals, global ids) [C, maxc, k]."""
    c, maxc, d = data_c.shape
    m = nbrs.shape[1]
    nb = nbrs.long()
    stack = data_c[nb].reshape(c, m * maxc, d)
    sids = ids_c[nb].reshape(c, m * maxc)
    if metric in ("ip", "cosine"):
        bias = torch.where(sids >= 0, 1.0, float("inf"))
        scale = 1.0
    else:
        snrm = cnorms_c[nb].reshape(c, m * maxc)
        bias = torch.where(sids >= 0, snrm, float("inf"))
        scale = 2.0
    v, li = cluster_join_topk(data_c, stack, bias.float().contiguous(), k,
                              scale)
    del stack
    gi = torch.gather(sids, 1, li.reshape(c, -1).long()).reshape(c, maxc, k)
    fin = torch.isfinite(v)
    return torch.where(fin, v, PAD_DIST), torch.where(fin, gi, PAD_ID)


def _pack_slabs(data, ids_c, slab_dtype, metric: str):
    """Device slab packing: one row gather from the resident dataset.
    Returns (slabs [C, maxc, d] slab_dtype, cnorms f32, slab_cents f32)."""
    ok = ids_c >= 0
    rows = data[ids_c.clamp(min=0).long()].float()
    rows = torch.where(ok[..., None], rows, 0.0)
    cnorms = (squared_norms(rows) if metric == "l2"
              else torch.zeros(ids_c.shape, device=data.device))
    counts = ok.sum(1).clamp(min=1)[:, None].float()
    cents = rows.sum(1) / counts
    return rows.to(slab_dtype).contiguous(), cnorms, cents


def _finalize(gids, vals, ids_c, n: int, k: int):
    """Drop self and pad hits, per-point top-k over the join width, and
    scatter the rows into the [N, k] adjacency (pad rows filtered)."""
    drop = (gids == ids_c[:, :, None]) | (gids < 0)
    vals = torch.where(drop, float("inf"), vals)
    sv, ordk = torch.sort(vals, dim=2, stable=True)
    rows = torch.gather(gids, 2, ordk[..., :k])
    rows = torch.where(torch.isfinite(sv[..., :k]), rows, PAD_ID)
    adj = torch.full((n, k), PAD_ID, dtype=torch.int32, device=gids.device)
    live = ids_c >= 0
    adj[ids_c[live].long()] = rows[live].to(torch.int32)
    return adj


def knn_graph_ivf(
    data,
    k: int,
    metric: str = "l2",
    n_clusters: int | None = None,
    probes: int = 8,
    kmeans_iters: int = 8,
    seed: int = 0,
    slab_dtype=torch.bfloat16,
    verbose: bool = False,
    as_device: bool = False,
    device=None,
    stats: dict | None = None,
):
    """Approximate kNN graph via cluster joins. Returns int32 [N, k]
    (numpy, or the tensor on the data's device when ``as_device``).

    data: numpy [N, d] (moved to ``device``, default ``cuda``) or a tensor
    (used where it lies). probes: slabs joined per slab (own + probes-1
    nearest by centroid), the recall knob, like IVF nprobe. When
    ``stats`` is a dict, the join's shape is written into it (``n_slabs``,
    ``maxc``, ``probes``, ``k``: the join width)."""
    if isinstance(data, torch.Tensor):
        data_dev = data.float()
    else:
        data_dev = torch.from_numpy(np.ascontiguousarray(data, np.float32))
        data_dev = data_dev.to(resolve_device(device))
    dev = data_dev.device
    n, d = data_dev.shape
    c_target = n_clusters or max(n // 1024, 1)

    cents, assign = kmeans(data_dev, c_target, iters=kmeans_iters, seed=seed)
    assign = assign.cpu().numpy()
    k0 = cents.shape[0]
    del cents

    # CNNS slab layout: oversized clusters split so the pad width stays
    # ~2x the mean (64-aligned, as the JAX package lays it out)
    order = np.argsort(assign, kind="stable")
    sizes0 = np.bincount(assign, minlength=k0)
    target = max(int(np.ceil(n / k0)), 8)
    maxc = int(((2 * target + 63) // 64) * 64)
    n_slabs0 = np.maximum(-(-sizes0 // maxc), 1)
    slab_base = np.concatenate([[0], np.cumsum(n_slabs0)])
    c = int(slab_base[-1])
    cluster_of_point = np.repeat(np.arange(k0), sizes0)
    starts = np.concatenate([[0], np.cumsum(sizes0)])
    off = np.arange(n) - starts[cluster_of_point]
    slab_row = slab_base[cluster_of_point] + off // maxc
    slot = off % maxc
    ids_np = np.full((c, maxc), PAD_ID, np.int32)
    ids_np[slab_row, slot] = order
    ids_c = torch.from_numpy(ids_np).to(dev)

    # per-slab centroids (split slabs get their own): probing by slab
    # keeps the join width fixed and still covers the original cluster
    slabs, cnorms, slab_cents = _pack_slabs(data_dev, ids_c, slab_dtype,
                                            metric)
    m = min(probes, c)
    cd = pairwise_dists(slab_cents, slab_cents, "l2", exact=False)
    nbrs = torch.sort(cd, dim=1, stable=True).indices[:, :m]   # self first
    kk = min(k + 2, m * maxc)   # margin for dropping self
    vals, gids = _cluster_join(slabs, ids_c, cnorms, nbrs, kk, metric)
    if verbose:
        print(f"cluster join done: C={c} maxc={maxc} probes={m}")
    if stats is not None:
        stats.update(n_slabs=c, maxc=maxc, probes=m, k=kk)
    adj = _finalize(gids, vals, ids_c, n, k)
    return adj if as_device else adj.cpu().numpy()
