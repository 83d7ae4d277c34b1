"""Lloyd's k-means on tensors (counterpart of hnsw_nsg_tpu/models/kmeans.py).

Assignment = argmin of a [chunk, k] pairwise-distance block (bf16-rounded
operands, f32 products and sums); update = ``index_add_`` of the points
into f32 centroid sums. Empty clusters are re-seeded from the points
currently farthest from their centroid (cluster i takes the i-th
farthest), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import pairwise_dists, squared_norms


def _assign(data, centroids, c_norms, chunk: int = 65536):
    """argmin_k ||x - c_k||^2 for every point, chunked over N. The GEMM
    operands are rounded to bf16 as in the reference (argmin over cluster
    distances is insensitive to it); centroid norms stay f32. Returns
    (assign [N] int64, min FastL2 distance [N] f32)."""
    cb = centroids.to(torch.bfloat16)
    assign, dmin = [], []
    for s in range(0, data.shape[0], chunk):
        d = pairwise_dists(
            data[s : s + chunk].to(torch.bfloat16), cb, "l2", c_norms,
            exact=False,
        )
        m, a = d.min(dim=1)   # first minimum on ties, like jnp.argmin
        assign.append(a)
        dmin.append(m)
    return torch.cat(assign), torch.cat(dmin)


def _step(data, centroids, chunk: int):
    """One full Lloyd's iteration: assign -> index_add_ update -> re-seed
    empty clusters from the k worst-assigned points."""
    k, d = centroids.shape
    assign, dmin = _assign(data, centroids, squared_norms(centroids), chunk)
    sums = torch.zeros((k, d), dtype=torch.float32, device=data.device)
    sums.index_add_(0, assign, data.float())
    counts = torch.bincount(assign, minlength=k).float()
    new_c = sums / counts.clamp(min=1.0)[:, None]
    # k farthest points, ties in index order (jax.lax.top_k)
    far = torch.sort(dmin, descending=True, stable=True).indices[:k]
    empty = counts == 0
    new_c = torch.where(empty[:, None], data[far].float(), new_c)
    return new_c, dmin.mean(), empty.sum()


def kmeans(
    data,
    k: int,
    iters: int = 20,
    seed: int = 0,
    chunk: int = 65536,
    verbose: bool = False,
):
    """Returns (centroids [k, d] f32, assignments [N] int64), on the
    device of ``data`` (a tensor; numpy input goes to the CPU). The
    initial centroids are the rows ``np.random.default_rng(seed).choice(
    n, k, replace=False)``, the JAX package's draw."""
    data = torch.as_tensor(data)
    n, d = data.shape
    k = min(k, n)
    chunk = min(chunk, n)
    rng = np.random.default_rng(seed)
    init = torch.from_numpy(rng.choice(n, k, replace=False)).to(data.device)
    centroids = data[init].float()

    for it in range(iters):
        centroids, mean_d, n_empty = _step(data, centroids, chunk)
        if verbose:
            print(
                f"kmeans iter {it + 1}/{iters}: mean dist "
                f"{float(mean_d):.4f} empty={int(n_empty)}"
            )

    assign, _ = _assign(data, centroids, squared_norms(centroids), chunk)
    return centroids, assign
