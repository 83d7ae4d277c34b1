"""Plain exact k-nearest-neighbour search: the reference of a vector index.

Given the rows and the queries that the benchmark drew, it says which k
rows are nearest to each query and how far every (query, row) pair is.
Plain PyTorch only: it imports nothing of the program under test and
takes nothing that the program made. f32 products with TF32 off for the
ranking; distances of single pairs in float64.

Metrics: ``l2`` is the squared Euclidean distance; ``ip`` is
``1 - <q, x>`` (rows and queries of unit norm rank alike under cosine).

The control of the benchmark's comparison is this reference computed in
the nearest precision below the program's bf16: ``search`` over the rows
of ``quantize_int8`` (int8 with a per-dimension shift and one symmetric
scale) with bf16 queries, returning its own distances.
"""

from __future__ import annotations

import torch


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _chunk(n_rows: int, budget_elems: int = 1 << 29) -> int:
    return max(1, budget_elems // max(1, n_rows))


def topk(x: torch.Tensor, q: torch.Tensor, k: int, metric: str
         ) -> torch.Tensor:
    """Ids [Q, k] (int64) of the k nearest rows of ``x`` to each query,
    nearest first, exact f32 products."""
    _no_tf32()
    xf = x.float()
    xn = (xf * xf).sum(1) if metric == "l2" else None
    out = []
    step = _chunk(x.shape[0])
    for s in range(0, q.shape[0], step):
        dots = q[s : s + step].float() @ xf.T
        if metric == "l2":
            score = xn[None, :] - 2.0 * dots
            out.append(torch.topk(score, k, dim=1, largest=False).indices)
        else:
            out.append(torch.topk(dots, k, dim=1, largest=True).indices)
        del dots
    return torch.cat(out)


def pair_dists(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
               metric: str):
    """Exact distances [R, k] of query rows ``q`` [R, d] to rows
    ``x[ids]`` ([R, k] ids, all valid), and the products of their norms
    |q| |x| [R, k], both in float64."""
    dist, scale = [], []
    chunk = max(1, (1 << 27) // (ids.shape[1] * x.shape[1]))
    for s in range(0, q.shape[0], chunk):
        qb = q[s : s + chunk].double()
        xb = x[ids[s : s + chunk]].double()              # [r, k, d]
        if metric == "l2":
            dist.append(((xb - qb[:, None, :]) ** 2).sum(-1))
        else:
            dist.append(1.0 - (xb * qb[:, None, :]).sum(-1))
        scale.append(qb.norm(dim=1)[:, None] * xb.norm(dim=2))
    return torch.cat(dist), torch.cat(scale)


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Rows as int8 stores them, read back in f32: ``round((x - shift) /
    scale) * scale + shift`` with the mean of each dimension as its shift
    and one scale that maps the largest |x - shift| to 127."""
    step = 1 << 16
    shift = x.float().mean(0)
    mx = max(float((x[s : s + step].float() - shift).abs().max())
             for s in range(0, x.shape[0], step))
    scale = (mx / 127.0) or 1.0
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], step):
        q8 = torch.round((x[s : s + step].float() - shift) / scale)
        out[s : s + step] = q8.clamp(-127, 127) * scale + shift
    return out


def search(x: torch.Tensor, q: torch.Tensor, k: int, metric: str,
           q_dtype=torch.bfloat16):
    """Exact search of ``q`` rounded to ``q_dtype`` over rows ``x``:
    (distances [Q, k] f32 in the metric's units, ids [Q, k] int64), f32
    products with TF32 off. Over ``quantize_int8``'s rows it is the
    control of the comparison."""
    _no_tf32()
    xf = x.float()
    xn = (xf * xf).sum(1) if metric == "l2" else None
    qr = q.to(q_dtype).float()
    d_out, i_out = [], []
    step = _chunk(x.shape[0])
    for s in range(0, q.shape[0], step):
        qs = qr[s : s + step]
        dots = qs @ xf.T
        if metric == "l2":
            score = xn[None, :] - 2.0 * dots + (qs * qs).sum(1)[:, None]
        else:
            score = 1.0 - dots
        vals, ids = torch.topk(score, k, dim=1, largest=False)
        d_out.append(vals)
        i_out.append(ids)
        del dots, score
    return torch.cat(d_out), torch.cat(i_out)
