"""Plain exact k-nearest-neighbour search over uint8 rows: the reference of
a uint8 vector index (BIGANN's 128-d uint8 SIFT descriptors, L2).

The benchmark draws f32 rows and queries (``datagen.py``). A uint8
configuration holds them as ``uint8_map`` gives them, and so does this
reference: each function maps the draws it is handed before it computes,
except the rows that ``quantize_int8`` returns, which ``search`` takes as
they are stored. Plain PyTorch only: it imports nothing of the program
under test and takes nothing that the program made.

The metric is ``l2``, the squared Euclidean distance of the uint8 values.
Every such distance is an integer below 2**24 (128 * 255**2), and so is
every f32 product and sum on the way to it: the f32 ranking (TF32 off)
is exact, and ties are exact ties. Distances of single pairs are taken
in float64.

The control of the benchmark's comparison is this reference computed in
the nearest precision below the configuration's exact 8-bit integers:
``search`` over the rows of ``quantize_int8`` (the mapped rows as int8
stores data that is not uint8: a shift for each dimension and one
symmetric scale) with bf16 queries (exact for uint8 values), returning
its own distances.
"""

from __future__ import annotations

import torch

# rows mapped a call: 64 MB of f32 at d = 128
_MAP_ROWS = 1 << 17


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _l2_only(metric: str) -> None:
    if metric != "l2":
        raise ValueError(f"uint8 rows are ranked by l2, not {metric!r}")


def uint8_map(x: torch.Tensor) -> torch.Tensor:
    """The SIFT-style map of a draw into uint8 counts: ``round(clamp(36 x +
    128, 0, 255))``, rounded half to even, in f32 arithmetic of one
    product and one sum (no fused multiply-add), so that the host and the
    card give the same bytes."""
    y = x.float() * 36.0
    y += 128.0
    return y.clamp_(0.0, 255.0).round_().to(torch.uint8)


def uint8_rows(x: torch.Tensor) -> torch.Tensor:
    """``uint8_map`` of rows [n, d], in chunks of ``_MAP_ROWS`` rows, on
    the rows' device."""
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    for s in range(0, x.shape[0], _MAP_ROWS):
        out[s : s + _MAP_ROWS] = uint8_map(x[s : s + _MAP_ROWS])
    return out


def _chunk(n_rows: int, budget_elems: int = 1 << 30) -> int:
    return max(1, budget_elems // max(1, n_rows))


def topk(x: torch.Tensor, q: torch.Tensor, k: int, metric: str
         ) -> torch.Tensor:
    """Ids [Q, k] (int64) of the k nearest mapped rows of ``x`` to each
    mapped query, nearest first, exact f32 products."""
    _l2_only(metric)
    _no_tf32()
    xf = uint8_rows(x).float()
    xn = (xf * xf).sum(1)
    qf = uint8_rows(q).float()
    out = []
    step = _chunk(x.shape[0])
    for s in range(0, q.shape[0], step):
        score = qf[s : s + step] @ xf.T
        score.mul_(-2.0).add_(xn)         # |x|^2 - 2 <q, x>, exact
        out.append(torch.topk(score, k, dim=1, largest=False).indices)
        del score
    return torch.cat(out)


def pair_dists(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
               metric: str):
    """Exact distances [R, k] of the mapped query rows ``q`` [R, d] to the
    mapped rows ``x[ids]`` ([R, k] ids, all valid), and the products of
    their norms |q| |x| [R, k], both in float64."""
    _l2_only(metric)
    dist, scale = [], []
    chunk = max(1, (1 << 27) // (ids.shape[1] * x.shape[1]))
    for s in range(0, q.shape[0], chunk):
        qb = uint8_map(q[s : s + chunk]).double()
        xb = uint8_map(x[ids[s : s + chunk]]).double()      # [r, k, d]
        dist.append(((xb - qb[:, None, :]) ** 2).sum(-1))
        scale.append(qb.norm(dim=1)[:, None] * xb.norm(dim=2))
    return torch.cat(dist), torch.cat(scale)


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """The mapped rows as int8 stores data that is not uint8, read back
    in f32: ``round((u - shift) / scale) * scale + shift`` with the mean
    of each dimension as its shift and one scale that maps the largest
    |u - shift| to 127."""
    u = uint8_rows(x)
    shift = u.float().mean(0)
    mx = max(float((u[s : s + _MAP_ROWS].float() - shift).abs().max())
             for s in range(0, u.shape[0], _MAP_ROWS))
    scale = (mx / 127.0) or 1.0
    out = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    for s in range(0, u.shape[0], _MAP_ROWS):
        q8 = torch.round((u[s : s + _MAP_ROWS].float() - shift) / scale)
        out[s : s + _MAP_ROWS] = q8.clamp(-127, 127) * scale + shift
    return out


def search(x: torch.Tensor, q: torch.Tensor, k: int, metric: str,
           q_dtype=torch.bfloat16):
    """Exact search of the mapped queries ``q``, rounded to ``q_dtype``,
    over stored rows ``x`` (in the map's units, as ``quantize_int8``
    returns them): (distances [Q, k] f32, ids [Q, k] int64), f32 products
    with TF32 off. Over ``quantize_int8``'s rows it is the control of the
    comparison."""
    _l2_only(metric)
    _no_tf32()
    xf = x.float()
    xn = (xf * xf).sum(1)
    qr = uint8_rows(q).to(q_dtype).float()
    d_out, i_out = [], []
    step = _chunk(x.shape[0])
    for s in range(0, q.shape[0], step):
        qs = qr[s : s + step]
        score = qs @ xf.T
        score.mul_(-2.0).add_(xn).add_((qs * qs).sum(1)[:, None])
        vals, ids = torch.topk(score, k, dim=1, largest=False)
        d_out.append(vals)
        i_out.append(ids)
        del score
    return torch.cat(d_out), torch.cat(i_out)
