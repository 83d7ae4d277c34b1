"""Vectors and queries drawn on the device from the run's seed.

The mixture is the one the repository's synthetic sets use: a Gaussian
centre (N(0, 1) in every coordinate) for every ``ROWS_PER_CENTRE`` rows,
at least ``MIN_CENTRES``, with unit Gaussian noise around each, rows
optionally scaled to unit norm (inner-product sets). Every centre owns
the same number of rows and of pool queries.

The seed turns one fixed draw (``BASE_SEED``) by a random rotation: the
coordinates are permuted and each block of ``ROTATION_BLOCK`` of them is
turned by a random orthogonal matrix. A rotation keeps every distance,
so every seed gives the same set of cluster sizes and the same work in
another orientation, while every coordinate, and so every rounding the
program makes, is new. (Two draws of a mixture split into a different
number of slabs, which moves the work by several percent.)

Everything is drawn in a fixed sequence of calls of fixed shapes: the
base by one ``torch.Generator`` on ``device``, the rotation (a few small
QR factorisations) by one on the host in float64. So a seed gives the
same tensors every time on the same kind of device, and the reference
draws them again after the measured window instead of holding a copy.
"""

from __future__ import annotations

import torch

# rows drawn a call: about 512 MB of f32 noise at any width
_CHUNK_ELEMS = 1 << 27
ROTATION_BLOCK = 128
# the generator's seed of the fixed draw that every run's seed turns
BASE_SEED = 0
ROWS_PER_CENTRE = 2500
MIN_CENTRES = 8


def _balanced(count: int, parts: int, gen, device) -> torch.Tensor:
    """``count`` labels, each of ``parts`` values equally often (the first
    ``count % parts`` once more), in an order drawn from ``gen``."""
    labels = torch.arange(count, device=device) % parts
    return labels[torch.randperm(count, generator=gen, device=device)]


def rotation(d: int, seed: int, device):
    """(perm [d], blocks [d / b, b, b]): a coordinate permutation and
    Haar-random orthogonal blocks, drawn from ``seed`` on the host."""
    b = min(d, ROTATION_BLOCK)
    if d % b:
        raise ValueError(f"d = {d} is no whole number of blocks of {b}")
    gen = torch.Generator().manual_seed(int(seed))
    perm = torch.randperm(d, generator=gen)
    g = torch.randn((d // b, b, b), generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r, dim1=1, dim2=2))[:, None, :]
    return perm.to(device), q.to(device=device, dtype=torch.float32)


def _rows(centers, labels, gen, normalize: bool, turn) -> torch.Tensor:
    n, d = labels.shape[0], centers.shape[1]
    perm, blocks = turn
    nb, b = blocks.shape[0], blocks.shape[1]
    x = torch.empty((n, d), device=centers.device)
    step = max(1, _CHUNK_ELEMS // d)
    for s in range(0, n, step):
        e = min(n, s + step)
        blk = torch.randn((e - s, d), generator=gen, device=centers.device)
        blk += centers[labels[s:e]]
        blk = blk[:, perm].reshape(e - s, nb, b).transpose(0, 1)
        blk = torch.bmm(blk, blocks).transpose(0, 1).reshape(e - s, d)
        if normalize:
            blk /= blk.norm(dim=1, keepdim=True) + 1e-9
        x[s:e] = blk
    return x


def mixture(data_cfg: dict, n: int, d: int, pool: int, seed: int,
            device) -> tuple[torch.Tensor, torch.Tensor]:
    """(x [n, d] f32, queries [pool, d] f32) on ``device`` from ``seed``.

    ``data_cfg``: ``normalize``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(BASE_SEED)
    k = max(n // ROWS_PER_CENTRE, MIN_CENTRES)
    centers = torch.randn((k, d), generator=gen, device=device)
    normalize = bool(data_cfg["normalize"])
    x_lab = _balanced(n, k, gen, device)
    q_lab = _balanced(pool, k, gen, device)
    turn = rotation(d, seed, device)
    x = _rows(centers, x_lab, gen, normalize, turn)
    q = _rows(centers, q_lab, gen, normalize, turn)
    return x, q
