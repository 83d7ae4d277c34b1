"""Clustered synthetic vectors, the same generator as the JAX package's
benchmark (``bench.py:make_data``), kept numpy-only so a port run needs
no dataset download and no JAX: the same seed gives the same bytes."""

from __future__ import annotations

import numpy as np


def make_data(n, d, q, metric, seed=0, uint8=False, uniform=False):
    """Clustered synthetic. Center scale 1.0 gives inter/intra distance
    ratio ~2 (mildly separated mixture).

    uniform=True drops the mixture entirely (center scale 0): a single
    isotropic Gaussian with zero cluster structure — the IVF worst case.
    Returns (x [n, d] f32, queries [q, d] f32)."""
    rng = np.random.default_rng(seed)
    n_centers = max(n // 2500, 8)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    if uniform:
        centers *= 0.0
    assign = rng.integers(0, n_centers, n)
    # f32 directly and in row blocks: the f64 default costs 2x the RNG
    # work plus an n*d*8 B intermediate
    x = np.empty((n, d), np.float32)
    for s in range(0, n, 1_000_000):
        e = min(s + 1_000_000, n)
        x[s:e] = centers[assign[s:e]]
        x[s:e] += rng.standard_normal((e - s, d), dtype=np.float32)
    qa = rng.integers(0, n_centers, q)
    queries = centers[qa] + rng.standard_normal(
        (q, d), dtype=np.float32
    )
    if metric == "ip":
        # GloVe-style: normalized vectors, inner-product ranking
        x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-9
    if uint8:
        # SIFT-style uint8 counts: shift/scale the mixture into 0..255
        # and round (queries too)
        x = np.clip(x * 36 + 128, 0, 255).round()
        queries = np.clip(queries * 36 + 128, 0, 255).round()
    return x.astype(np.float32), queries.astype(np.float32)
