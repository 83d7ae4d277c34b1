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


# Retset states that a hash- or filter-based merge+select can get wrong.
MERGE_STATE_KINDS = ("mod1024", "mod2048", "extremes", "all_in_retset",
                     "same_new", "pad_retset")


def adversarial_merge_state(kind, seed, q, l, c):
    """numpy inputs (r_d, r_i, r_e, c_d, c_i) of ``fused_merge_select``
    for ``q`` queries, retset width ``l`` and ``c`` candidates, made from
    ``seed``. Every retset is sorted ascending with unique ids, a random
    live length, random expanded flags and a PAD tail (PAD_DIST, PAD_ID,
    expanded). ``kind`` picks the ids:

      mod1024, mod2048: every id is congruent modulo 1024 (2048), so a
          table indexed by the low bits sees nothing but collisions;
      extremes: id 0, ids near 2**31 - 1 and small ids mixed;
      all_in_retset: every candidate repeats a retset id (one id for the
          even queries, random ones for the odd);
      same_new: every candidate is one id that the retset does not hold;
      pad_retset: the retset is all PAD.

    Except where the kind says otherwise, candidates mix retset members,
    new ids, repeats of earlier candidates and PADs, and some candidate
    distances tie retset distances and each other."""
    pad_dist, pad_id = np.float32(3.4e37), -1   # ops/distance.py
    rng = np.random.default_rng(seed)
    n_pool = 2 * (l + c)
    if kind in ("mod1024", "mod2048"):
        m = 1024 if kind == "mod1024" else 2048
        pool = int(rng.integers(0, m)) + m * rng.permutation(
            (2**31 - 1) // m - 1)[:n_pool]
    elif kind == "extremes":
        top = 2**31 - 1 - np.arange(n_pool // 2)
        pool = rng.permutation(np.concatenate(
            [top, np.arange(n_pool - len(top))]))
    else:
        pool = rng.permutation(1_000_000)[:n_pool]
    pool = pool.astype(np.int32)

    r_d = np.full((q, l), pad_dist, np.float32)
    r_i = np.full((q, l), pad_id, np.int32)
    r_e = np.ones((q, l), bool)
    c_d = rng.random((q, c)).astype(np.float32)
    c_i = np.empty((q, c), np.int32)
    for row in range(q):
        ids = rng.permutation(pool)
        live = 0 if kind == "pad_retset" else int(rng.integers(1, l + 1))
        if kind == "extremes" and live:
            ids = ids[ids != 0]
            ids[0] = 0                       # id 0 sits in the retset
        d = np.sort(rng.random(live).astype(np.float32))
        d[rng.random(live) < 0.2] = np.float32(0.5)   # ties
        r_d[row, :live] = np.sort(d)
        r_i[row, :live] = ids[:live]
        r_e[row, :live] = rng.random(live) < 0.5
        new = ids[live:]
        if kind == "all_in_retset" and live:
            c_i[row] = (ids[0] if row % 2 == 0
                        else ids[rng.integers(0, live, c)])
        elif kind == "same_new":
            c_i[row] = new[0]
        else:
            src = rng.random(c)
            members = ids[rng.integers(0, max(live, 1), c)]
            c_i[row] = np.where((src < 0.35) & (live > 0), members,
                                new[rng.integers(0, len(new), c)])
            c_i[row, src > 0.9] = pad_id
            rep = np.flatnonzero(rng.random(c) < 0.15)
            rep = rep[rep > 0]
            c_i[row, rep] = c_i[row, rng.integers(0, rep)]
        if live:
            tie = rng.random(c) < 0.25
            c_d[row, tie] = r_d[row, rng.integers(0, live, int(tie.sum()))]
    c_d[:, : c // 4] = np.float32(0.5)
    return r_d, r_i, r_e, c_d, c_i
