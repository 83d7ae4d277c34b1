"""Fixed-width sorted candidate pools and row-wise top-k with the JAX
package's tie order (counterpart of hnsw_nsg_tpu/ops/topk.py).

``jax.lax.top_k`` returns equal values in index order. ``torch.topk`` does
not promise any order among ties, so the port selects with a stable sort:
among equal distances the earlier position wins, as in the reference.

A retset is a sorted (dist, id, expanded) triple of static width L per
query: the batched form of the reference's fixed-capacity sorted pool
with binary insertion (``InsertIntoPool``,
CNNS/efanna_graph/include/efanna2e/neighbor.h:107-135). Eviction from a
top-L retset is permanent, so retset dedup alone keeps a node from being
expanded twice.
"""

from __future__ import annotations

import torch

from .distance import PAD_DIST, PAD_ID


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Row-wise k smallest (dist, id) pairs, sorted ascending; ties keep
    their position order."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    idx = idx[..., :k]
    return vals[..., :k], torch.gather(ids, -1, idx)


def topk_smallest_wide(dists: torch.Tensor, k: int):
    """``topk_smallest`` of the positions of 2-D rows much wider than k,
    with the same result, by a selection instead of a sort of the row:
    ``torch.topk`` picks k smallest entries; where it left out an entry
    equal to the k-th value (it chooses among ties arbitrarily) or met
    NaN, the row is taken by the stable sort. The k picks are then
    ordered by value, ties by position. Returns (values, positions)."""
    n = dists.shape[-1]
    col = torch.arange(n, device=dists.device)
    if k >= n:
        return topk_smallest(dists, col.expand(dists.shape), k)
    vals, pos = torch.topk(dists, k, dim=-1, largest=False, sorted=False)
    kth = vals.amax(-1, keepdim=True)
    redo = (((dists == kth).sum(-1) != (vals == kth).sum(-1))
            | torch.isnan(kth[:, 0])).nonzero()[:, 0]
    if redo.numel():
        pos[redo] = topk_smallest(dists[redo],
                                  col.expand(redo.numel(), n), k)[1]
    pos = torch.sort(pos, dim=1).values                 # position order
    vals, order = torch.sort(torch.gather(dists, 1, pos), dim=1, stable=True)
    return vals, torch.gather(pos, 1, order)


def empty_retset(batch: int, width: int, device=None):
    """An all-padding retset: dists=PAD_DIST, ids=PAD_ID, expanded=True
    (padded slots are never picked as frontier)."""
    dists = torch.full((batch, width), float(PAD_DIST), device=device)
    ids = torch.full((batch, width), PAD_ID, dtype=torch.int32,
                     device=device)
    expanded = torch.ones((batch, width), dtype=torch.bool, device=device)
    return dists, ids, expanded


def mask_internal_dups(ids: torch.Tensor) -> torch.Tensor:
    """ids: [Q, K] -> bool [Q, K], True where the slot repeats an earlier
    slot of its row (the first occurrence is kept)."""
    k = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]          # [Q, K, K]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=ids.device).tril(-1)
    return (eq & earlier).any(-1) & (ids >= 0)


def _take_width(all_d, all_i, all_e, width: int):
    vals, order = torch.sort(all_d, dim=1, stable=True)
    order = order[:, :width]
    new_i = torch.gather(all_i, 1, order)
    new_e = torch.gather(all_e, 1, order) | (new_i < 0)
    return vals[:, :width].contiguous(), new_i, new_e


def merge_into_retset(r_dists, r_ids, r_expanded, c_dists, c_ids):
    """Merge candidate (dist, id) pairs into a sorted retset.

    r_*: [Q, L] current retset (ascending by dist). c_*: [Q, K] new
    candidates; c_ids may hold PAD_ID and duplicates. Candidates that
    repeat a retset entry or an earlier candidate are dropped; surviving
    entries arrive with expanded=False. Returns the new (dists, ids,
    expanded), ascending, ties in concatenation order."""
    dup_vs_retset = (c_ids[:, :, None] == r_ids[:, None, :]).any(-1) & (
        c_ids >= 0)
    drop = dup_vs_retset | mask_internal_dups(c_ids) | (c_ids < 0)
    cd = torch.where(drop, PAD_DIST, c_dists)
    ci = torch.where(drop, PAD_ID, c_ids)
    all_d = torch.cat([r_dists, cd], 1)
    all_i = torch.cat([r_ids, ci], 1)
    all_e = torch.cat([r_expanded, torch.zeros_like(drop)], 1)
    return _take_width(all_d, all_i, all_e, r_dists.shape[1])


def merge_into_retset_sorted(r_dists, r_ids, r_expanded, c_dists, c_ids):
    """merge_into_retset with sort-based dedup, for wide candidate blocks:
    stable sort the pool by id (retset entries first, so they win
    duplicates and keep their flags), drop adjacent equal ids, then take
    the top L by distance. Same result as merge_into_retset."""
    cd = torch.where(c_ids < 0, PAD_DIST, c_dists)
    all_d = torch.cat([r_dists, cd], 1)
    all_i = torch.cat([r_ids, c_ids], 1)
    all_e = torch.cat([r_expanded, torch.zeros_like(c_ids, dtype=torch.bool)],
                      1)
    si, o = torch.sort(all_i, dim=1, stable=True)
    sd = torch.gather(all_d, 1, o)
    se = torch.gather(all_e, 1, o)
    dup = torch.cat([torch.zeros_like(si[:, :1], dtype=torch.bool),
                     si[:, 1:] == si[:, :-1]], 1) & (si >= 0)
    sd = torch.where(dup, PAD_DIST, sd)
    si = torch.where(dup, PAD_ID, si)
    return _take_width(sd, si, se, r_dists.shape[1])


def init_retset(c_dists, c_ids, width: int):
    """A fresh sorted retset of the given width from raw candidates."""
    d0, i0, e0 = empty_retset(c_dists.shape[0], width, c_dists.device)
    return merge_into_retset(d0, i0, e0, c_dists, c_ids)


def scatter_last(n_rows: int, width: int, dst, col, *vals_fill):
    """For each (vals, fill): an [n_rows, width] tensor of ``fill`` with
    out[dst[j], col[j]] = vals[j] over the flattened proposals; where
    several land on one cell the last in flattened order wins, on every
    device (a scatter on the card keeps an arbitrary one). Proposals with
    dst outside [0, n_rows) are dropped. The random-column reservoirs of
    HNSW's reverse edges and nn-descent's reverse lists."""
    dump = n_rows * width
    ok = (dst >= 0) & (dst < n_rows)
    key = torch.where(ok, dst.long() * width + col.long(), dump).reshape(-1)
    sk, order = torch.sort(key, stable=True)
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[1:] != sk[:-1]
    tgt = torch.where(last, sk, dump)
    out = []
    for vals, fill in vals_fill:
        buf = torch.full((dump + 1,), fill, dtype=vals.dtype,
                         device=vals.device)
        buf.scatter_(0, tgt, vals.reshape(-1)[order])
        out.append(buf[:-1].view(n_rows, width))
    return out
