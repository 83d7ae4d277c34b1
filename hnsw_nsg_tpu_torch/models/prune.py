"""Batched occlusion (MRNG) edge pruning, shared by NSG and HNSW
(counterpart of hnsw_nsg_tpu/models/prune.py).

The reference rule (NSG ``sync_prune``, CNNS/src/nsg/index_nsg.cpp:
305-355; hnswlib ``getNeighborsByHeuristic2``): scan candidates in
ascending distance to the node; keep p unless some already-kept t has
d(t, p) < d(node, p); keep at most R, scan at most C. The greedy scan is
``max_keep`` rounds of "take the closest candidate not yet occluded, then
occlude everything it dominates", over pair distances precomputed per
row chunk with one batched f32 product. A duplicate of a kept id has pair
distance 0 < d(node, p), so duplicates need no separate dedup.

Pair distances stay f32 with TF32 off: the TPU cast the gathered rows to
bf16 (prune.py:109-114) only because its default-precision product
truncated to bf16 anyway; on the card that cast would lose precision.
"""

from __future__ import annotations

import torch

from ..ops.distance import PAD_DIST, PAD_ID, f32_dots

_PAIR_BYTES = 1 << 30   # f32 pair-distance block per row chunk


def _prune_rows(s_ids, s_d, data, norms, max_keep: int, metric: str):
    """The greedy rounds for one row chunk of sorted candidates."""
    b, c = s_ids.shape
    dev = s_ids.device
    safe = s_ids.clamp(min=0).long()
    vecs = data[safe]                                  # [b, c, d]
    dots = f32_dots(vecs, vecs)                        # [b, c, c]
    del vecs
    if metric in ("ip", "cosine"):
        pair = 1.0 - dots
    else:
        nrm = norms[safe]
        pair = nrm[:, :, None] + nrm[:, None, :] - 2.0 * dots
    del dots
    col = torch.arange(c, device=dev)
    rows = torch.arange(b, device=dev)
    kept_ids = torch.full((b, max_keep), PAD_ID, dtype=torch.int32,
                          device=dev)
    kept_d = torch.full((b, max_keep), float(PAD_DIST), device=dev)
    dead = ~((s_ids >= 0) & (s_d < PAD_DIST))
    for r in range(max_keep):
        # first live column (0 when none is live; then got is False)
        pick = torch.where(dead, c, col).argmin(1)
        got = ~dead[rows, pick]
        kept_ids[:, r] = torch.where(got, s_ids[rows, pick], PAD_ID)
        kept_d[:, r] = torch.where(got, s_d[rows, pick], PAD_DIST)
        prow = pair[rows, pick]                        # [b, c]
        dead |= (got[:, None] & (prow < s_d)) | (col == pick[:, None])
    return kept_ids, kept_d


def occlusion_prune(
    node_vecs: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    max_keep: int,
    scan_cap: int | None = None,
    metric: str = "l2",
    self_ids: torch.Tensor | None = None,
):
    """Select up to ``max_keep`` diverse neighbors per node.

    node_vecs [B, d] (unused by the rule; kept for the JAX signature);
    cand_ids [B, C] PAD_ID-padded, duplicates allowed; cand_dists [B, C]
    their EXACT distances to the node (PAD slots >= PAD_DIST); data/norms
    the vector store; scan_cap: at most this many sorted candidates are
    examined; self_ids [B]: candidates equal to the node are dropped.
    Returns (kept_ids [B, max_keep] PAD-padded, kept_dists), ascending."""
    b, c = cand_ids.shape
    scan = min(scan_cap or c, c)
    d = torch.where(cand_ids < 0, PAD_DIST, cand_dists)
    if self_ids is not None:
        d = torch.where(cand_ids == self_ids[:, None].to(cand_ids.dtype),
                        PAD_DIST, d)
    s_d, order = torch.sort(d, dim=1, stable=True)
    s_d = s_d[:, :scan].contiguous()
    s_ids = torch.gather(cand_ids, 1, order[:, :scan]).to(torch.int32)
    chunk = max(1, _PAIR_BYTES // (4 * max(scan, 1) ** 2))
    out_i, out_d = [], []
    for s in range(0, b, chunk):
        ki, kd = _prune_rows(s_ids[s : s + chunk], s_d[s : s + chunk], data,
                             norms, max_keep, metric)
        out_i.append(ki)
        out_d.append(kd)
    if not out_i:
        return (torch.full((0, max_keep), PAD_ID, dtype=torch.int32,
                           device=cand_ids.device),
                torch.full((0, max_keep), float(PAD_DIST),
                           device=cand_ids.device))
    return torch.cat(out_i), torch.cat(out_d)


def occlusion_prune_padded(node_vecs, cand_ids, cand_dists, data, norms,
                           max_keep: int, scan_cap: int | None = None,
                           metric: str = "l2", self_ids=None):
    """occlusion_prune under the JAX package's name for callers with
    varying (B, C). The TPU padded B and C to power-of-two buckets to
    bound recompiles; padding changes no result (PAD candidates sort
    last and the scan cap keeps every real one), so nothing is padded."""
    return occlusion_prune(node_vecs, cand_ids, cand_dists, data, norms,
                           max_keep=max_keep, scan_cap=scan_cap,
                           metric=metric, self_ids=self_ids)
