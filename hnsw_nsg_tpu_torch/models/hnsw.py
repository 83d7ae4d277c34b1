"""Hierarchical NSW (HNSW) on tensors (counterpart of
hnsw_nsg_tpu/models/hnsw.py).

Reference: ``HierarchicalNSW`` (hnswlib/hnswlib/hnswalg.h). As in the JAX
package:

  * the node arena is a set of padded adjacency tensors, level 0
    ``int32[cap, 2M]`` and one ``int32[cap, M]`` per upper level;
  * ``addPoint`` becomes bulk-synchronous batched insertion: a whole batch
    descends greedily, collects ef_construction candidates per level with
    the lockstep beam (``beam_search_chunked``, whose every hop runs
    ``fused_merge_select``), adds intra-batch candidates from one [B, B]
    distance block, prunes with the shared occlusion rule
    (getNeighborsByHeuristic2), links, and applies reverse edges with
    overflow re-pruning (mutuallyConnectNewElement);
  * levels are sampled ``-log(U) / ln(M)``;
  * ``searchKnn`` is a routed entry (one product over every level >= 1
    node, bf16 rows) or the per-level greedy descent, then the ef-beam at
    level 0;
  * deletes are a boolean mask: deleted nodes stay traversable and are
    filtered from results inside the traversal.

Tensors live on one explicit device (``device=None``: the card). Host
bookkeeping (levels, labels, the deleted mask, the label map and the
random generator) is numpy, as in the JAX package, so a seed draws the
same levels and the same reverse-edge columns in both.

Not carried over, none of which a result depends on: the power-of-two
row buckets and the batch padding that bounded recompiles (tensors have
their real sizes here; only the COUNT of random draws still follows the
padded shapes, ``_draw_cap``), the arena's capacity buckets (the arena
holds exactly ``max_elements`` rows), the per-phase stderr timer
(``stage_seconds`` takes its place), the router's pad to a multiple of
128. One thing the JAX package's padding does change is not copied: its
dummy pad rows (copies of the batch's first point) compete for the
intra-batch candidate slots of a padded batch, which here hold real
batch peers only. The reverse-edge round keeps, of the proposals that
collide on one (destination, column), the last in flattened order, on
every device; a scatter would keep whichever thread came last.

The packed int8 records (``models/records.py``) serve level 0:
``build_accel`` derives them from the graph, after which ``knn_query``
without deletes or a filter walks them and re-ranks the retset head
exactly; ``add_items(accel=True)`` keeps them up to date through the
inserts (a quantized copy of the data at a scale fixed by the first
batch, the rows of new nodes, reverse-edge destinations and repair edges
repacked after each batch) and runs the inserts' level-0 beam on them,
with the candidate pools re-distanced exactly. A mutation without
``accel`` drops them, as do ``resize_index``, ``replace_point`` and
loading.

``epsilon_query`` is the range search of ``models/extensions.py`` from
the routed entry. ``replace_point`` reuses a slot for a new vector: new
out-links from a beam at each of the slot's levels, the reverse edges,
and a re-prune of the old neighbourhood (hnswlib's updatePoint and
repairConnectionsForUpdate), one point at a time as in the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.distance import (
    PAD_DIST,
    PAD_ID,
    as_f32_queries,
    gathered_dists,
    pairwise_dists,
    squared_norms,
)
from ..ops.topk import (empty_retset, merge_into_retset_sorted,
                        scatter_last, topk_smallest)
from ..utils.device import resolve_device
from ..utils.params import HNSWConfig
from .beam import beam_search_chunked, beam_search_filtered, greedy_descent
from .inline_graph import rerank_exact
from .prune import occlusion_prune_padded
from .records import (_layout, beam_search_records, build_record_graph,
                      quantize_rows, update_record_rows)

_ROUTE_Q_BLOCK = 2048   # queries per router product (bounds the [Q, n1] block)


def _route_entry_gemm(q, data_up, norms_up, ids_up, metric):
    """Exact level-0 entry selection: one product over every level >= 1
    node. The upper hierarchy's only query-time job is picking a good
    level-0 entry (hnswalg.h:1278-1303 approximates "nearest level-1
    node" by greedy walking); with only ~N/M such nodes the whole
    candidate set fits one [Q, n1] block, which returns the nearest of
    them (in the rows' bf16 rounding; the first of equals) with no
    data-dependent gathers and no sequential hops."""
    out = []
    qr = q.to(data_up.dtype)
    for s in range(0, q.shape[0], _ROUTE_Q_BLOCK):
        d = pairwise_dists(qr[s : s + _ROUTE_Q_BLOCK], data_up, metric,
                           norms_up, exact=False)
        out.append(ids_up[d.argmin(1)])
    return torch.cat(out)


def _reverse_insert_round(adj_l, cache_d, data, norms, kept_i, kept_d, cols,
                          src, rows, cap_deg: int, metric: str):
    """One reverse-edge insertion round (mutuallyConnectNewElement's second
    half, hnswalg.h:554-627; ``_reverse_insert_jit`` in the JAX package):

      1. proposals: inc[dst, col] = (src, d), col drawn at random by the
         caller; of the proposals that collide on one (dst, col) the last
         in flattened order wins, ids and distances alike;
      2. existing-link distances from ``cache_d`` when given, else
         recomputed by a gathered distance pass;
      3. pool = existing ++ incoming, sorted dedup merge (the room/append
         path) + overflow detection;
      4. occlusion re-prune over every receiving row, applied only where
         the row overflows.

    kept_i/kept_d [B, m]: the new nodes' pruned links; src [B] their ids;
    rows: the sorted unique destinations. Writes ``adj_l`` (and
    ``cache_d``) in place."""
    b, m = kept_i.shape
    n_dst = rows.shape[0]
    dev = kept_i.device
    pos = torch.where(kept_i >= 0,
                      torch.searchsorted(rows, kept_i.clamp(min=0)), -1)
    inc, inc_d = scatter_last(n_dst, cap_deg, pos, cols,
                              (src[:, None].expand(b, m), PAD_ID),
                              (kept_d, float(PAD_DIST)))

    rl = rows.long()
    vecs = data[rl]
    exist = adj_l[rl][:, :cap_deg]
    if cache_d is not None:
        exist_d = cache_d[rl][:, :cap_deg]
    else:
        exist_d = gathered_dists(vecs, data, exist, metric, norms, exact=True)
    pool_i = torch.cat([exist, inc], 1)
    pool_d = torch.cat([exist_d, inc_d], 1)
    # drop duplicates (dst already links src) with the sorted-dedup merge;
    # the result doubles as the "room" (append) path
    md, mi, _ = merge_into_retset_sorted(
        *empty_retset(n_dst, cap_deg, dev), pool_d, pool_i)
    sp = torch.sort(pool_i, dim=1).values
    distinct = (sp >= 0) & torch.cat(
        [torch.ones_like(sp[:, :1], dtype=torch.bool),
         sp[:, 1:] != sp[:, :-1]], 1)
    overflow = (distinct.sum(1) > cap_deg)[:, None]
    kept2_i, kept2_d = occlusion_prune_padded(
        vecs, pool_i, pool_d, data, norms, max_keep=cap_deg, metric=metric,
        self_ids=rows)
    adj_l[rl, :cap_deg] = torch.where(overflow, kept2_i, mi)
    if cache_d is not None:
        cache_d[rl, :cap_deg] = torch.where(overflow, kept2_d, md)


def _arena_cap(max_elements: int) -> int:
    """The JAX package's arena capacity for a requested element count
    (powers of two up to 8M rows, 2M-row steps above). The port's arena
    holds exactly ``max_elements`` rows; this value only sizes the random
    draws of an insert, which follow the JAX package's padded batch, so
    that a seed gives the same levels in both packages."""
    if max_elements <= (1 << 23):
        cap = 1024
        while cap < max_elements:
            cap *= 2
        return cap
    g = 1 << 21
    return -(-max_elements // g) * g


class HNSWIndex:
    """Mutable HNSW index over a fixed-capacity arena on one device."""

    def __init__(
        self,
        dim: int,
        max_elements: int,
        cfg: HNSWConfig = HNSWConfig(),
        metric: str = "l2",
        dtype=torch.float32,
        device=None,
    ):
        self.dim = dim
        self.max_elements = int(max_elements)
        self.cap = self.max_elements
        self._draw_cap = _arena_cap(self.max_elements)
        self.cfg = cfg
        self.metric = metric
        self.dtype = dtype
        self.device = resolve_device(device)

        self.n = 0
        self.max_level = -1
        self.ep = PAD_ID

        dev = self.device
        self.data = torch.zeros((self.cap, dim), dtype=dtype, device=dev)
        self.norms = torch.zeros((self.cap,), device=dev)
        self.levels = np.zeros((self.cap,), np.int32)
        self.adj0 = torch.full((self.cap, 2 * cfg.M), PAD_ID,
                               dtype=torch.int32, device=dev)
        # optional cached exact metric distance of every level-0 link:
        # adj0_d[i, j] = d(data[i], data[adj0[i, j]]) (PAD_DIST on pads).
        # Off by default (HNSWConfig.link_dist_cache): the reverse-edge
        # round then recomputes them. None also after file loads.
        self.adj0_d = (
            torch.full((self.cap, 2 * cfg.M), float(PAD_DIST), device=dev)
            if cfg.link_dist_cache else None
        )
        self.adj_up: list[torch.Tensor] = []   # level l at index l-1

        self.deleted = np.zeros((self.cap,), bool)
        self.num_deleted = 0
        self.labels = np.full((self.cap,), -1, np.int64)
        self.label_to_id: dict[int, int] = {}

        self._rng = np.random.default_rng(cfg.random_seed)
        # derived int8 record layout for level-0 search (models/records.py);
        # rebuilt on demand, dropped by a mutation unless add_items(accel=
        # True) maintains it, with the quantized vectors [cap, 4, nw] int8
        self._records = None
        self._dataq = None
        self._maintain_records = False
        # cached (ids, bf16 rows, norms) of level>=1 nodes for routed
        # entry selection; invalidated by any mutation
        self._router = None
        # search metrics (metric_hops / metric_distance_computations,
        # hnswalg.h:65-66)
        self.metric_hops = 0
        self.metric_distance_computations = 0
        # set to a dict to collect the wall seconds of each insert phase
        # (beams, intra_batch, prune_link, reverse_insert); every phase
        # then ends with a device synchronisation
        self.stage_seconds: dict | None = None

    # ------------------------------------------------------------------
    # construction

    def _sample_levels(self, b: int) -> np.ndarray:
        u = self._rng.random(b)
        return (-np.log(u) * self.cfg.mult).astype(np.int32)

    def _adj_at(self, level: int) -> torch.Tensor:
        return self.adj0 if level == 0 else self.adj_up[level - 1]

    def _ensure_levels(self, lvl: int) -> None:
        while len(self.adj_up) < lvl:
            self.adj_up.append(torch.full(
                (self.cap, self.cfg.M), PAD_ID, dtype=torch.int32,
                device=self.device))

    def _mark(self, name: str, t0: float) -> float:
        if self.stage_seconds is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + t1 - t0
        return t1

    def add_items(self, vecs, labels=None, batch_size: int = 4096,
                  repair: bool = True, accel: bool = False):
        """Batched insertion (the reference's parallel addItems,
        bindings.cpp:251-300, as bulk-synchronous rounds).

        ``repair``: run level-0 connectivity repair afterwards. The
        reference's sequential insert keeps the graph connected implicitly
        (an unreachable cluster's first points can only link to reachable
        nodes); bulk batches lose that mechanism on strongly clustered
        data, so the invariant is restored explicitly, NSG-tree_grow style
        (CNNS/src/nsg/index_nsg.cpp:748-764).

        ``accel``: maintain the packed int8 record layout through the
        inserts and run the level-0 candidate beam over it, one row gather
        an expansion (models/records.py). Pool distances are re-computed
        exactly before pruning, so link selection sees exact distances.
        The index keeps live records, so later knn_query calls walk them."""
        if accel:
            self._maintain_records = True
        self._router = None
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        b_total = vecs.shape[0]
        if labels is None:
            labels = np.arange(self.n, self.n + b_total, dtype=np.int64)
        labels = np.asarray(labels, np.int64).reshape(b_total)
        if self.n + b_total > self.max_elements:
            raise RuntimeError(
                "The number of elements exceeds the specified limit"
            )  # hnswalg.h:1177-1179 wording
        # the JAX package pads every (sub-)batch of a call to this size;
        # here it only sets how many levels a batch draws
        draw = min(batch_size, max(self._draw_cap - self.n, 1))
        s = 0
        if self.n == 0 and b_total > 64:
            # cold start: exponentially growing sub-batches. A sequential
            # insert's early points can only link to already-inserted
            # (possibly far) nodes, which is what stitches well-separated
            # clusters together; a single huge first batch would give every
            # point same-cluster candidates only. Doubling keeps the cost
            # O(batch) while reproducing that structure.
            sub = 32
            while s < b_total and sub < batch_size:
                e = min(s + sub, b_total)
                self._insert_batch(vecs[s:e], labels[s:e], draw)
                s = e
                sub *= 2
        for s in range(s, b_total, batch_size):
            e = min(s + batch_size, b_total)
            self._insert_batch(vecs[s:e], labels[s:e], draw)
        if repair:
            self.repair_connectivity()

    def repair_connectivity(self, max_rounds: int = 32) -> int:
        """Make every node reachable from the enterpoint at level 0.

        Host BFS over the level-0 adjacency; each round batch-searches up
        to 256 unreachable component representatives from the enterpoint
        and links each from its closest reachable candidate that has a
        free slot (findroot, index_nsg.cpp:712-747). Only when every
        reachable candidate is full is the closest one's last edge
        overwritten; that can cut off a node reached through it, so the
        reach is then recomputed from the enterpoint before the next round
        (the JAX package always takes the closest candidate and keeps its
        stale reach). Returns the number of edges added."""
        if self.n <= 1:
            return 0
        if not self._maintain_records:
            self._records = None
        n = self.n
        dev = self.device
        adj0 = self.adj0[:n].cpu().numpy()
        cap0 = 2 * self.cfg.M

        def bfs(seeds, visited):
            frontier = np.asarray(seeds, dtype=np.int64)
            visited[frontier] = True
            while len(frontier):
                nxt = adj0[frontier].reshape(-1)
                nxt = np.unique(nxt[nxt >= 0])
                nxt = nxt[~visited[nxt]]
                visited[nxt] = True
                frontier = nxt
            return visited

        visited = bfs([self.ep], np.zeros(n, bool))
        added = 0
        edges = {}   # (attach, slot) -> root; a later overwrite wins
        for _ in range(max_rounds):
            if visited.all():
                break
            reps = np.nonzero(~visited)[0][:256]
            res = beam_search_chunked(
                self.data[torch.from_numpy(reps).to(dev)],
                self.data, self.norms, torch.from_numpy(adj0).to(dev),
                torch.full((len(reps), 1), self.ep, dtype=torch.int32,
                           device=dev),
                width=self.cfg.ef_construction, metric=self.metric,
                max_hops=256, expand=self.cfg.insert_expand,
            )
            ids = res.ids.cpu().numpy()
            overwrote = False
            for b, root in enumerate(reps):
                if visited[root]:
                    continue
                cand = ids[b]
                cand = cand[cand >= 0]
                cand = cand[visited[cand]] if len(cand) else cand
                room = (cand[(adj0[cand] >= 0).sum(1) < cap0]
                        if len(cand) else cand)
                attach = int(room[0] if len(room) else
                             cand[0] if len(cand) else self.ep)
                deg = int((adj0[attach] >= 0).sum())
                slot = deg if deg < cap0 else cap0 - 1
                overwrote |= deg >= cap0
                adj0[attach, slot] = root
                edges[(attach, slot)] = int(root)
                added += 1
                visited = bfs([root], visited)
            if overwrote:
                visited = bfs([self.ep], np.zeros(n, bool))
        if edges:
            at, sl = (torch.tensor(v, device=dev) for v in zip(*edges))
            rt = torch.tensor(list(edges.values()), dtype=torch.int32,
                              device=dev)
            self.adj0[at, sl] = rt
            if self.adj0_d is not None:
                self.adj0_d[at, sl] = gathered_dists(
                    self.data[at], self.data, rt[:, None], self.metric,
                    self.norms, exact=True)[:, 0]
            if self._maintain_records and self._records is not None:
                self._refresh_record_rows(at.to(torch.int32))
        return added

    def _init_records_state(self, x_sample: np.ndarray,
                            max_degree: int = 30) -> None:
        """The maintained records over the arena and the quantized
        vectors, at a scale with 25% headroom over the first batch."""
        deg = min(max_degree, self.adj0.shape[1])
        scale = max(float(np.abs(x_sample).max()), 1e-20) * 1.25 / 127.0
        self._records = build_record_graph(self.data, self.adj0[:, :deg],
                                           self.norms, scale=scale)
        nw, _ = _layout(deg, self.dim)
        self._dataq = quantize_rows(self.data, self._records.scale, nw)

    def _refresh_record_rows(self, dirty_ids: torch.Tensor) -> None:
        """Repack the records of the rows whose adjacency changed."""
        g = self._records
        dirty = torch.unique(dirty_ids[dirty_ids >= 0]).to(torch.int32)
        if dirty.numel() == 0:
            return
        update_record_rows(g.rows, self._dataq, self.norms,
                           self.adj0[dirty.long(), : g.r], dirty,
                           _layout(g.r, g.d)[0])

    def _insert_batch(self, x: np.ndarray, labels: np.ndarray,
                      draw: int) -> None:
        """Insert one batch. ``draw``: how many levels to draw (the JAX
        package's padded batch size); the first ``len(x)`` are used."""
        if not self._maintain_records:
            self._records = None
        elif self._records is None:
            self._init_records_state(x)
        accel = self._maintain_records and self._records is not None
        cfg = self.cfg
        dev = self.device
        b = x.shape[0]
        b_draw = max(draw, b)
        t0 = time.perf_counter()
        ids_np = np.arange(self.n, self.n + b, dtype=np.int32)
        new_levels = self._sample_levels(b_draw)[:b]
        batch_max_level = int(new_levels.max())
        self._ensure_levels(batch_max_level)

        xf = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        xj = xf.to(self.dtype)
        self.data[self.n : self.n + b] = xj
        self.norms[self.n : self.n + b] = squared_norms(xj)
        self.levels[self.n : self.n + b] = new_levels
        self.labels[self.n : self.n + b] = labels
        self.label_to_id.update(zip(labels.tolist(), ids_np.tolist()))

        ids = torch.from_numpy(ids_np).to(dev)
        levels_t = torch.from_numpy(new_levels).to(dev)
        qn = squared_norms(xj)
        if accel:
            # the batch joins the quantized store first, so that the
            # repacked rows can hold the new ids
            self._dataq[self.n : self.n + b] = quantize_rows(
                xj, self._records.scale, _layout(self._records.r, self.dim)[0])

        # ---- phase 1: candidate pools per level from the old graph.
        # Pools store EXACT metric distances (pruning needs them on the
        # pair-distance scale).
        pools: dict[int, tuple] = {}
        if self.n > 0:
            cur = torch.full((b,), self.ep, dtype=torch.int32, device=dev)
            for lvl in range(self.max_level, -1, -1):
                adj_l = self._adj_at(lvl)
                if not (new_levels >= lvl).any():
                    cur, _ = greedy_descent(xj, self.data, self.norms, adj_l,
                                            cur, metric=self.metric)
                    continue
                if lvl == 0 and accel:
                    # the same walk over the records; their int8 distances
                    # are not used: the pool is re-distanced exactly
                    res = beam_search_records(
                        xj, self.data, self.norms, self._records,
                        cur[:, None], width=cfg.ef_construction,
                        metric=self.metric, max_hops=256,
                        expand=cfg.insert_expand,
                    )
                    pd = gathered_dists(xj, self.data, res.ids, self.metric,
                                        self.norms, exact=True)
                else:
                    res = beam_search_chunked(
                        xj, self.data, self.norms, adj_l, cur[:, None],
                        width=cfg.ef_construction, metric=self.metric,
                        max_hops=256, expand=cfg.insert_expand,
                    )
                    pd = res.dists + qn[:, None] if self.metric == "l2" \
                        else res.dists
                pools[lvl] = (pd, res.ids)
                cur = res.ids[:, 0]
        t0 = self._mark("beams", t0)

        # ---- phase 2: intra-batch candidates (one [B, B] distance block);
        # equal distances keep the lower batch position
        if b > 1:
            bb = pairwise_dists(xf, xf, self.metric, exact=True)
            bb.fill_diagonal_(float(PAD_DIST))
            take = min(cfg.ef_construction, b - 1)
            bb_d, bb_j = torch.sort(bb, dim=1, stable=True)
            bb_d, bb_j = bb_d[:, :take], bb_j[:, :take]
            del bb
            bb_ids = ids[bb_j]                  # global ids of batch peers
            bb_peer_levels = levels_t[bb_j]
        else:
            bb_d = bb_ids = bb_peer_levels = None
        t0 = self._mark("intra_batch", t0)

        # ---- phase 3: per level, prune + link, then the reverse edges
        new_edges = []   # (level, src ids, kept_i, kept_d, rows drawn)
        for lvl in range(batch_max_level, -1, -1):
            rows_np = np.nonzero(new_levels >= lvl)[0]
            if len(rows_np) == 0:
                continue
            # the JAX package's row bucket: it sizes the column draw of the
            # reverse-edge round
            bucket = 64
            while bucket < len(rows_np):
                bucket *= 2
            bucket = min(bucket, b_draw)
            rows = torch.from_numpy(rows_np).to(dev)
            parts_i, parts_d = [], []
            if lvl in pools:
                pd, pi = pools[lvl]
                parts_i.append(pi[rows])
                parts_d.append(pd[rows])
            if bb_ids is not None:
                ok = bb_peer_levels[rows] >= lvl
                parts_i.append(torch.where(ok, bb_ids[rows], PAD_ID))
                parts_d.append(torch.where(ok, bb_d[rows], PAD_DIST))
            if not parts_i:
                continue
            row_ids = ids[rows]
            kept_i, kept_d = occlusion_prune_padded(
                xj[rows], torch.cat(parts_i, 1), torch.cat(parts_d, 1),
                self.data, self.norms, max_keep=cfg.M, metric=self.metric,
                self_ids=row_ids,
            )
            adj_l = self._adj_at(lvl)
            rl = row_ids.long()
            adj_l[rl] = PAD_ID
            adj_l[rl, : cfg.M] = kept_i
            if lvl == 0 and self.adj0_d is not None:
                self.adj0_d[rl] = float(PAD_DIST)
                self.adj0_d[rl, : cfg.M] = kept_d
            new_edges.append((lvl, row_ids, kept_i, kept_d, bucket))
        t0 = self._mark("prune_link", t0)

        dirty = [ids]   # level-0 rows whose records go stale
        for lvl, src, kept_i, kept_d, bucket in new_edges:
            dsts = self._reverse_insert(lvl, src, kept_i, kept_d, bucket)
            if lvl == 0 and dsts is not None:
                dirty.append(dsts)
        t0 = self._mark("reverse_insert", t0)

        # ---- phase 4: enterpoint/bookkeeping
        if batch_max_level > self.max_level:
            self.max_level = batch_max_level
            self.ep = int(ids_np[int(np.argmax(new_levels))])
        if self.ep == PAD_ID:
            self.ep = int(ids_np[0])
        self.n += b
        if accel:
            self._refresh_record_rows(torch.cat(dirty))
            self._mark("records_refresh", t0)

    def _reverse_insert(self, lvl: int, src, kept_i, kept_d,
                        draw_rows: int):
        """Bidirectional linking with overflow re-prune
        (mutuallyConnectNewElement's second half, hnswalg.h:554-627): one
        round per level (``_reverse_insert_round``). Proposals land in a
        random column of their destination's buffer (a reservoir);
        destinations with room merge-append, overflowing ones re-prune.
        ``draw_rows``: rows of columns to draw (the JAX package's padded
        row count). Only the count of destinations crosses to the host.
        Returns the destinations (sorted), or None when there are none."""
        cap_deg = 2 * self.cfg.M if lvl == 0 else self.cfg.M
        dsts = torch.unique(kept_i[kept_i >= 0])     # sorted
        if dsts.numel() == 0:
            return None
        b, m = kept_i.shape
        cols = self._rng.integers(0, cap_deg, (max(draw_rows, b), m))[:b]
        _reverse_insert_round(
            self._adj_at(lvl),
            self.adj0_d if lvl == 0 else None,
            self.data, self.norms, kept_i, kept_d,
            torch.from_numpy(cols).to(self.device), src, dsts,
            cap_deg=cap_deg, metric=self.metric,
        )
        return dsts

    # ------------------------------------------------------------------
    # search

    def build_accel(self, max_degree: int = 30) -> None:
        """Derive the packed int8 record layout for level-0 traversal
        (models/records.py, the OptimizeGraph analogue): one row gather a
        frontier expansion; at max_degree=30 and d <= 128 a record is one
        4 KB row. Level-0 rows are ascending by distance (occlusion prune,
        sorted reverse merge), so the first ``max_degree`` columns are the
        closest neighbours. Rebuild after mutations (they drop it)."""
        deg = min(max_degree, self.adj0.shape[1])
        self._records = build_record_graph(self.data, self.adj0[:, :deg],
                                           self.norms)

    def clear_accel(self) -> None:
        self._records = None

    def _entry_points(self, q: torch.Tensor) -> torch.Tensor:
        """Level-0 entry per query ([Q] int32): the routed product over
        the level>=1 nodes when any exist, else the global enterpoint.

        Replaces the per-level greedy descent of searchKnn
        (hnswalg.h:1278-1303), see _route_entry_gemm. The descent stays
        available via knn_query(entry="descend")."""
        nq = q.shape[0]
        ep = torch.full((nq,), self.ep, dtype=torch.int32, device=self.device)
        if self.max_level < 1:
            return ep
        if self._router is None:
            up = np.nonzero(self.levels[: max(self.n, 1)] >= 1)[0]
            if up.size == 0:
                return ep
            ids_up = torch.from_numpy(up.astype(np.int32)).to(self.device)
            rows = self.data[ids_up.long()]
            # bf16 rows, as in the JAX package: the rounding decides which
            # entry wins
            self._router = (ids_up, rows.to(torch.bfloat16),
                            squared_norms(rows))
        ids_up, rows, nrm = self._router
        return _route_entry_gemm(q, rows, nrm, ids_up, self.metric)

    def _descend_entry(self, q: torch.Tensor) -> torch.Tensor:
        cur = torch.full((q.shape[0],), self.ep, dtype=torch.int32,
                         device=self.device)
        for lvl in range(self.max_level, 0, -1):
            cur, _ = greedy_descent(q, self.data, self.norms,
                                    self.adj_up[lvl - 1], cur,
                                    metric=self.metric)
        return cur

    def knn_query(
        self,
        queries,
        k: int = 1,
        ef: int | None = None,
        filter_ids: np.ndarray | None = None,
        expand: int = 1,
        entry: str = "routed",
    ):
        """Batched searchKnn (hnswalg.h:1270-1324). Returns
        (labels [Q, k] int64, dists [Q, k] exact metric values), numpy.

        filter_ids: optional bool mask [cap] over internal ids (the
        BaseFilterFunctor analogue, applied inside the traversal).
        entry: "routed" (default, one product over the level>=1 nodes) or
        "descend" (the reference's per-level greedy walk)."""
        if self.n == 0:
            raise RuntimeError("cannot query an empty index")
        ef = max(ef or self.cfg.ef, k)
        q = as_f32_queries(queries, self.device)

        if entry == "descend":
            cur = self._descend_entry(q)
        else:
            cur = self._entry_points(q)
        plain = self.num_deleted == 0 and filter_ids is None
        records = plain and self._records is not None
        if records:
            res = beam_search_records(
                q, self.data, self.norms, self._records, cur[:, None],
                width=ef, metric=self.metric, expand=expand,
            )
        elif plain:
            res = beam_search_chunked(
                q, self.data, self.norms, self.adj0, cur[:, None],
                width=ef, metric=self.metric, expand=expand,
            )
        else:
            # in-traversal filtering: rejected nodes stay traversable but
            # never fill result slots, and the search keeps exploring until
            # ef *accepted* results exist (searchBaseLayerST filter/deleted
            # handling, hnswalg.h:397-425). The retset width is still the
            # exploration budget, so widen it with the rejected fraction.
            accept = ~self.deleted
            if filter_ids is not None:
                accept = accept & np.asarray(filter_ids, bool)[: len(accept)]
            frac_rej = 1.0 - accept[: self.n].sum() / max(self.n, 1)
            ef_eff = min(
                int(ef * (1.0 + 3.0 * frac_rej)) + (
                    0 if filter_ids is None else ef
                ),
                max(self.n, ef),
            )
            res = beam_search_filtered(
                q, self.data, self.norms, self.adj0, cur[:, None],
                width=ef_eff, accept=torch.from_numpy(accept).to(self.device),
                metric=self.metric, expand=expand,
            )
        self.metric_hops += int(res.hops.sum())
        self.metric_distance_computations += int(res.evals.sum())
        if records:
            # int8 traversal can misorder near-ties: re-rank the retset
            # head exactly
            d, i = rerank_exact(q, self.data, self.norms,
                                res.ids[:, : min(ef, k + 16)], k,
                                metric=self.metric)
        else:
            d, i = res.dists, res.ids
            d = torch.where(i < 0, PAD_DIST, d)
            d, i = topk_smallest(d, i, k)
            if self.metric == "l2":
                d = d + squared_norms(q)[:, None]
        i_np = i.cpu().numpy()
        labels = np.where(i_np >= 0, self.labels[np.clip(i_np, 0, None)], -1)
        return labels, d.cpu().numpy()

    def epsilon_query(self, queries, epsilon: float, max_candidates: int,
                      expand: int = 1):
        """Range search: every point with metric distance <= epsilon among
        the ``max_candidates`` closest explored (searchStopConditionClosest
        + EpsilonSearchStopCondition, hnswalg.h:1327-1378,
        stop_condition.h:218-275), from the routed entry. Returns (labels
        [Q, C] int64 -1-padded, dists [Q, C], counts [Q]), numpy."""
        from .extensions import epsilon_search

        if self.n == 0:
            raise RuntimeError("cannot query an empty index")
        q = as_f32_queries(queries, self.device)
        cur = self._entry_points(q)
        d, i, counts = epsilon_search(
            q, self.data, self.norms, self.adj0, cur[:, None],
            epsilon=epsilon, max_candidates=max_candidates,
            metric=self.metric, expand=expand)
        i_np = i.cpu().numpy()
        labels = np.where(i_np >= 0, self.labels[np.clip(i_np, 0, None)], -1)
        return labels, d.cpu().numpy(), counts.cpu().numpy()

    # ------------------------------------------------------------------
    # mutation API (markDelete etc., hnswalg.h:853-992)

    def mark_deleted(self, label: int) -> None:
        iid = self.label_to_id[int(label)]
        if not self.deleted[iid]:
            self.deleted[iid] = True
            self.num_deleted += 1

    def unmark_deleted(self, label: int) -> None:
        iid = self.label_to_id[int(label)]
        if self.deleted[iid]:
            self.deleted[iid] = False
            self.num_deleted -= 1

    def is_marked_deleted(self, label: int) -> bool:
        return bool(self.deleted[self.label_to_id[int(label)]])

    def replace_point(self, slot: int, vec, label: int) -> None:
        """Reuse a (deleted) slot for a new point: the vector changes in
        place, the slot's out-links are rebuilt at its existing levels, and
        the out-links of its former neighbourhood are re-selected: the
        updatePoint / repairConnectionsForUpdate analogue (hnswalg.h:
        995-1139). Without the repair the old neighbourhood keeps edges
        chosen for the old vector, which under churn degrade recall
        (bindings_test_replace.py:155).

        The records, the router and the link-distance cache go first: an
        in-link to the slot from outside its old neighbourhood would keep
        a stale cached distance (later inserts then recompute them)."""
        self._records = None
        self._dataq = None
        self._maintain_records = False
        self._router = None
        self.adj0_d = None
        cfg = self.cfg
        dev = self.device
        x = torch.from_numpy(
            np.asarray(vec, np.float32).reshape(1, self.dim)).to(dev)
        # the old neighbourhoods, copied BEFORE the vector and the links
        # change: their link choices referenced the old point (updatePoint's
        # sCand set, hnswalg.h:1000-1032)
        node_level = int(self.levels[slot])
        old_nbrs = {lvl: self._adj_at(lvl)[slot].cpu().numpy().copy()
                    for lvl in range(node_level + 1)}
        self.data[slot] = x[0].to(self.dtype)
        self.norms[slot] = squared_norms(x)[0]
        if self.deleted[slot]:
            self.deleted[slot] = False
            self.num_deleted -= 1
        self.labels[slot] = label
        self.label_to_id[int(label)] = slot

        cur = torch.full((1,), self.ep, dtype=torch.int32, device=dev)
        sid = torch.tensor([slot], dtype=torch.int32, device=dev)
        for lvl in range(self.max_level, -1, -1):
            adj_l = self._adj_at(lvl)
            res = beam_search_chunked(
                x, self.data, self.norms, adj_l, cur[:, None],
                width=cfg.ef_construction, metric=self.metric, max_hops=256)
            cur = res.ids[:, 0]
            if lvl > node_level:
                continue
            pd = res.dists
            if self.metric == "l2":
                pd = pd + squared_norms(x)[:, None]
            kept_i, kept_d = occlusion_prune_padded(
                x, res.ids, pd, self.data, self.norms, max_keep=cfg.M,
                metric=self.metric, self_ids=sid)
            adj_l[slot] = PAD_ID
            adj_l[slot, : cfg.M] = kept_i[0]
            self._reverse_insert(lvl, sid, kept_i, kept_d, 1)
            self._repair_in_links(lvl, old_nbrs[lvl], slot)

    def _repair_in_links(self, lvl: int, nbr_ids: np.ndarray,
                         slot: int) -> None:
        """Re-select the out-links of the nodes that used to neighbour
        ``slot`` (repairConnectionsForUpdate, hnswalg.h:1074-1139): each
        such node re-runs the occlusion rule over its current links plus
        the old neighbourhood (each other and the moved node), distances
        recomputed against the new vector store."""
        nbrs = np.unique(nbr_ids[nbr_ids >= 0])
        if len(nbrs) == 0:
            return
        cap_deg = 2 * self.cfg.M if lvl == 0 else self.cfg.M
        adj_l = self._adj_at(lvl)
        dev = self.device
        rows = torch.from_numpy(nbrs.astype(np.int64)).to(dev)
        vecs = self.data[rows]
        extra = torch.from_numpy(
            np.append(nbrs, slot).astype(np.int32)).to(dev)
        pool_i = torch.cat(
            [adj_l[rows, :cap_deg], extra.expand(len(nbrs), -1)], 1)
        pool_d = gathered_dists(vecs, self.data, pool_i, self.metric,
                                self.norms, exact=True)
        kept_i, _ = occlusion_prune_padded(
            vecs, pool_i, pool_d, self.data, self.norms, max_keep=cap_deg,
            metric=self.metric, self_ids=rows.to(torch.int32))
        adj_l[rows, :cap_deg] = kept_i

    def resize_index(self, new_cap: int) -> None:
        """resizeIndex (hnswalg.h:633-656): the arena grows to ``new_cap``
        rows; it never shrinks below what it holds."""
        if new_cap < self.n:
            raise ValueError("new capacity below current element count")
        self.max_elements = int(new_cap)
        self._draw_cap = max(self._draw_cap, _arena_cap(new_cap))
        grow = int(new_cap) - self.cap
        if grow <= 0:
            return
        self._records = None
        self._dataq = None
        self._router = None
        dev = self.device

        def grown(t, fill):
            pad = torch.full((grow, *t.shape[1:]), fill, dtype=t.dtype,
                             device=dev)
            return torch.cat([t, pad])

        self.data = grown(self.data, 0)
        self.norms = grown(self.norms, 0)
        self.adj0 = grown(self.adj0, PAD_ID)
        if self.adj0_d is not None:
            self.adj0_d = grown(self.adj0_d, float(PAD_DIST))
        self.adj_up = [grown(a, PAD_ID) for a in self.adj_up]
        self.levels = np.concatenate([self.levels, np.zeros(grow, np.int32)])
        self.deleted = np.concatenate([self.deleted, np.zeros(grow, bool)])
        self.labels = np.concatenate(
            [self.labels, np.full(grow, -1, np.int64)]
        )
        self.cap = int(new_cap)

    def get_items(self, labels) -> np.ndarray:
        iids = np.array([self.label_to_id[int(l)]
                         for l in np.atleast_1d(labels)])
        return self.data[torch.from_numpy(iids).to(self.device)].cpu().numpy()

    def get_ids_list(self):
        return [int(l) for l in self.labels[: self.n] if l >= 0]

    # ------------------------------------------------------------------
    # integrity / persistence

    def check_integrity(self) -> bool:
        """checkIntegrity (hnswalg.h:1381-1410): degree bounds, no self or
        duplicate edges, positive inbound degree."""
        inbound = np.zeros(self.n, np.int64)
        for lvl in range(0, self.max_level + 1):
            adj = self._adj_at(lvl)[: self.n].cpu().numpy()
            cap_deg = 2 * self.cfg.M if lvl == 0 else self.cfg.M
            live = self.levels[: self.n] >= lvl
            rows = adj[live]
            if ((rows >= 0).sum(axis=1) > cap_deg).any():
                return False
            row_ids = np.nonzero(live)[0]
            if (rows == row_ids[:, None]).any():
                return False
            srt = np.sort(rows, axis=1)
            if ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any():
                return False
            inbound += np.bincount(rows[rows >= 0], minlength=self.n)
        return bool((inbound > 0).all() or self.n <= 1)

    def _arrays(self):
        """The index as host numpy arrays, cut to the n live rows."""
        n = self.n
        return dict(
            data=self.data[:n].cpu().numpy(),
            adj0=self.adj0[:n].cpu().numpy(),
            adj_up=[a[:n].cpu().numpy() for a in self.adj_up],
            levels=self.levels[:n].copy(),
            labels=self.labels[:n].copy(),
            deleted=self.deleted[:n].copy(),
        )

    def save(self, path: str) -> None:
        """The JAX package's .npz, at exactly ``path``."""
        a = self._arrays()
        with open(path, "wb") as f:   # a file object: no ".npz" appended
            np.savez(
                f,
                data=a["data"], adj0=a["adj0"],
                adj_up=np.stack(a["adj_up"]) if a["adj_up"]
                else np.zeros((0, self.n, self.cfg.M), np.int32),
                levels=a["levels"], labels=a["labels"], deleted=a["deleted"],
                meta=np.array(
                    [self.n, self.cap, self.max_level, self.ep, self.cfg.M,
                     self.cfg.ef_construction, self.num_deleted]
                ),
                metric=self.metric,
            )

    def save_hnswlib_format(self, path: str) -> None:
        """Write the reference's binary index format (hnswalg.h:685-713),
        loadable by stock hnswlib."""
        from ..utils.hnswlib_format import write_hnswlib_index

        a = self._arrays()
        write_hnswlib_index(
            path, a["data"], a["labels"], a["levels"], a["adj0"],
            a["adj_up"], a["deleted"],
            m=self.cfg.M,
            ef_construction=self.cfg.ef_construction,
            enterpoint=self.ep,
            maxlevel=self.max_level,
            mult=self.cfg.mult,
        )

    @classmethod
    def _from_arrays(cls, data, adj0, adj_up, levels, labels, deleted, *,
                     cap, cfg, metric, max_level, ep, device=None):
        """An index over host arrays of n rows (what save, the hnswlib
        reader and pickle hand back). Link rows wider than the index's are
        cut, narrower ones padded. Link distances are unknown afterwards
        (adj0_d None)."""
        n = data.shape[0]
        idx = cls(data.shape[1], cap, cfg, metric, device=device)
        dev = idx.device
        idx.n = n
        idx.max_level = int(max_level)
        idx.ep = int(ep)

        def fit(a, width):
            out = np.full((n, width), PAD_ID, np.int32)
            w = min(width, a.shape[1])
            out[:, :w] = a[:, :w]
            return torch.from_numpy(out).to(dev)

        x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev)
        idx.data[:n] = x
        idx.norms[:n] = squared_norms(x)
        idx.adj0[:n] = fit(adj0, 2 * cfg.M)
        idx.adj0_d = None
        idx.adj_up = []
        idx._ensure_levels(len(adj_up))
        for dst, a in zip(idx.adj_up, adj_up):
            dst[:n] = fit(a, cfg.M)
        idx.levels[:n] = levels
        idx.labels[:n] = labels
        idx.deleted[:n] = deleted
        idx.num_deleted = int(np.asarray(deleted).sum())
        idx.label_to_id = {
            int(l): i for i, l in enumerate(labels) if l >= 0
        }
        return idx

    @classmethod
    def load_hnswlib_format(
        cls, path: str, metric: str = "l2",
        max_elements: int | None = None, device=None,
    ) -> "HNSWIndex":
        """Load an index written by the reference (or by
        save_hnswlib_format) onto ``device`` (default: the card)."""
        from ..utils.hnswlib_format import read_hnswlib_index

        z = read_hnswlib_index(path)
        n = z["data"].shape[0]
        return cls._from_arrays(
            z["data"], z["adj0"], z["adj_up"], z["levels"], z["labels"],
            z["deleted"], cap=max(max_elements or z["max_elements"], n),
            cfg=HNSWConfig(M=z["M"], ef_construction=z["ef_construction"]),
            metric=metric, max_level=z["maxlevel"], ep=z["enterpoint"],
            device=device)

    @classmethod
    def load(cls, path: str, max_elements: int | None = None,
             device=None) -> "HNSWIndex":
        """Read a .npz written by either package onto ``device`` (default:
        the card)."""
        z = np.load(path, allow_pickle=False)
        n, cap, max_level, ep, m, efc, _ = (int(v) for v in z["meta"])
        return cls._from_arrays(
            z["data"], z["adj0"], list(z["adj_up"]), z["levels"],
            z["labels"], z["deleted"], cap=max(max_elements or cap, n),
            cfg=HNSWConfig(M=m, ef_construction=efc), metric=str(z["metric"]),
            max_level=max_level, ep=ep, device=device)
