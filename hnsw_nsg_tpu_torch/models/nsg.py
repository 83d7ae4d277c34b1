"""NSG (Navigating Spreading-out Graph): build and search
(counterpart of hnsw_nsg_tpu/models/nsg.py).

Reference: ``IndexNSG`` (CNNS/src/nsg/index_nsg.cpp). Build (``Build``,
:465-504):

  1. medoid entry point: the point nearest the dataset centroid (exact);
  2. per node, a candidate pool by graph search from the medoid
     (``get_neighbors``, :150-285): ``beam_search_collect_chunked`` over
     the input kNN graph, batched over node blocks;
  3. MRNG occlusion pruning (``sync_prune``, :305-355) with scan cap C
     and degree cap R;
  4. reverse-edge insertion (``InterInsert``, :357-424), bulk-synchronous
     on the host (numpy), overflowing rows re-pruned on the device;
  5. connectivity repair (``tree_grow``, :684-764): host BFS, unreachable
     components attached through graph searches for their
     representatives.

Search (``Search``, :506-568): init = the medoid's neighbors plus a
random fill to L_search, then the lockstep beam (``models/beam.py``), or,
after ``build_accel``, the beam over the packed int8 records
(``models/records.py``) and an exact re-rank of the retset head.

Everything but stages 4-5 runs on the device of the data. Not carried
over from the JAX package: ``pad_to_bucket`` (a compile-cache workaround)
and the donated update-slice accumulation (plain copies into
preallocated tensors replace it). Random fills draw from a
``torch.Generator`` seeded by ``seed``: the same seed gives the same
fill on a device, not the JAX package's numbers.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops.bruteforce import brute_force_topk
from ..ops.distance import PAD_DIST, PAD_ID, gathered_dists, squared_norms
from ..utils import io as io_utils
from ..utils.device import resolve_device
from ..utils.params import NSGBuildConfig
from .beam import beam_search_chunked, beam_search_collect_chunked
from .inline_graph import rerank_exact
from .prune import occlusion_prune, occlusion_prune_padded
from .records import beam_search_records, build_record_graph


def _as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor stays where it lies unless ``device`` is given; numpy goes
    to ``device``, by default the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=resolve_device(device), dtype=dtype)


def _random_ids(n: int, shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, n, shape, generator=gen, device=device,
                         dtype=torch.int32)


@dataclasses.dataclass
class NSGIndex:
    """Search-time NSG: padded adjacency + entry point, on one device."""

    data: torch.Tensor     # [N, d]
    norms: torch.Tensor    # [N]
    adj: torch.Tensor      # [N, R] int32, PAD_ID-padded
    ep: int                # medoid entry point
    metric: str = "l2"
    # packed int8 record layout (models/records.py): one row gather per
    # expansion instead of R; made by build_accel()
    records: object = dataclasses.field(default=None, compare=False)

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.adj.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def build_accel(self, chunk: int = 1 << 16) -> None:
        """Derive the packed int8 record layout over the NSG adjacency
        (the OptimizeGraph analogue, index_nsg.cpp:570-657: each node's
        search state repacked into one contiguous block). Later searches
        traverse the records (one row gather an expansion, R*(d+8) bytes,
        instead of R scattered f32 rows plus separate id and norm loads)
        and re-rank the retset head exactly."""
        self.records = build_record_graph(self.data, self.adj, self.norms,
                                          chunk=chunk)

    def _beam(self, q, init, k, l_search, expand, max_hops):
        """One lockstep beam, over the records when built, else over the
        padded adjacency. Returns (exact dists, ids) [Q, k]."""
        if self.records is not None:
            res = beam_search_records(
                q, self.data, self.norms, self.records, init,
                width=l_search, metric=self.metric, expand=expand,
                max_hops=max_hops,
            )
            head = min(l_search, k + 16)
            return rerank_exact(q, self.data, self.norms,
                                res.ids[:, :head], k, metric=self.metric)
        res = beam_search_chunked(
            q, self.data, self.norms, self.adj, init, width=l_search,
            metric=self.metric, max_hops=max_hops, expand=expand,
        )
        d, i = res.dists[:, :k], res.ids[:, :k]
        if self.metric == "l2":
            d = d + squared_norms(q)[:, None]
        return d, i

    def search(self, queries, k: int, l_search: int = 100, seed: int = 0,
               expand: int = 1, max_hops: int = 512):
        """Batched NSG search (index_nsg.cpp:506-568 semantics). Queries
        go to the index's device. Returns (dists [Q, k] exact metric
        values, ids [Q, k])."""
        q = _as_tensor(queries, self.device, torch.float32)
        nq = q.shape[0]
        ep_nbrs = self.adj[self.ep]
        init = ep_nbrs[None, :].expand(nq, -1)
        n_fill = max(l_search - ep_nbrs.shape[0], 0)
        if n_fill:
            rand = _random_ids(self.n, (nq, n_fill), seed, self.device)
            init = torch.cat([init, rand], 1)
        return self._beam(q, init.contiguous(), k, l_search, expand,
                          max_hops)

    def search_from_enterpoint(self, queries, entry_ids, k: int,
                               l_search: int = 100, seed: int = 0,
                               expand: int = 1, max_hops: int = 512):
        """hnsw_nsg's SearchFromEnterpoint (hnsw_nsg/src/index_nsg.cpp:
        703-783): per-query entry id, init from its neighbors plus a 2-hop
        expansion, random fill to L."""
        q = _as_tensor(queries, self.device, torch.float32)
        nq = q.shape[0]
        entry = _as_tensor(entry_ids, self.device, torch.int32).reshape(nq)
        hop1 = self.adj[entry.long()]
        two_hop_take = min(self.width, max(l_search // self.width, 2))
        hop2 = self.adj[hop1[:, :two_hop_take].clamp(min=0).long()]
        init = torch.cat([entry[:, None], hop1, hop2.reshape(nq, -1)], 1)
        if init.shape[1] < l_search:
            rand = _random_ids(self.n, (nq, l_search - init.shape[1]), seed,
                               self.device)
            init = torch.cat([init, rand], 1)
        else:
            init = init[:, : max(l_search, self.width + 1)]
        return self._beam(q, init.contiguous(), k, l_search, expand,
                          max_hops)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's .npz: adj, ep, metric."""
        np.savez(path, adj=self.adj.cpu().numpy(), ep=self.ep,
                 metric=self.metric)

    @classmethod
    def load(cls, path: str, data, device=None) -> "NSGIndex":
        """Read a .npz written by either package, given the data (numpy
        data goes to ``device``, by default ``cuda``)."""
        z = np.load(path, allow_pickle=False)
        data = _as_tensor(data, device)
        return cls(data=data, norms=squared_norms(data),
                   adj=torch.from_numpy(z["adj"].astype(np.int32)).to(
                       data.device),
                   ep=int(z["ep"]), metric=str(z["metric"]))

    def save_reference_format(self, path: str) -> None:
        """Write the reference's .nsg byte format (index_nsg.cpp:37-49)."""
        io_utils.write_nsg(path, self.adj.cpu().numpy(), self.ep, self.width)

    @classmethod
    def load_reference_format(cls, path: str, data, metric="l2",
                              device=None) -> "NSGIndex":
        adj, ep, _ = io_utils.read_nsg(path)
        data = _as_tensor(data, device)
        return cls(data=data, norms=squared_norms(data),
                   adj=torch.from_numpy(adj).to(data.device), ep=ep,
                   metric=metric)


# ---------------------------------------------------------------------------
# Build


def find_medoid(data, metric: str = "l2", device=None) -> int:
    """Exact medoid: the point nearest the centroid (one product)."""
    x = _as_tensor(data, device)
    center = x.float().mean(0, keepdim=True)
    _, ids = brute_force_topk(center, x, 1, metric=metric)
    return int(ids[0, 0])


def _collect_and_prune_block(node_ids, data, norms, knn_adj, init_ids,
                             cfg: NSGBuildConfig, metric: str):
    """Stages 2+3 for one node block: candidate pool by graph search from
    the medoid, union with the node's kNN row, occlusion prune."""
    vecs = data[node_ids]
    _, log_ids, log_d = beam_search_collect_chunked(
        vecs, data, norms, knn_adj, init_ids, width=cfg.L, collect=cfg.C,
        metric=metric,
    )
    own_knn = knn_adj[node_ids]
    own_d = gathered_dists(vecs, data, own_knn, metric, norms)
    pool_ids = torch.cat([log_ids, own_knn], 1)
    pool_d = torch.cat([log_d, own_d], 1)
    if metric == "l2":
        # beam distances are FastL2 (no ||q||^2); the occlusion rule
        # compares them with exact pair distances, so shift to exact.
        # Padded slots stay past PAD_DIST and are dropped by the pruner.
        pool_d = pool_d + norms[node_ids][:, None]
    return occlusion_prune(vecs, pool_ids, pool_d, data, norms,
                           max_keep=cfg.R, scan_cap=cfg.C, metric=metric,
                           self_ids=node_ids)


def _interinsert(data, norms, adj_np, dists_np, cfg: NSGBuildConfig,
                 metric: str, block: int):
    """Stage 4: reverse-edge insertion (InterInsert, index_nsg.cpp:357-424),
    bulk-synchronous on the host: every edge (n -> v) proposes n as an
    in-neighbor of v. Destinations with room append; overflowing ones
    re-prune {existing + incoming} with the occlusion rule on the device.
    Mutates and returns (adj_np, dists_np)."""
    n, r = adj_np.shape
    src = np.repeat(np.arange(n, dtype=np.int32), r)
    dst = adj_np.reshape(-1)
    d = dists_np.reshape(-1)
    keep = dst >= 0
    src, dst, d = src[keep], dst[keep], d[keep]

    # drop proposals where dst already links back to src (the reference's
    # dup check), chunked to bound memory
    present = np.zeros(len(src), dtype=bool)
    chunk = 1 << 20
    for s in range(0, len(src), chunk):
        present[s : s + chunk] = (
            adj_np[dst[s : s + chunk]] == src[s : s + chunk, None]
        ).any(axis=1)
    src, dst, d = src[~present], dst[~present], d[~present]
    if len(dst) == 0:
        return adj_np, dists_np

    # group by destination, closest incoming first
    order = np.lexsort((d, dst))
    src, dst, d = src[order], dst[order], d[order]
    uniq, start_idx, counts = np.unique(dst, return_index=True,
                                        return_counts=True)
    cap_in = min(int(counts.max()), r)
    inc_ids = np.full((len(uniq), cap_in), PAD_ID, np.int32)
    inc_d = np.full((len(uniq), cap_in), PAD_DIST, np.float32)
    for col in range(cap_in):
        sel = counts > col
        inc_ids[sel, col] = src[start_idx[sel] + col]
        inc_d[sel, col] = d[start_idx[sel] + col]

    deg = (adj_np >= 0).sum(axis=1)
    n_inc = np.minimum(counts, cap_in)
    overflow = deg[uniq] + n_inc > r

    # room: append at the first free slots (the reference's free-slot path)
    room = np.nonzero(~overflow)[0]
    if len(room):
        rows = uniq[room]
        base = deg[rows]
        for col in range(cap_in):
            m = n_inc[room] > col
            adj_np[rows[m], base[m] + col] = inc_ids[room[m], col]
            dists_np[rows[m], base[m] + col] = inc_d[room[m], col]

    # overflow: batched occlusion re-prune of existing + incoming
    ov_rows = uniq[overflow]
    ov_sel = np.nonzero(overflow)[0]
    dev = data.device
    for s in range(0, len(ov_rows), block):
        rows = ov_rows[s : s + block]
        sel = ov_sel[s : s + block]
        pool_ids = np.concatenate([adj_np[rows], inc_ids[sel]], axis=1)
        pool_d = np.concatenate([dists_np[rows], inc_d[sel]], axis=1)
        rows_t = torch.from_numpy(rows.astype(np.int64)).to(dev)
        kept_i, kept_d = occlusion_prune_padded(
            data[rows_t], torch.from_numpy(pool_ids).to(dev),
            torch.from_numpy(pool_d).to(dev), data, norms, max_keep=r,
            scan_cap=pool_ids.shape[1], metric=metric, self_ids=rows_t,
        )
        adj_np[rows] = kept_i.cpu().numpy()
        dists_np[rows] = kept_d.cpu().numpy()
    return adj_np, dists_np


def _tree_grow(data, norms, adj_np, ep: int, cfg: NSGBuildConfig,
               metric: str):
    """Stage 5: connectivity repair (tree_grow/DFS/findroot,
    index_nsg.cpp:684-764). Host BFS; unreachable components are attached
    by graph searches for their representative points."""
    n, r = adj_np.shape
    dev = data.device

    def bfs_reach(seeds, visited):
        frontier = np.array(seeds, dtype=np.int64)
        visited[frontier] = True
        while len(frontier):
            nxt = adj_np[frontier].reshape(-1)
            nxt = np.unique(nxt[nxt >= 0])
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            frontier = nxt
        return visited

    visited = bfs_reach([ep], np.zeros(n, dtype=bool))
    guard = 0
    while not visited.all() and guard < 64:
        guard += 1
        reps = np.nonzero(~visited)[0][:256]
        reps_t = torch.from_numpy(reps).to(dev)
        res = beam_search_chunked(
            data[reps_t], data, norms, torch.from_numpy(adj_np).to(dev),
            torch.full((len(reps), 1), ep, dtype=torch.int32, device=dev),
            width=cfg.L, metric=metric,
        )
        ids = res.ids.cpu().numpy()   # [B, L] reachable-side candidates
        overwrote = False
        for b, root in enumerate(reps):
            if visited[root]:
                continue
            cand = ids[b]
            cand = cand[cand >= 0]
            cand = cand[visited[cand]] if len(cand) else cand
            # the closest reachable candidate with a free slot; the JAX
            # package takes the closest one and, when it is full,
            # overwrites its last edge, which can cut off a node attached
            # before (found at N = 30,000 with R = 50)
            room = cand[(adj_np[cand] >= 0).sum(1) < r] if len(cand) else cand
            attach = int(room[0] if len(room) else
                         cand[0] if len(cand) else ep)
            deg = int((adj_np[attach] >= 0).sum())
            overwrote |= deg >= r
            adj_np[attach, deg if deg < r else r - 1] = root
            visited = bfs_reach([root], visited)
        if overwrote:   # an overwritten edge may have cut a visited node off
            visited = bfs_reach([ep], np.zeros(n, dtype=bool))
    return adj_np


def build_nsg(
    data,
    knn_adj,
    cfg: NSGBuildConfig = NSGBuildConfig(),
    metric: str = "l2",
    block: int = 1024,
    ep: int | None = None,
    device=None,
    stage_seconds: dict | None = None,
) -> NSGIndex:
    """Build an NSG from a dataset and its (approximate) kNN graph.

    data [N, d], knn_adj [N, K] int32: numpy (moved to ``device``, default
    ``cuda``) or tensors (used where the data lies). Node blocks of at
    least ``block`` rows (4096 from N = 2^18) run the collect beam and
    the prune together; no result depends on the block size. When
    ``stage_seconds`` is a dict, the wall time of each stage is written
    into it (``collect_prune``, ``interinsert``, ``tree_grow``)."""

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    data = _as_tensor(data, device)
    dev = data.device
    knn_adj = _as_tensor(knn_adj, dev, torch.int32)
    n = data.shape[0]
    norms = squared_norms(data)
    if ep is None:
        ep = find_medoid(data, metric)

    t0 = time.perf_counter()
    ep_row = knn_adj[ep]
    if n >= (1 << 18):
        block = max(block, 4096)
    adj_dev = torch.full((n, cfg.R), PAD_ID, dtype=torch.int32, device=dev)
    dists_dev = torch.full((n, cfg.R), float(PAD_DIST), device=dev)
    for s in range(0, n, block):
        node_ids = torch.arange(s, min(s + block, n), device=dev)
        init = ep_row[None, :].expand(node_ids.shape[0], -1).contiguous()
        kept_i, kept_d = _collect_and_prune_block(
            node_ids, data, norms, knn_adj, init, cfg, metric)
        adj_dev[s : s + node_ids.shape[0]] = kept_i
        dists_dev[s : s + node_ids.shape[0]] = kept_d
    adj_np = adj_dev.cpu().numpy()       # writable host copies:
    dists_np = dists_dev.cpu().numpy()   # _interinsert mutates them
    del adj_dev, dists_dev
    t1 = time.perf_counter()

    adj_np, dists_np = _interinsert(data, norms, adj_np, dists_np, cfg,
                                    metric, block)
    _sync()
    t2 = time.perf_counter()
    adj_np = _tree_grow(data, norms, adj_np, ep, cfg, metric)
    _sync()
    t3 = time.perf_counter()
    if stage_seconds is not None:
        stage_seconds.update(collect_prune=t1 - t0, interinsert=t2 - t1,
                             tree_grow=t3 - t2)
    return NSGIndex(data=data, norms=norms,
                    adj=torch.from_numpy(adj_np).to(dev), ep=ep,
                    metric=metric)
