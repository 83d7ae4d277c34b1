"""Sharded indexes over a list of devices: per-shard search and a top-k
merge (counterpart of hnsw_nsg_tpu/parallel/mesh.py).

The reference's cluster-sharded search (independent per-cluster
sub-indexes, searched selectively, results merged under a mutex,
CNNS/tests/cluster_hnsw_nsg_search_pipeline.cpp:194-212 merge_topk_queue)
runs here from one controller over a ``Mesh``: a numpy array of
``torch.device`` s with the JAX package's axis names, ``("shard",)`` or
``("dcn", "shard")``. Each shard's rows, graph or cluster slabs are
tensors on that shard's device; the controller runs every shard's search
in turn (CUDA launches are asynchronous, so shards on different cards
overlap) and merges:

  * the merge is the JAX package's all-gather: each shard's [Q, k]
    (dist, id) pair moves to the mesh's first device, in shard order, and
    one stable top-k keeps the k smallest, ties to the earlier shard;
  * a mesh may name one device several times (``["cuda"] * 4``: four
    logical shards on one card, or ``["cpu"] * 8`` in the tests), so its
    merges run where there is only one card.

What the JAX module does with ``shard_map``, ``NamedSharding`` and
``device_put`` is done with per-shard tensors on explicit devices. Two
results differ from the JAX module's on purpose:

  * ``ShardedCNNSIndex`` and ``MultiSliceCNNSIndex`` apply the index's
    query transform (``qshift``, ``qscale``, the int8 query cast) and the
    ``qscale ** 2`` rescale that ``CNNSIndex.search`` applies. The JAX
    classes drop them, so a sharded uint8 or SQ8 index ranks with wrong
    distances there (ROADMAP F-R9);
  * their per-shard scan is the grouped cluster scan
    (``ops/cluster_scan.py``) over the shard's f32 slabs, where the JAX
    code gathers an f32 slab per (query, slot) for an einsum (8.6 GB a
    slot at Q = 8192, maxc = 2056, d = 128). The pairs are inverted into
    per-cluster query lists as ``CNNSIndex`` does; a cluster whose list
    passes the list width goes on in further launches over just the
    over-full clusters, so every owned (query, slot) pair is scanned, as
    in the JAX code. Each pair's top-k comes back to its (query, slot)
    cell and one stable top-k over the slots in slot order gives the JAX
    code's sequential merges: ties to the lower slab position, then to
    the earlier slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.beam import beam_search
from ..models.cnns import (
    _invert_pairs, _route_clusters, _scan_bias, _scan_lists, dedup_topk,
)
from ..ops.bruteforce import brute_force_topk
from ..ops.distance import (
    PAD_DIST, PAD_ID, as_f32_queries, pairwise_dists, squared_norms,
)
from ..ops.topk import topk_smallest

AXIS = "shard"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An array of ``torch.device`` s with one name per axis."""

    devices: np.ndarray       # object array of torch.device
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that routing and the merges run on."""
        return self.devices.flat[0]


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def _all_devices(devices):
    """``devices``, or every visible card. Raises when neither exists (the
    rule of ``utils/device.py:resolve_device``)."""
    if devices is not None:
        return list(devices)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible and no devices were given: pass "
            "devices=['cpu'] * n to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default:
    every visible card)."""
    devices = _all_devices(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"{n} devices asked for, {len(devices)} given")
    return Mesh(_device_array(devices[:n], (n,)), (AXIS,))


def make_multislice_mesh(n_slices: int, devices=None) -> Mesh:
    """2-D mesh (dcn, shard): the outer axis models the slow inter-slice
    links, the inner axis a slice's shards."""
    devices = _all_devices(devices)
    n = len(devices)
    if n % n_slices:
        raise ValueError(f"{n} devices do not split into {n_slices} slices")
    return Mesh(_device_array(devices, (n_slices, n // n_slices)),
                (DCN_AXIS, AXIS))


def _shard_devices(mesh: Mesh) -> list:
    if mesh.axis_names != (AXIS,):
        raise ValueError(f"expected a 1-D {AXIS!r} mesh, got {mesh.shape}")
    return list(mesh.devices)


def _merge_allgather(parts, k: int, device):
    """Each shard's [Q, kk] (dists, ids), in shard order, merged on
    ``device``: the k smallest, ties to the earlier shard."""
    dd = torch.cat([d.to(device) for d, _ in parts], 1)
    ii = torch.cat([i.to(device) for _, i in parts], 1)
    return topk_smallest(dd, ii, k)


def _pad_cols(d, i, k: int):
    """Widen [Q, k'] (dists, ids) to k columns with PAD entries."""
    short = k - d.shape[1]
    if short <= 0:
        return d, i
    qn = d.shape[0]
    return (torch.cat([d, torch.full((qn, short), float(PAD_DIST),
                                     device=d.device)], 1),
            torch.cat([i, torch.full((qn, short), PAD_ID, dtype=i.dtype,
                                     device=i.device)], 1))


def _row_shards(data, s: int, devices, pad: bool):
    """Rows of ``data`` (numpy or a tensor) cut into s equal blocks, each
    on its device; with ``pad`` the last rows are zeros up to s * ceil(n /
    s), else n must split evenly."""
    x = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    n = x.shape[0]
    rows = -(-n // s)
    if rows * s != n and not pad:
        raise ValueError(f"{n} rows do not split over {s} shards")
    out = []
    for m, dev in enumerate(devices):
        blk = x[m * rows : (m + 1) * rows].to(dev)
        if blk.shape[0] < rows:
            blk = torch.cat([blk, torch.zeros(
                (rows - blk.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                device=dev)])
        out.append(blk.contiguous())
    return out


@dataclasses.dataclass
class ShardedFlatIndex:
    """Row-sharded exact search: the distributed BruteforceSearch and the
    recall oracle for sharded configurations."""

    mesh: Mesh
    data: list          # per shard [rows, d], on its device
    n: int

    @classmethod
    def build(cls, mesh: Mesh, data) -> "ShardedFlatIndex":
        devs = _shard_devices(mesh)
        return cls(mesh=mesh, data=_row_shards(data, len(devs), devs, True),
                   n=int(data.shape[0]))

    def search(self, queries, k: int):
        """Returns (dists [Q, k] exact, global ids [Q, k] int64) on the
        mesh's first device. Each shard takes the tiled brute force over
        its rows; pad rows are masked by index."""
        q = as_f32_queries(queries)
        rows = self.data[0].shape[0]
        parts = []
        for m, xs in enumerate(self.data):
            valid = min(max(self.n - m * rows, 0), rows)
            d, i = brute_force_topk(q.to(xs.device), xs, min(k, rows),
                                    valid_n=valid)
            parts.append((d, torch.where(i >= 0, i + m * rows, PAD_ID)))
        return _merge_allgather(parts, k, self.mesh.first)


def _next_pow2_int(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


@dataclasses.dataclass
class ShardedGraphIndex:
    """Row-sharded graph index with routed probing: each shard owns an
    independent sub-graph (cluster sharding, SURVEY.md §2.9), a table of
    representatives routes every query to its ``nprobe`` most promising
    shards (min representative distance, the reference's
    sort_by_min_dist ablation), and each shard beams only the queries
    routed to it, compacted in query order to at most ``q_slots`` rows.

    Unequal shards are padded to the largest (pad rows carry PAD
    adjacency and are never entered: entries are representatives, which
    are real rows)."""

    mesh: Mesh
    data: list           # per shard [rows_pad, d] f32, on its device
    norms: list          # per shard [rows_pad]
    adj: list            # per shard [rows_pad, R] int32, LOCAL ids
    rep_ids: list        # per shard [n_reps] int64 local ids
    reps: torch.Tensor   # [S, n_reps, d] on the mesh's first device
    n: int               # total real rows
    n_shard: tuple       # real rows per shard

    @property
    def rows_pad(self) -> int:
        return self.data[0].shape[0]

    @classmethod
    def build_from_shards(cls, mesh: Mesh, datas, adjs, eps=None,
                          n_reps: int = 32, seed: int = 0):
        """datas/adjs: per-shard lists (local ids; row counts may differ:
        rows pad to the largest). ``eps`` (optional per-shard entry ids)
        join the representative set; the rest are a seeded row sample
        (the JAX package's draws)."""
        devs = _shard_devices(mesh)
        s = len(devs)
        assert len(datas) == s, (len(datas), s)
        rng = np.random.default_rng(seed)
        rows_pad = max(x.shape[0] for x in datas)
        deg = max(a.shape[1] for a in adjs)
        d = datas[0].shape[1]
        reps = np.zeros((s, n_reps, d), np.float32)
        data_l, norms_l, adj_l, rep_l, n_shard = [], [], [], [], []
        for m, dev in enumerate(devs):
            x = np.asarray(datas[m], np.float32)
            a = np.asarray(adjs[m], np.int32)
            ns_m = x.shape[0]
            n_shard.append(ns_m)
            xp = np.zeros((rows_pad, d), np.float32)
            xp[:ns_m] = x
            ap = np.full((rows_pad, deg), PAD_ID, np.int32)
            ap[:ns_m, : a.shape[1]] = a
            sample = rng.choice(ns_m, min(n_reps, ns_m), replace=False)
            if eps is not None:
                sample[0] = int(eps[m])
            rid = np.resize(sample, n_reps)
            reps[m] = x[rid]
            xt = torch.from_numpy(xp).to(dev)
            data_l.append(xt)
            norms_l.append(squared_norms(xt))
            adj_l.append(torch.from_numpy(ap).to(dev))
            rep_l.append(torch.from_numpy(rid.astype(np.int64)).to(dev))
        return cls(mesh=mesh, data=data_l, norms=norms_l, adj=adj_l,
                   rep_ids=rep_l, reps=torch.from_numpy(reps).to(mesh.first),
                   n=sum(n_shard), n_shard=tuple(n_shard))

    def search(self, queries, k: int, l_search: int = 64,
               max_hops: int = 256, expand: int = 1,
               nprobe: int = 1, q_slots: int | None = None,
               init_width: int = 4):
        """Returns (dists [Q, k], global ids [Q, k] int32, evals [S]
        int32), on the mesh's first device. Global id = shard * rows_pad +
        local id.

        nprobe: shards probed per query (min-rep-distance rank, ties to the
        lower shard). q_slots: per-shard query capacity (default: 2x the
        balanced share, a power of two); owned queries past it are dropped
        in query order, the early-stop analogue. Each shard's beam is the
        while-loop ``beam_search`` from the ``init_width`` representatives
        of that shard nearest the query."""
        dev0 = self.mesh.first
        q = as_f32_queries(queries, dev0)
        qn = q.shape[0]
        s = len(self.data)
        nprobe = min(nprobe, s)
        if q_slots is None:
            fair = -(-qn * nprobe // s)
            q_slots = min(qn, _next_pow2_int(2 * fair))
        n_reps = self.reps.shape[1]
        init_width = min(init_width, n_reps)

        # replicated routing: min distance to any representative of a shard
        rd = pairwise_dists(q, self.reps.reshape(s * n_reps, -1), "l2",
                            exact=False)
        rd = rd.reshape(qn, s, n_reps).amin(2)                  # [Q, S]
        visit = torch.sort(rd, dim=1, stable=True).indices[:, :nprobe]

        parts, evals = [], []
        for m in range(s):
            dev = self.data[m].device
            own = (visit == m).any(1).nonzero()[:, 0][:q_slots]
            ld = torch.full((qn, k), float(PAD_DIST), device=dev)
            li = torch.full((qn, k), PAD_ID, dtype=torch.int32, device=dev)
            n_ev = torch.zeros((), dtype=torch.int64, device=dev)
            if own.numel():
                qq = q[own].to(dev)
                rids = self.rep_ids[m]
                dr = pairwise_dists(qq, self.data[m][rids], "l2",
                                    exact=False)
                near = torch.sort(dr, dim=1, stable=True).indices[
                    :, :init_width]
                res = beam_search(qq, self.data[m], self.norms[m],
                                  self.adj[m], rids[near], width=l_search,
                                  max_hops=max_hops, expand=expand)
                ids = res.ids[:, :k]
                gid = torch.where(ids >= 0, ids + m * self.rows_pad, PAD_ID)
                dd = torch.where(gid >= 0, res.dists[:, :k]
                                 + squared_norms(qq)[:, None], PAD_DIST)
                own_d = own.to(dev)
                ld[own_d] = dd
                li[own_d] = gid.to(torch.int32)
                n_ev = res.evals.sum()
            parts.append((ld, li))
            evals.append(n_ev.to(dev0))
        gd, gi = _merge_allgather(parts, k, dev0)
        return gd, gi, torch.stack(evals).to(torch.int32)


def _owned_slots(visit, s: int, m: int, slots: int):
    """Shard m's probes of each query row, compacted to ``slots`` columns
    in routing-rank order (local cluster ids, PAD_ID padded); owned
    probes past ``slots`` are dropped. Cluster c lives on shard c % s as
    its local cluster c // s."""
    owned = (visit >= 0) & (visit % s == m)
    local = torch.where(owned, visit // s, PAD_ID)
    np_w = visit.shape[1]
    rank = torch.arange(np_w, device=visit.device)
    key = torch.where(owned, np_w - rank, -1)
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    order = order[:, : min(slots, np_w)]
    sel = torch.gather(local, 1, order)
    return torch.where(torch.gather(key, 1, order) >= 0, sel, PAD_ID)


def _list_width(n_pairs: int, c: int) -> int:
    """``CNNSIndex._search_flat``'s list width: a power of two from 8 that
    gives room for twice the mean demand, at most 512."""
    cap = 8
    while cap * c < 2 * n_pairs and cap < 512:
        cap *= 2
    return cap


def _scan_owned(qc, sel, slabs, ids_c, bias, k: int, scale: float):
    """Every (query, slot) pair of ``sel`` [Q, slots] (local cluster ids)
    scanned by the grouped scan: each pair's k smallest (FastL2 or 1 -
    dot, global ids) at out[q, slot], PAD elsewhere. The first launch
    takes the first ``_list_width`` pairs of every cluster's list; each
    further launch the next as many of the clusters still holding some,
    their slabs gathered into a buffer of their own."""
    qn, npr = sel.shape
    c = ids_c.shape[0]
    dev = sel.device
    out_d = torch.full((qn, npr, k), float(PAD_DIST), device=dev)
    out_i = torch.full((qn, npr, k), PAD_ID, dtype=ids_c.dtype, device=dev)
    sq, scid, pos, slot = _invert_pairs(sel, c)
    real = scid < c
    n_pairs = int(real.sum())
    if n_pairs == 0:
        return out_d, out_i
    demand = int(pos[real].max()) + 1
    cap = _list_width(n_pairs, c)
    for p0 in range(0, demand, cap):
        part = real & (pos >= p0) & (pos < p0 + cap)
        pc, pp = scid[part], pos[part] - p0
        if p0 == 0:
            rows, x_c, i_c, b_c = pc, slabs, ids_c, bias
        else:
            hot = torch.unique(pc)
            rows = torch.searchsorted(hot, pc)
            x_c, i_c, b_c = slabs[hot], ids_c[hot], bias[hot]
        qidx = torch.full((i_c.shape[0], cap), PAD_ID, dtype=torch.int32,
                          device=dev)
        qidx[rows, pp] = sq[part].to(torch.int32)
        td, gi = _scan_lists(qc, qidx, x_c, i_c, b_c, k, scale)
        out_d[sq[part], slot[part]] = td[rows, pp]
        out_i[sq[part], slot[part]] = gi[rows, pp]
    return out_d, out_i


@dataclasses.dataclass
class ShardedCNNSIndex:
    """Cluster-sharded CNNS with routed probing (SURVEY.md §2.9).

    Clusters are dealt round-robin over the mesh axis (cluster c lives on
    shard c % S; empty clusters pad C to a multiple of S). Routing runs on
    the mesh's first device over the representatives, and each shard then
    scans only the probed clusters it owns: a query's nprobe probes hit a
    shard ~Binomial(nprobe, 1/S) times, so each shard compacts its owned
    probes into ``slots = ceil(nprobe/S)+1`` slots (owned probes past that
    are dropped, like the reference's early stop skipping low-ranked
    clusters, cluster_hnsw_nsg_search.cpp:237-251). ``search`` also
    returns per-shard distance-evaluation counts (the live slots of each
    scanned cluster), so selectivity is observable."""

    mesh: Mesh
    reps: torch.Tensor        # [C, m+1, d] f32 on the mesh's first device
    data_c: list              # per shard [C_pad/S, maxc, d] f32 slabs
    ids_c: list               # per shard [C_pad/S, maxc] int32 global ids
    cnorms_c: list            # per shard [C_pad/S, maxc] f32
    n_clusters: int           # the REAL cluster count (F-H2)
    metric: str = "l2"
    replicated: bool = False  # slabs carry replicas -> dedup merge
    # the index's query transform (F-R9): q -> (q - qshift) / qscale, then
    # rounded ("round": uint8 data in int8 slabs) or bf16-rounded ("bf16":
    # SQ8) as CNNSIndex casts it; distances scaled back by qscale ** 2
    qshift: object = 0.0
    qscale: float = 1.0
    q_cast: str | None = None

    @classmethod
    def build(cls, mesh: Mesh, idx) -> "ShardedCNNSIndex":
        """Redistribute a built ``CNNSIndex`` over the mesh: shard m gets
        the clusters c % S == m as f32 slabs on its device."""
        devs = _shard_devices(mesh)
        s = len(devs)
        c, maxc, d = idx.data_c.shape
        per = -(-c // s)
        data_l, ids_l, nrm_l = [], [], []
        for m, dev in enumerate(devs):
            slabs = idx.data_c[m::s].to(dev).float()
            ids = idx.ids_c[m::s].to(dev, torch.int32)
            short = per - slabs.shape[0]
            if short:
                slabs = torch.cat([slabs, torch.zeros((short, maxc, d),
                                                      device=dev)])
                ids = torch.cat([ids, torch.full((short, maxc), PAD_ID,
                                                 dtype=torch.int32,
                                                 device=dev)])
            data_l.append(slabs.contiguous())
            ids_l.append(ids.contiguous())
            nrm_l.append(squared_norms(slabs))
        q_cast = None
        if idx.data_c.dtype == torch.int8:
            q_cast = "round" if idx.qscale == 1.0 else "bf16"
        return cls(mesh=mesh, reps=idx.reps.float().to(mesh.first),
                   data_c=data_l, ids_c=ids_l, cnorms_c=nrm_l,
                   n_clusters=int(idx.n_real or c), metric=idx.metric,
                   replicated=bool(idx.replicated), qshift=idx.qshift,
                   qscale=float(idx.qscale), q_cast=q_cast)

    def search(self, queries, k: int, nprobe: int = 4,
               slots: int | None = None):
        """Returns (dists [Q, k], global ids [Q, k] int32, evals [S]
        int64), on the mesh's first device; distances in the metric's
        units, as ``CNNSIndex.search`` gives them."""
        dev0 = self.mesh.first
        q = as_f32_queries(queries, dev0)
        if self.qscale != 1.0 or np.any(self.qshift):
            shift = torch.as_tensor(np.asarray(self.qshift, np.float32),
                                    device=dev0)
            q = (q - shift) / np.float32(self.qscale)
        s = len(self.data_c)
        slots = slots or min(nprobe, -(-nprobe // s) + 1)
        nprobe = min(nprobe, self.n_clusters)
        # n_valid masks the sentinel representative rows by INDEX: for the
        # ip metric a huge-magnitude rep would win routing by value (F-H2)
        visit = _route_clusters(q, self.reps, nprobe, self.metric,
                                n_valid=self.n_clusters)
        visit = torch.where(visit < self.n_clusters, visit, PAD_ID)
        # a replicated id can surface from two probed clusters: carry 2k
        # through the shard merges and the cross-shard merge, dedup after
        kk = 2 * k if self.replicated else k
        qc = q
        if self.q_cast == "round":
            qc = torch.round(q)
        elif self.q_cast == "bf16":
            qc = q.to(torch.bfloat16).float()
        qnorm = squared_norms(q)
        parts, evals = [], []
        for m in range(s):
            slabs, ids = self.data_c[m], self.ids_c[m]
            dev = slabs.device
            sel = _owned_slots(visit, s, m, slots).to(dev)
            ks = min(kk, ids.shape[1])
            bias, scale = _scan_bias(ids, self.cnorms_c[m], self.metric)
            out_d, out_i = _scan_owned(qc.to(dev), sel, slabs, ids, bias,
                                       ks, scale)
            if self.metric == "l2":
                out_d = torch.where(out_i >= 0, out_d + qnorm.to(dev)[
                    :, None, None], PAD_DIST)
            qn, npr = sel.shape
            ld, li = topk_smallest(out_d.reshape(qn, npr * ks),
                                   out_i.reshape(qn, npr * ks),
                                   min(kk, npr * ks))
            parts.append(_pad_cols(ld, li, kk))
            live = (ids >= 0).sum(1)
            evals.append(live[sel[sel >= 0].long()].sum().to(dev0))
        gd, gi = _merge_allgather(parts, kk, dev0)
        if self.replicated:
            gd, gi = dedup_topk(gd, gi, k)
        if self.qscale != 1.0:
            # metric units; filled slots only (F-R2)
            gd = torch.where(gi >= 0, gd * np.float32(self.qscale) ** 2, gd)
        return gd, gi, torch.stack(evals)


@dataclasses.dataclass
class MultiSliceCNNSIndex:
    """Multi-slice serving layout: the index is held whole by each slice
    (its clusters sharded over the slice's shards), and the query batch
    splits over the slices, so every query is answered within one slice
    and no candidate set crosses the slow inter-slice links. Each slice is
    a ``ShardedCNNSIndex`` over its row of the (dcn, shard) mesh."""

    mesh: Mesh
    slices: list        # one ShardedCNNSIndex per slice

    @property
    def n_clusters(self) -> int:
        return self.slices[0].n_clusters

    @property
    def replicated(self) -> bool:
        return self.slices[0].replicated

    @classmethod
    def build(cls, mesh: Mesh, idx) -> "MultiSliceCNNSIndex":
        if mesh.axis_names != (DCN_AXIS, AXIS):
            raise ValueError(f"expected a ({DCN_AXIS!r}, {AXIS!r}) mesh")
        return cls(mesh=mesh, slices=[
            ShardedCNNSIndex.build(Mesh(row, (AXIS,)), idx)
            for row in mesh.devices])

    def search(self, queries, k: int, nprobe: int = 4,
               slots: int | None = None):
        """Returns (dists [Q, k], ids [Q, k], evals [n_slices, S]) on the
        mesh's first device; slice i answers the i-th of n_slices equal
        blocks of query rows."""
        q = as_f32_queries(queries)
        n_sl = len(self.slices)
        if q.shape[0] % n_sl:
            raise ValueError(
                f"query batch {q.shape[0]} not divisible by {n_sl} slices")
        dev0 = self.mesh.first
        outs = [sl.search(part, k, nprobe, slots)
                for sl, part in zip(self.slices, q.chunk(n_sl))]
        return (torch.cat([o[0].to(dev0) for o in outs]),
                torch.cat([o[1].to(dev0) for o in outs]),
                torch.stack([o[2].to(dev0) for o in outs]))


def sharded_knn_build_step(mesh: Mesh, data_sharded, k: int):
    """One distributed kNN-graph build step: each shard computes the exact
    kNN rows of its own points against all rows gathered onto its device
    (``brute_force_topk`` at k + 1, then the self edge dropped, order
    kept). ``data_sharded``: a list of per-shard row blocks, one per mesh
    device, or all rows (numpy or a tensor) to split evenly. Returns the
    [N, k] int32 adjacency (global ids, PAD_ID where a row has fewer than
    k others) on the mesh's first device."""
    devs = _shard_devices(mesh)
    shards = (list(data_sharded) if isinstance(data_sharded, (list, tuple))
              else _row_shards(data_sharded, len(devs), devs, False))
    rows = shards[0].shape[0]
    full_on = {}
    out = []
    for m, (dev, xs) in enumerate(zip(devs, shards)):
        if dev not in full_on:
            full_on[dev] = torch.cat([t.to(dev) for t in shards])
        _, ids = brute_force_topk(xs.to(dev), full_on[dev], k + 1)
        self_col = m * rows + torch.arange(rows, device=dev)[:, None]
        not_self = ids != self_col
        order = torch.sort((~not_self).to(torch.uint8), dim=1,
                           stable=True).indices
        ids = torch.gather(ids, 1, order)[:, :k]
        keep = torch.gather(not_self, 1, order)[:, :k]
        out.append(torch.where(keep, ids, PAD_ID).to(torch.int32))
    return torch.cat([o.to(mesh.first) for o in out])
