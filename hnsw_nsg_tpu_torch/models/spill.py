"""Host-spill CNNS search under a device byte budget (counterpart of
hnsw_nsg_tpu/models/spill.py).

The reference tests memory pressure by running its lazy-loading search
pipeline inside a cgroup-v2 memory limit (CNNS/script/test_with_cgroup.sh:
1-58): cluster files are mapped on demand during the query
(cluster_hnsw_nsg_search_pipeline.cpp:364-416: load task -> search task ->
merge), so the working set is the probed clusters, not the dataset.

Here device memory is the constrained tier and host memory the backing
store. ``SpillCNNSIndex`` takes a built :class:`~.cnns.CNNSIndex`, copies
its slabs, ids and norms to host memory (pinned when the index is on a
card) and keeps only the router's state (representatives, real cluster
count, metric) on the device. Each query batch:

  1. routes on the device (the representative GEMM, ``_route_clusters``);
  2. collects the probed cluster ids and packs them, in ascending order,
     into groups whose slab bytes fit ``hbm_budget_bytes``;
  3. per group: copies the group's slabs to the device once
     (``non_blocking`` from pinned memory), scans them with the same exact
     per-query probe search as the resident index (``_flat_probe_search``
     over compact slots, visits outside the group masked), and merges into
     the running global top-k.

Per probed cluster the scan is exact, so results match the resident
index's for the same visit list; the budget only changes how many rounds
are copied. ``stats`` records the rounds, the bytes moved and the largest
group, as the JAX package counts them.

The wrapped index is not kept: once the caller drops it, its device slabs
can be freed (the JAX package keeps its ``_route`` method, and with it the
whole resident index). The loop is serial, as in the JAX package: the copy
of group g + 1 does not overlap the scan of group g.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.distance import PAD_DIST, PAD_ID, as_f32_queries
from ..ops.topk import topk_smallest
from .cnns import CNNSIndex, _flat_probe_search, _route_clusters, dedup_topk


def _merge_topk(d0, i0, d1, i1, k: int):
    return topk_smallest(torch.cat([d0, d1], 1), torch.cat([i0, i1], 1), k)


@dataclasses.dataclass
class SpillStats:
    transfer_rounds: int = 0
    bytes_transferred: int = 0
    peak_group_bytes: int = 0

    def note(self, nbytes: int) -> None:
        self.transfer_rounds += 1
        self.bytes_transferred += nbytes
        self.peak_group_bytes = max(self.peak_group_bytes, nbytes)


class SpillCNNSIndex:
    """CNNS search with host-resident slabs under a device byte budget.
    Groups land on the wrapped index's device."""

    def __init__(self, idx: CNNSIndex, hbm_budget_bytes: int,
                 group_pad: int = 8):
        self.metric = idx.metric
        self.qshift = idx.qshift
        self.qscale = idx.qscale
        self.replicated = idx.replicated
        self.device = idx.device
        self.reps = idx.reps                       # the router, on the device
        self.n_real = idx.n_real or idx.reps.shape[0]
        pin = self.device.type == "cuda"

        def host(t):
            # a copy of its own, so that the index's tensors can be freed
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            return out.copy_(t)

        self.data_h = host(idx.data_c)
        self.ids_h = host(idx.ids_c)
        self.cnorms_h = (host(idx.cnorms_c) if idx.cnorms_c is not None
                         else None)
        row = lambda t: t[0].numel() * t.element_size()   # noqa: E731
        self.slab_bytes = (row(self.data_h) + row(self.ids_h)
                           + (row(self.cnorms_h)
                              if self.cnorms_h is not None else 0))
        self.group_pad = group_pad
        self.group_size = max(
            group_pad, int(hbm_budget_bytes // max(self.slab_bytes, 1))
            // group_pad * group_pad,
        )
        if self.group_size * self.slab_bytes > hbm_budget_bytes and (
            self.slab_bytes * group_pad > hbm_budget_bytes
        ):
            raise ValueError(
                f"hbm_budget_bytes={hbm_budget_bytes} below one "
                f"{group_pad}-slab group ({group_pad * self.slab_bytes} B)"
            )
        self.stats = SpillStats()
        # host staging rows of one group (pinned on a card) and the event
        # of the last copy out of them
        self._stage = None
        self._copied = None

    def _load_group(self, grp: np.ndarray):
        """The slabs, ids and norms of clusters ``grp`` on the device,
        padded with empty slabs to a multiple of ``group_pad`` rows.
        Returns (data, ids, norms, bytes copied)."""
        rows = -(-len(grp) // self.group_pad) * self.group_pad
        srcs = [self.data_h, self.ids_h]
        if self.cnorms_h is not None:
            srcs.append(self.cnorms_h)
        if self._stage is None:
            pin = self.device.type == "cuda"
            self._stage = [torch.empty((self.group_size,) + t.shape[1:],
                                       dtype=t.dtype, pin_memory=pin)
                           for t in srcs]
        if self._copied is not None:
            self._copied.synchronize()   # the last copy has left the rows
        sel = torch.from_numpy(grp.astype(np.int64))
        out = []
        for src, stage, fill in zip(srcs, self._stage, (0, PAD_ID, 0)):
            st = stage[:rows]
            torch.index_select(src, 0, sel, out=st[: len(grp)])
            st[len(grp):] = fill
            out.append(st.to(self.device, non_blocking=True))
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        data_d, ids_d = out[0], out[1]
        nrm_d = (out[2] if self.cnorms_h is not None
                 else torch.zeros(ids_d.shape, device=self.device))
        nbytes = sum(t.numel() * t.element_size()
                     for t in (data_d, ids_d, nrm_d))
        return data_d, ids_d, nrm_d, nbytes

    def search(self, queries, k: int = 100, nprobe: int = 4,
               rank_by: str = "hits"):
        """Returns (dists [Q, k] exact f32, global ids [Q, k]) on the
        device, as ``CNNSIndex.search`` with flat locals and the flat
        router returns them."""
        q = as_f32_queries(queries, self.device)
        if self.qscale != 1.0 or np.any(self.qshift):
            # slabs are stored shifted (+scaled): match the domain
            shift = torch.as_tensor(np.asarray(self.qshift, np.float32),
                                    device=self.device)
            q = (q - shift) / np.float32(self.qscale)
        nprobe = min(nprobe, self.n_real)
        visit = _route_clusters(q, self.reps, nprobe, self.metric, rank_by,
                                n_valid=self.n_real)          # [Q, V]
        nq = q.shape[0]
        c = self.data_h.shape[0]

        # replicated boundary points can surface from two probed slabs:
        # carry 2k candidates through every round's merge and dedup at the
        # end, as the resident CNNSIndex.search does
        kk = 2 * k if self.replicated else k
        probed = np.unique(visit[visit >= 0].cpu().numpy())
        best_d = torch.full((nq, kk), float(PAD_DIST), device=self.device)
        best_i = torch.full((nq, kk), PAD_ID, dtype=self.ids_h.dtype,
                            device=self.device)
        safe = torch.where(visit >= 0, visit, c)
        gs = self.group_size
        for g0 in range(0, len(probed), gs):
            grp = probed[g0 : g0 + gs]
            # this group's clusters on compact slots; visits outside the
            # group are PAD for this round
            lut = np.full(c + 1, PAD_ID, np.int64)
            lut[grp] = np.arange(len(grp))
            vis_g = torch.from_numpy(lut).to(self.device)[safe]
            data_d, ids_d, nrm_d, nbytes = self._load_group(grp)
            self.stats.note(nbytes)
            gd, gi = _flat_probe_search(
                q, vis_g, data_d, ids_d, nrm_d, kk, self.metric,
                q_round=self.qscale == 1.0)
            best_d, best_i = _merge_topk(best_d, best_i, gd, gi, kk)
            del data_d, ids_d, nrm_d
        if self.replicated:
            best_d, best_i = dedup_topk(best_d, best_i, k)
        if self.qscale != 1.0:
            # filled slots only: PAD_DIST sentinels would overflow to inf
            # at qscale >= ~2 (F-R2)
            best_d = torch.where(best_i >= 0,
                                 best_d * np.float32(self.qscale) ** 2,
                                 best_d)
        return best_d, best_i
