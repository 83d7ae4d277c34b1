"""Whether what the measured window returned is right.

Four numbers, each beside its limit:

* ``recall_at_k``: of every query answered in the window, the share of
  its exact k nearest rows (the reference's) among the k ids it got
  back, k being the traffic's. The configuration states the recall it
  is run for (``checks.recall_at_k_min``); that is the limit. It covers
  the router, which picks the clusters to scan, and every rank the
  merge returns: worse candidates or padding anywhere in the k cost it.
* ``dist_gap``: over a sample of answers drawn from the seed, the widest
  gap between a returned distance and the exact distance of the returned
  id, as a share of |q| |x|, over all k ranks. It covers the scan and the
  merge that produce the distances, and an id that does not belong to
  its distance. Its limit (``checks.dist_gap_max``) lies between the
  program's readings and the control's (``PERF.md``).
* ``unsorted``: in every row of the sampled requests, the places where a
  returned distance is below the one before it, or is not a number. A
  row comes back nearest first. Exact: the limit is 0.
* ``bad_ids``: ids that are neither a row nor the padding id -1, that
  repeat within a row, or that follow a -1 in their row. Exact: the limit
  is 0. The padding id marks a place the program left empty (its spill
  path drops pairs past its budget, and the merge sorts what is left
  first); it is never a true neighbour, so it costs recall, and its
  count is reported beside the checks.
"""

from __future__ import annotations

import numpy as np
import torch


def recall_hits(ids: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Entries of ``ids`` [R, k] found in the same row of ``gt`` [R, k]."""
    return (ids[:, :, None] == gt[:, None, :]).any(-1).sum()


def bad_id_count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Ids [R, k] that are neither a row of an n-row set nor -1, that
    repeat in a row, or that follow a -1 in their row."""
    srt = torch.sort(ids, dim=1).values
    pad = ids == -1
    return (((ids < -1) | (ids >= n)).sum()
            + ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
            + (pad[:, :-1] & ~pad[:, 1:]).sum())


def unsorted_count(dists: torch.Tensor) -> torch.Tensor:
    """Places in rows of ``dists`` [R, k] where a distance is below the
    one before it, or is not a number."""
    return ((dists[:, 1:] < dists[:, :-1]).sum()
            + torch.isnan(dists).sum())


class Answers:
    """What the window got back: the host ids of every request, the pool
    rows each request asked about, and the device distances of a sample
    of requests (a reservoir drawn from the seed, so every request of the
    window is equally likely to be in it)."""

    def __init__(self, seed: int, keep: int):
        self.ids: list[torch.Tensor] = []
        self.batch_of: list[int] = []
        self.kept: list[tuple[int, torch.Tensor]] = []
        self._keep = keep
        self._rng = np.random.default_rng([int(seed), 7])

    def add(self, batch_no: int, ids_host: torch.Tensor, dists) -> None:
        n = len(self.ids)
        self.ids.append(ids_host)
        self.batch_of.append(batch_no)
        if n < self._keep:
            self.kept.append((n, dists))
        else:
            j = int(self._rng.integers(0, n + 1))
            if j < self._keep:
                self.kept[j] = (n, dists)

    def __len__(self) -> int:
        return len(self.ids)


def evaluate(answers: Answers, batches: list[torch.Tensor], q_pool, x,
             gt: torch.Tensor, k: int, metric: str, limits: dict,
             sample_rows: int, seed: int, reference):
    """(The checked numbers of the window's answers, each with its limit;
    the count of padding ids).
    ``batches[j]`` holds the pool rows of batch j; ``gt`` [pool, >= k]
    the reference's nearest ids; ``reference`` the configuration's
    reference module. ``sample_rows`` query rows, drawn from the kept
    requests, are held to the distance check."""
    dev = gt.device
    n = x.shape[0]
    hits, bad, pads, unsorted = (
        torch.zeros((), dtype=torch.int64, device=dev) for _ in range(4))
    rows = 0
    for batch_no, ids_h in zip(answers.batch_of, answers.ids):
        ids = ids_h.to(dev, torch.int64)
        g = gt[batches[batch_no]]
        hits += recall_hits(ids[:, :k], g[:, :k])
        bad += bad_id_count(ids, n)
        pads += (ids == -1).sum()
        rows += ids.shape[0]
    rng = np.random.default_rng([int(seed), 11])
    per_kept = -(-sample_rows // max(1, len(answers.kept)))
    gap = 0.0
    for req, dists in answers.kept:
        unsorted += unsorted_count(dists)
        ids = answers.ids[req].to(dev, torch.int64)
        pick = torch.from_numpy(np.sort(rng.choice(
            ids.shape[0], min(per_kept, ids.shape[0]), replace=False))
            ).to(dev)
        ids, dd = ids[pick], dists[pick].double()
        ok = (ids >= 0) & (ids < n)
        qrows = q_pool[batches[answers.batch_of[req]][pick]]
        from_ref, scale = reference.pair_dists(x, qrows, ids.clamp(0, n - 1),
                                               metric)
        rel = ((dd - from_ref).abs() / scale)[ok]
        if rel.numel():
            gap = max(gap, float(rel.max()))
    checks = {
        "recall_at_k": {"value": int(hits) / max(1, rows * k),
                        "limit": limits["recall_at_k_min"], "op": ">="},
        "dist_gap": {"value": gap, "limit": limits["dist_gap_max"],
                     "op": "<="},
        "unsorted": {"value": int(unsorted), "limit": 0, "op": "<="},
        "bad_ids": {"value": int(bad), "limit": 0, "op": "<="},
    }
    return checks, int(pads)


def holds(check: dict) -> bool:
    """Whether one checked number keeps to its limit."""
    if check["op"] == ">=":
        return check["value"] >= check["limit"]
    return check["value"] <= check["limit"]


def passed(checks: dict) -> bool:
    return all(holds(c) for c in checks.values())
