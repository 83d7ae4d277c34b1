"""nn-descent kNN-graph construction and incremental insertion on the
device (counterpart of hnsw_nsg_tpu/models/nndescent.py).

Reference: ``IndexGraph`` (CNNS/efanna_graph/src/index_graph.cpp). Each
iteration ``join`` (:22-33) evaluates all pairs among each node's sampled
new and old neighbour lists under per-node locked heaps, and ``update``
(:34-120) re-sorts the pools, samples at most S new entries (clearing
their flags) and builds reverse lists capped at R.

As in the JAX package, the scatter-heavy local join becomes a pull: if u
and v both appear in w's join lists, u finds v by gathering the lists of
its join partners. An iteration:

  1. samples S new-flagged and S old pool entries per node (the sampled
     new flags are cleared), [N, S] each;
  2. builds reverse lists by a random-column scatter, rev[dst, col] = src;
     of the proposals that land on one cell the last in flattened order
     wins (a reservoir replacement, index_graph.cpp:92-118, made
     deterministic: a scatter on the card keeps an arbitrary one);
  3. takes as candidates the partners (forward and reverse samples) and
     every partner's samples and top-T pool entries;
  4. computes their distances a node chunk at a time;
  5. merges them into the [N, L] sorted pools with the sorted-dedup
     retset merge; surviving inserts are flagged new.

The count of changed pool slots is the one number read back an
iteration. ``graph_add`` (GraphAdd, index_graph.cpp:379-498) inserts new
points in bulk-synchronous batches: each batch's beams (``beam_search``,
whose hops run the fused merge+select) search the graph of everything
inserted so far, and the reverse edges land through one merge.

Random draws come from a ``torch.Generator`` seeded by ``seed``, so the
samples differ from the JAX package's; the initial ids are drawn with
numpy as there, so a seed gives both packages the same seed pools. Not
carried over from the JAX package: the padding of N to a multiple of the
chunk with copies of row 0 (a static-shape requirement of ``lax.map``;
here the last chunk is short, and no padded row can enter a pool), the
padding of ``graph_add``'s last batch. The chunk auto-shrink keeps the
per-chunk candidate gather within ``_CHUNK_BYTES``, sized for an 80 GB
card where the JAX package held it to 3 GB of a TPU's HBM.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.bruteforce import brute_force_topk
from ..ops.distance import PAD_DIST, PAD_ID, gathered_dists, squared_norms
from ..ops.topk import empty_retset, merge_into_retset_sorted, scatter_last
from ..utils.params import NNDescentConfig
from .beam import beam_search
from .nsg import _as_tensor

# bytes allowed for one chunk's candidate gather ([chunk, candidates, d]
# f32 and a copy): a tenth of an H100's 80 GB
_CHUNK_BYTES = 8e9


def _sample_masked(gen, mask, s: int):
    """Per row, up to ``s`` slots chosen uniformly where mask is True.
    Returns (slot_idx [N, s], got [N, s])."""
    noise = torch.rand(mask.shape, generator=gen, device=mask.device)
    score = torch.where(mask, noise, -1.0)
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices
    idx = idx[:, :s]
    return idx, torch.gather(mask, 1, idx)


def _reverse_scatter(gen, fwd, n: int, r: int):
    """Approximate reverse sampling: rev[fwd[u, j], random col] = u."""
    cols = torch.randint(0, r, fwd.shape, generator=gen, device=fwd.device)
    src = torch.arange(fwd.shape[0], dtype=torch.int32,
                       device=fwd.device)[:, None].expand_as(fwd)
    dst = torch.where(fwd >= 0, fwd, n)          # invalid -> dropped
    return scatter_last(n, r, dst, cols, (src, PAD_ID))[0]


def _iteration(gen, data, norms, pool_ids, pool_d, pool_new, n_valid: int,
               s: int, r: int, t: int, metric: str, chunk: int):
    """One nn-descent iteration. Returns the new (pool_ids, pool_d,
    pool_new) and the count of changed pool slots (a device scalar)."""
    n, l = pool_ids.shape
    valid = pool_ids >= 0
    new_idx, new_got = _sample_masked(gen, valid & pool_new, s)
    old_idx, old_got = _sample_masked(gen, valid & ~pool_new, s)
    s_new = torch.where(new_got, torch.gather(pool_ids, 1, new_idx), PAD_ID)
    s_old = torch.where(old_got, torch.gather(pool_ids, 1, old_idx), PAD_ID)
    cleared = torch.zeros_like(pool_new).scatter(1, new_idx, new_got)
    pool_new = pool_new & ~cleared

    r_new = _reverse_scatter(gen, s_new, n, r)
    r_old = _reverse_scatter(gen, s_old, n, r)
    partners = torch.cat([s_new, s_old, r_new, r_old], 1)       # [N, W]
    # each partner's sampled join lists (u pulling w's samples is the
    # pair (u, v) of join(w)) and its top-T pool rows
    tables = [s_new, s_old] + ([pool_ids[:, :t]] if t else [])
    qn_all = norms if metric == "l2" else None
    out_i = torch.empty_like(pool_ids)
    out_d = torch.empty_like(pool_d)
    out_new = torch.empty_like(pool_new)
    for st in range(0, n, chunk):
        e = min(st + chunk, n)
        rows = torch.arange(st, e, device=data.device)
        part = partners[st:e]
        safe = part.clamp(min=0).long()
        pulled = torch.cat([tb[safe] for tb in tables], 2)   # [B, W, 2S+T]
        pulled = torch.where(part[:, :, None] >= 0, pulled, PAD_ID)
        cand = torch.cat([part, pulled.reshape(e - st, -1)], 1)
        # self references and ids past the real rows never enter a pool
        cand = torch.where((cand == rows[:, None]) | (cand >= n_valid),
                           PAD_ID, cand)
        cd = gathered_dists(data[st:e], data, cand, metric, norms)
        if qn_all is not None:
            cd = torch.where(cand >= 0, cd + qn_all[st:e][:, None], PAD_DIST)
        nd, ni, ne = merge_into_retset_sorted(
            pool_d[st:e], pool_ids[st:e], ~pool_new[st:e], cd, cand)
        out_d[st:e], out_i[st:e], out_new[st:e] = nd, ni, ~ne
    out_new &= out_i >= 0
    return out_i, out_d, out_new, (out_i != pool_ids).sum()


def _seed_pools(data, norms, init_ids, l: int, metric: str, chunk: int):
    """Pools from the initial ids: each row's candidates merged into an
    empty pool of width ``l``; every entry starts new."""
    n = data.shape[0]
    pool_ids = torch.empty((n, l), dtype=torch.int32, device=data.device)
    pool_d = torch.empty((n, l), device=data.device)
    for st in range(0, n, chunk):
        e = min(st + chunk, n)
        cand = init_ids[st:e]
        cd = gathered_dists(data[st:e], data, cand, metric, norms)
        if metric == "l2":
            cd = torch.where(cand >= 0, cd + norms[st:e][:, None], PAD_DIST)
        pool_d[st:e], pool_ids[st:e], _ = merge_into_retset_sorted(
            *empty_retset(e - st, l, data.device), cd, cand)
    return pool_ids, pool_d, pool_ids >= 0


def nn_descent(
    data,
    cfg: NNDescentConfig = NNDescentConfig(),
    metric: str = "l2",
    seed: int = 0,
    chunk: int = 4096,
    top_t: int = 8,
    rev_cap: int | None = None,
    init_adj=None,
    eval_recall_every: int = 0,
    verbose: bool = False,
    min_changed_frac: float = 0.001,
    device=None,
    stats: dict | None = None,
) -> np.ndarray:
    """Build an approximate kNN graph. Returns int32 [N, K] (numpy).

    cfg: K (output degree), L (pool width), iters, S (sample), R (reverse
    cap), the reference's parameters. top_t: pool entries pulled per join
    partner. init_adj: an optional warm start (RefineGraph,
    index_graph.cpp:235-262), else random ids (IndexRandom,
    index_random.cpp:24-27). data: numpy (placed on ``device``, default
    the card) or a tensor (used where it lies). ``eval_recall_every``
    prints the pools' recall@K on 100 random control rows every that many
    iterations (index_graph.cpp:122-172). When ``stats`` is a dict, its
    ``"iterations"`` list gets one dict per iteration: ``changed``,
    ``seconds`` and ``recall`` (None where not evaluated)."""
    x = _as_tensor(data, device, torch.float32)
    n, d = x.shape
    k, l = cfg.K, max(cfg.L, cfg.K)
    rcap = rev_cap if rev_cap is not None else min(cfg.R, 2 * cfg.S)
    cand_w = (2 * cfg.S + 2 * rcap) * (2 * cfg.S + top_t + 1)
    max_chunk = max(int(_CHUNK_BYTES / (cand_w * d * 8)), 256)
    chunk = max(min(chunk, 1 << int(np.floor(np.log2(max_chunk))), n), 1)
    norms = squared_norms(x)
    rng = np.random.default_rng(seed)

    if init_adj is not None:
        if isinstance(init_adj, torch.Tensor):
            init_adj = init_adj.cpu().numpy()
        init_ids = np.asarray(init_adj, np.int32)[:, :l]
        if init_ids.shape[1] < l:
            fill = rng.integers(0, n, (n, l - init_ids.shape[1]),
                                dtype=np.int32)
            init_ids = np.concatenate([init_ids, fill], axis=1)
    else:
        init_ids = rng.integers(0, n, (n, l), dtype=np.int32)
    init_ids = np.where(init_ids == np.arange(n, dtype=np.int32)[:, None],
                        PAD_ID, init_ids)
    pool_ids, pool_d, pool_new = _seed_pools(
        x, norms, torch.from_numpy(init_ids).to(x.device), l, metric, chunk)

    control = control_gt = None
    if eval_recall_every:
        control = rng.integers(0, n, min(100, n))
        _, cgt = brute_force_topk(x[torch.from_numpy(control).to(x.device)],
                                  x, k + 1, metric=metric)
        control_gt = cgt.cpu().numpy()[:, 1:]

    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    for it in range(cfg.iters):
        t0 = time.perf_counter()
        pool_ids, pool_d, pool_new, changed = _iteration(
            gen, x, norms, pool_ids, pool_d, pool_new, n, cfg.S, rcap, top_t,
            metric, chunk)
        changed = int(changed)
        rec = None
        if eval_recall_every and (it + 1) % eval_recall_every == 0:
            pids = pool_ids[torch.from_numpy(control).to(x.device), :k]
            pids = pids.cpu().numpy()
            hits = sum(len(np.intersect1d(pids[ci], control_gt[ci][:k]))
                       for ci in range(len(control)))
            rec = hits / (len(control) * k)
            print(f"nn-descent iter {it + 1}/{cfg.iters}: recall={rec:.4f} "
                  f"changed={changed}")
        elif verbose:
            print(f"nn-descent iter {it + 1}/{cfg.iters}: changed={changed}")
        if stats is not None:
            stats.setdefault("iterations", []).append(dict(
                changed=changed, recall=rec,
                seconds=time.perf_counter() - t0))
        if changed <= min_changed_frac * n:
            break
    return pool_ids[:, :k].cpu().numpy()


# ---------------------------------------------------------------------------
# Incremental kNN-graph insertion (GraphAdd)
# ---------------------------------------------------------------------------

def _pools_from_adj(data, norms, adj, metric: str, chunk: int):
    """Exact distances of every adjacency entry (compact_to_Lockgraph,
    index_graph.cpp:483-497: each existing edge gets its distance
    recomputed so that bounded inserts can rank against it); PAD_DIST on
    PAD entries."""
    out = torch.empty(adj.shape, device=data.device)
    for st in range(0, adj.shape[0], chunk):
        e = min(st + chunk, adj.shape[0])
        adj_b = adj[st:e]
        cd = gathered_dists(data[st:e], data, adj_b, metric, norms)
        if metric == "l2":
            cd = cd + norms[st:e][:, None]
        out[st:e] = torch.where(adj_b >= 0, cd, PAD_DIST)
    return out


def _graph_add_batch(gen, data, norms, rows, adj, pool_d, n0: int,
                     metric: str, l_add: int, rrev: int, max_hops: int):
    """Insert one batch of new nodes (``rows``: their global ids) into the
    growing graph: get_neighbor_to_add (index_graph.cpp:430-479), an
    ``l_add``-wide beam seeded with random old and random new ids, whose
    top K become the node's out-edges, and bounded reverse edges
    (parallel_graph_insert, :379-390) through a random-column proposal
    list and one retset merge over all pools. Returns (adj, pool_d)."""
    n_tot = data.shape[0]
    k = adj.shape[1]
    b = rows.shape[0]
    rl = rows.long()
    q = data[rl]
    h = l_add // 2
    dev = data.device
    init_old = torch.randint(0, n0, (b, l_add - h), generator=gen,
                             device=dev, dtype=torch.int32)
    init_new = torch.randint(n0, n_tot, (b, h), generator=gen, device=dev,
                             dtype=torch.int32)
    init = torch.cat([init_old, init_new], 1)
    init = torch.where(init == rows[:, None], PAD_ID, init)

    res = beam_search(q, data, norms, adj, init, width=l_add, metric=metric,
                      max_hops=max_hops)
    e_i = res.ids[:, :k]
    e_d = res.dists[:, :k]
    if metric == "l2":
        e_d = e_d + norms[rl][:, None]
    valid = (e_i >= 0) & (e_i != rows[:, None])
    e_i = torch.where(valid, e_i, PAD_ID)
    e_d = torch.where(valid, e_d, PAD_DIST)
    adj[rl] = e_i
    pool_d[rl] = e_d

    # bounded reverse inserts: rev[e_i[u, j], random col] = u
    cols = torch.randint(0, rrev, (b, k), generator=gen, device=dev)
    dst = torch.where(valid, e_i, n_tot)
    rev_i, rev_d = scatter_last(n_tot, rrev, dst, cols,
                                 (rows[:, None].expand(b, k), PAD_ID),
                                 (e_d, float(PAD_DIST)))
    no_flags = torch.zeros_like(adj, dtype=torch.bool)
    pool_d, adj, _ = merge_into_retset_sorted(pool_d, adj, no_flags, rev_d,
                                              rev_i)
    return adj, pool_d


def graph_add(
    data,
    adj,
    new_data,
    metric: str = "l2",
    seed: int = 0,
    l_add: int | None = None,
    batch: int = 4096,
    chunk: int = 4096,
    max_hops: int = 128,
    device=None,
):
    """Append points to an existing kNN graph (``GraphAdd``,
    CNNS/efanna_graph/src/index_graph.cpp:379-498).

    data [N0, d]: the points the graph was built over; adj [N0, K]: their
    kNN adjacency (PAD_ID-padded); new_data [B, d]: the points to insert.
    Numpy goes to ``device`` (default: the card); tensors stay where
    ``data`` lies. New points arrive in batches of ``batch``: each batch
    beam-searches the graph of everything inserted so far, writes its own
    top-K out-edges, and its reverse edges land through one merge over all
    pools. Returns (data_all [N0+B, d], adj_all [N0+B, K]) as numpy, rows
    sorted by distance."""
    x0 = _as_tensor(data, device, torch.float32)
    dev = x0.device
    xn = _as_tensor(new_data, dev, torch.float32)
    if isinstance(adj, torch.Tensor):
        adj0 = adj.to(device=dev, dtype=torch.int32)
    else:
        adj0 = torch.from_numpy(np.asarray(adj, np.int32)).to(dev)
    n0 = x0.shape[0]
    n_new = xn.shape[0]
    k = adj0.shape[1]
    l_add = l_add or max(2 * k, 32)
    batch = min(batch, max(n_new, 1))

    x_all = torch.cat([x0, xn])
    n_tot = n0 + n_new
    norms = squared_norms(x_all)
    # existing pools with exact distances; new rows start empty
    pool_d = torch.cat([
        _pools_from_adj(x0, norms[:n0], adj0, metric, max(chunk, 1)),
        torch.full((n_new, k), float(PAD_DIST), device=dev)])
    adj_all = torch.cat([
        adj0, torch.full((n_new, k), PAD_ID, dtype=torch.int32, device=dev)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for st in range(n0, n_tot, batch):
        rows = torch.arange(st, min(st + batch, n_tot), dtype=torch.int32,
                            device=dev)
        adj_all, pool_d = _graph_add_batch(
            gen, x_all, norms, rows, adj_all, pool_d, n0, metric, l_add,
            2 * k, max_hops)
    return x_all.cpu().numpy(), adj_all.cpu().numpy()
