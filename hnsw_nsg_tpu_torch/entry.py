"""Entry points of the PyTorch port (counterpart of the repo's
``__graft_entry__.py``): one beam-search step and an in-process dry run of
the sharded layout.

    python -m hnsw_nsg_tpu_torch.entry [device]

The JAX package's ``dryrun_multichip`` re-executes Python with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` to get N virtual
CPU devices; a torch mesh simply names its devices (``["cpu"] * 8``,
``["cuda"] * 4``), so the dry run runs in the calling process.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): one batched ``beam_search`` over a padded
    adjacency (the hop shared by the NSG, HNSW level-0, hybrid and
    CNNS-nsg engines) on tensors on ``device`` (default: the card). The
    same seeded inputs as the JAX package's ``entry``."""
    from .models.beam import beam_search
    from .ops.distance import squared_norms
    from .utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, d, q, r = 512, 64, 16, 8
    data = torch.from_numpy(
        rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    norms = squared_norms(data)
    adj = torch.from_numpy(rng.integers(0, n, (n, r), dtype=np.int32)).to(dev)
    queries = torch.from_numpy(
        rng.standard_normal((q, d)).astype(np.float32)).to(dev)
    init = torch.from_numpy(rng.integers(0, n, (q, r), dtype=np.int32)).to(dev)

    def fn(queries, data, norms, adj, init):
        res = beam_search(queries, data, norms, adj, init, width=32,
                          metric="l2", max_hops=64)
        return res.dists, res.ids

    return fn, (queries, data, norms, adj, init)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The sharded layout end to end on a mesh of ``n_devices`` of
    ``devices`` (default: the visible cards): a distributed kNN-graph build
    step, per-shard graph search (all shards, then routed), the sharded
    exact search, routed CNNS over the mesh and, on an even mesh of at
    least 4, the multi-slice layout. Raises on a failed check."""
    from .models.cnns import build_cnns
    from .parallel.mesh import (
        MultiSliceCNNSIndex, ShardedCNNSIndex, ShardedFlatIndex,
        ShardedGraphIndex, make_mesh, make_multislice_mesh,
        sharded_knn_build_step,
    )
    from .utils.params import CNNSConfig

    mesh = make_mesh(n_devices, devices)
    rng = np.random.default_rng(0)
    rows, d, k = 64, 16, 4
    n = n_devices * rows
    x = rng.standard_normal((n, d)).astype(np.float32)

    # build step: each shard's kNN rows against all rows
    adj_global = sharded_knn_build_step(mesh, x, k).cpu().numpy()
    assert adj_global.shape == (n, k)

    # intra-shard edges as each shard's local sub-graph
    shard_of = adj_global // rows
    my_shard = (np.arange(n) // rows)[:, None]
    local = np.where((adj_global >= 0) & (shard_of == my_shard),
                     adj_global % rows, -1).astype(np.int32)
    datas = [x[s * rows : (s + 1) * rows] for s in range(n_devices)]
    adjs = [local[s * rows : (s + 1) * rows] for s in range(n_devices)]
    gidx = ShardedGraphIndex.build_from_shards(mesh, datas, adjs,
                                               [0] * n_devices)

    q = rng.standard_normal((8, d)).astype(np.float32)
    dd, ii, _ = gidx.search(q, k=4, l_search=16, max_hops=32,
                            nprobe=n_devices)
    assert dd.shape == (8, 4) and ii.shape == (8, 4)
    assert bool((ii[:, 0] >= 0).all())
    _, ri, revals = gidx.search(q, k=4, l_search=16, max_hops=32, nprobe=2)
    assert ri.shape == (8, 4) and revals.shape == (n_devices,)

    _, fi = ShardedFlatIndex.build(mesh, x).search(q, 4)
    assert fi.shape == (8, 4)

    cidx = build_cnns(
        x, CNNSConfig(n_clusters=max(2 * n_devices, 4), m=1, kmeans_iters=3),
        device=mesh.first,
    )
    _, ci, evals = ShardedCNNSIndex.build(mesh, cidx).search(q, k=4, nprobe=4)
    assert ci.shape == (8, 4) and evals.shape == (n_devices,)
    assert bool((ci[:, 0] >= 0).all())

    if n_devices >= 4 and n_devices % 2 == 0:
        ms = MultiSliceCNNSIndex.build(
            make_multislice_mesh(2, list(mesh.devices)), cidx)
        mi = ms.search(q, k=4, nprobe=4)[1]
        assert mi.shape == (8, 4) and bool((mi[:, 0] >= 0).all())


if __name__ == "__main__":
    fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else None)
    out = fn(*args)
    print("entry ok:", tuple(out[0].shape), tuple(out[1].shape))
