"""The command line, mirroring the reference's executables (counterpart
of hnsw_nsg_tpu/cli.py): the same subcommands, arguments, artifact layout
and byte formats.

Reference CLIs (SURVEY.md §1 L5):
  * CNNS build stage 1 ``cluster_IVF_nndescent <data> <n_clusters> <m> <K>
    <L> <iter> <S> <R> <prefix>`` (CNNS/tests/cluster_IVF_nndescent.cpp:44)
    -> ``build-clusters``; writes the artifact directory
    {centroids.fvecs, cluster_data/, nndescent/, mapping/} in the
    reference's byte formats.
  * CNNS build stage 2 ``nndescent_nsg`` -> ``build-nsg`` (nsg_graph/*.nsg).
  * ``cluster_hnsw_nsg_search`` and ablations -> ``search-clusters``.
  * hnswlib sift_1m workflow -> ``build-hnsw`` / ``search-hnsw`` (ef-sweep
    recall table, hnswlib/tests/cpp/sift_1m.cpp:199-226).
  * the hnsw_nsg test program -> ``build-hybrid`` / ``search-hybrid``.
  * format converters (CNNS/apps/*.cpp) -> ``convert``; ``calculate-recall``.

Every subcommand takes ``--device`` (default: the card; ``cpu`` runs on
the host). The JAX CLI's persistent compile cache has no counterpart.

Usage: python -m hnsw_nsg_tpu_torch.cli <command> [args] [--device DEV]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .utils import io
from .utils.device import resolve_device
from .utils.params import HNSWConfig, NNDescentConfig, NSGBuildConfig


def _load_vectors(path: str) -> np.ndarray:
    if path.endswith(".fvecs"):
        return io.read_fvecs(path)
    if path.endswith(".bvecs"):
        return io.read_bvecs(path).astype(np.float32)
    if path.endswith(".bin"):
        return io.read_bin(path)
    if path.endswith(".npy"):
        return np.load(path)
    raise ValueError(f"unknown vector format: {path}")


def cmd_build_clusters(args):
    from .models.kmeans import kmeans
    from .models.nndescent import nn_descent

    dev = resolve_device(args.device)
    data = _load_vectors(args.data)
    os.makedirs(args.prefix, exist_ok=True)
    for sub in ("cluster_data", "nndescent", "mapping"):
        os.makedirs(os.path.join(args.prefix, sub), exist_ok=True)

    t0 = time.time()
    centroids, assign = kmeans(torch.from_numpy(data).to(dev),
                               args.n_clusters, iters=args.kmeans_iters)
    centroids, assign = centroids.cpu().numpy(), assign.cpu().numpy()
    print(f"kmeans: {time.time() - t0:.1f}s")

    rng = np.random.default_rng(0)
    reps = np.zeros((args.n_clusters, args.m + 1, data.shape[1]), np.float32)
    reps[:, 0] = centroids
    cfg = NNDescentConfig(K=args.K, L=args.L, iters=args.iter,
                          S=args.S, R=args.R)
    for ci in range(args.n_clusters):
        members = np.nonzero(assign == ci)[0]
        if len(members) == 0:
            continue
        reps[ci, 1:] = data[rng.choice(members, args.m)]
        io.write_mapping(
            os.path.join(args.prefix, "mapping", f"mapping_{ci}"),
            members.astype(np.int64),
        )
        io.write_fvecs(
            os.path.join(args.prefix, "cluster_data", f"cluster_{ci}.fvecs"),
            data[members],
        )
        t0 = time.time()
        kcfg = NNDescentConfig(
            K=min(cfg.K, len(members) - 1) if len(members) > 1 else 1,
            L=cfg.L, iters=cfg.iters, S=cfg.S, R=cfg.R,
        )
        gpath = os.path.join(
            args.prefix, "nndescent", f"nndescent_{ci}.graph"
        )
        # resume after a failure: per-cluster artifacts are independent, so
        # an existing graph file is kept (the reference programs'
        # exists_test pattern, sift_1m.cpp:308)
        if os.path.exists(gpath) and not args.force:
            print(f"cluster {ci}: exists, skipped")
            continue
        if len(members) > 1:
            adj = nn_descent(data[members], kcfg, device=dev)
            io.write_knn_graph(gpath, adj)
        print(f"cluster {ci}: {len(members)} pts "
              f"({time.time() - t0:.1f}s)")
    io.write_centroids(os.path.join(args.prefix, "centroids.fvecs"), reps)
    print(f"wrote artifacts under {args.prefix}")


def cmd_build_knn(args):
    """Standalone kNN-graph build (efanna's test_nndescent.cpp:29
    ``data_file save_graph K L iter S R`` and test_kdtree_graph.cpp).

    Methods: ``ivf`` (the cluster join, the large-N path,
    models/knn_ivf.py), ``rp`` (rp-trees + nn-descent refinement, the
    kdtree+nndescent analogue), ``exact`` (the brute-force oracle)."""
    dev = resolve_device(args.device)
    data = _load_vectors(args.data)
    t0 = time.time()
    if args.method == "exact":
        from .ops.bruteforce import knn_graph_exact

        adj = knn_graph_exact(torch.from_numpy(data).to(dev), args.K,
                              query_block=4096).cpu().numpy()
    elif args.method == "rp":
        from .models.rptree import knn_graph_rp

        refine = None
        if args.iter:
            refine = NNDescentConfig(K=args.K, L=args.L, iters=args.iter,
                                     S=args.S, R=args.R)
        adj = knn_graph_rp(data, args.K, n_trees=args.trees, refine=refine,
                           device=dev)
    else:
        from .models.knn_ivf import knn_graph_ivf

        adj = knn_graph_ivf(data, args.K, n_clusters=args.n_clusters,
                            probes=args.probes, device=dev)
    print(f"knn graph ({args.method}): {len(data)} pts K={args.K} "
          f"({time.time() - t0:.1f}s)")
    io.write_knn_graph(args.out, adj)


def cmd_build_nsg(args):
    from .models.nsg import build_nsg

    dev = resolve_device(args.device)
    os.makedirs(os.path.join(args.prefix, "nsg_graph"), exist_ok=True)
    cfg = NSGBuildConfig(L=args.L, R=args.R, C=args.C)
    cdir = os.path.join(args.prefix, "cluster_data")
    for fname in sorted(os.listdir(cdir)):
        if not fname.endswith(".fvecs"):
            continue
        cid = fname[len("cluster_"):-len(".fvecs")]
        npath = os.path.join(args.prefix, "nsg_graph", f"nsg_{cid}.nsg")
        if os.path.exists(npath) and not args.force:
            print(f"cluster {cid}: exists, skipped")
            continue
        data = io.read_fvecs(os.path.join(cdir, fname))
        gpath = os.path.join(args.prefix, "nndescent",
                             f"nndescent_{cid}.graph")
        if not os.path.exists(gpath):
            continue
        knn = io.read_knn_graph(gpath)
        t0 = time.time()
        nsg = build_nsg(data, knn, cfg, device=dev)
        nsg.save_reference_format(npath)
        print(f"cluster {cid}: NSG over {len(data)} pts "
              f"({time.time() - t0:.1f}s)")


def cmd_search_clusters(args):
    """Load the artifact directory and run the routed multi-cluster search
    (cluster_hnsw_nsg_search.cpp flow), reporting recall and QPS."""
    from .models.cnns import CNNSIndex
    from .ops.bruteforce import recall as recall_fn
    from .ops.distance import PAD_ID

    dev = resolve_device(args.device)
    queries = _load_vectors(args.queries)
    gt = io.read_gt(args.gt) if args.gt else None
    reps = io.read_centroids(os.path.join(args.prefix, "centroids.fvecs"))
    c = reps.shape[0]

    datas, mappings, nsgs = [], [], []
    for ci in range(c):
        datas.append(io.read_fvecs(
            os.path.join(args.prefix, "cluster_data", f"cluster_{ci}.fvecs")
        ))
        mappings.append(io.read_mapping(
            os.path.join(args.prefix, "mapping", f"mapping_{ci}")
        ))
        npath = os.path.join(args.prefix, "nsg_graph", f"nsg_{ci}.nsg")
        nsgs.append(io.read_nsg(npath) if os.path.exists(npath) else None)

    maxc = ((max(len(d) for d in datas) + 7) // 8) * 8
    dim = datas[0].shape[1]
    data_c = np.zeros((c, maxc, dim), np.float32)
    ids_c = np.full((c, maxc), PAD_ID, np.int32)
    for ci in range(c):
        data_c[ci, : len(datas[ci])] = datas[ci]
        ids_c[ci, : len(mappings[ci])] = mappings[ci]

    local = args.local
    if local == "nsg" and not all(g is not None for g in nsgs):
        local = "flat"
    flat_adj = eps_flat = None
    sizes = np.array([len(d) for d in datas])
    if local == "nsg":
        rmax = max(g[0].shape[1] for g in nsgs)
        flat_adj_np = np.full((c * maxc, rmax), PAD_ID, np.int32)
        eps_flat = np.zeros(c, np.int64)
        for ci, (adj, ep, _) in enumerate(nsgs):
            remap = np.where(adj >= 0, adj + ci * maxc, PAD_ID)
            flat_adj_np[ci * maxc : ci * maxc + len(adj), : adj.shape[1]] = remap
            eps_flat[ci] = ep + ci * maxc
        flat_adj = torch.from_numpy(flat_adj_np).to(dev)
    elif local == "hnsw":
        # the cluster_hnsw_hnsw ablation: per-cluster HNSW graphs built
        # over the loaded cluster data (the reference's search program
        # builds them too, cluster_hnsw_hnsw_search.cpp:129-)
        from .models.cnns import local_hnsw_arena

        flat_adj, eps_flat = local_hnsw_arena(data_c, sizes, "l2",
                                              device=dev)

    idx = CNNSIndex(
        reps=torch.from_numpy(reps).to(dev),
        data_c=torch.from_numpy(data_c).to(dev),
        ids_c=torch.from_numpy(ids_c).to(dev),
        sizes=sizes,
        local_index=local,
        flat_adj=flat_adj, eps_flat=eps_flat,
    )
    kw = dict(k=args.k, nprobe=args.nprobe, l_search=args.search_L,
              rank_by=args.rank_by, router=args.router)
    idx.search(queries[:8], **kw)  # warm
    t0 = time.time()
    _, i = idx.search(queries, **kw)
    i = i.cpu().numpy()
    dt = time.time() - t0
    out = {"qps": len(queries) / dt, "k": args.k, "nprobe": args.nprobe,
           "router": args.router, "local": local, "rank_by": args.rank_by}
    if gt is not None:
        out["recall"] = recall_fn(i, gt[:, : args.k])
    print(json.dumps(out))


def cmd_build_hnsw(args):
    from .models.hnsw import HNSWIndex

    if os.path.exists(args.out) and not args.force:
        print(f"{args.out}: exists, skipped (use --force to rebuild)")
        return
    data = _load_vectors(args.data)
    idx = HNSWIndex(
        data.shape[1], len(data),
        HNSWConfig(M=args.M, ef_construction=args.efc),
        device=resolve_device(args.device),
    )
    t0 = time.time()
    idx.add_items(data, batch_size=args.batch)
    print(f"build: {time.time() - t0:.1f}s "
          f"({len(data) / (time.time() - t0):.0f} pts/s)")
    idx.save(args.out)


def cmd_search_hnsw(args):
    """ef-sweep recall table (sift_1m.cpp:199-226 shape)."""
    from .models.hnsw import HNSWIndex
    from .ops.bruteforce import recall as recall_fn

    idx = HNSWIndex.load(args.index, device=resolve_device(args.device))
    queries = _load_vectors(args.queries)
    gt = io.read_gt(args.gt) if args.gt else None
    print("ef\trecall@k\tus/query")
    for ef in [int(e) for e in args.efs.split(",")]:
        idx.knn_query(queries[:8], k=args.k, ef=ef)  # warm
        t0 = time.time()
        labels, _ = idx.knn_query(queries, k=args.k, ef=ef)
        dt = time.time() - t0
        r = recall_fn(labels, gt[:, : args.k]) if gt is not None else -1
        print(f"{ef}\t{r:.4f}\t{dt / len(queries) * 1e6:.1f}")


def cmd_build_hybrid(args):
    """Build the hybrid HNSW-upper/NSG-base index (the reference's
    sift_test1M build phase, hnsw_nsg/tests/test_hnsw_nsg_search.cpp:
    271-347: parallel addPoint with M/efC, then Build_NSG with L/R/C,
    optionally seeded from a prebuilt kNN graph file)."""
    from .models.hybrid import HybridHNSWNSG
    from .utils.metrics import device_memory_stats

    if (os.path.exists(f"{args.out}_hnsw.npz")
            and os.path.exists(f"{args.out}_nsg.npz")
            and not args.force):
        print(f"{args.out}: exists, skipped (use --force to rebuild)")
        return
    dev = resolve_device(args.device)
    data = _load_vectors(args.data)
    hyb = HybridHNSWNSG(
        data.shape[1], len(data),
        hnsw_cfg=HNSWConfig(M=args.M, ef_construction=args.efc),
        nsg_cfg=NSGBuildConfig(L=args.L, R=args.R, C=args.C),
        device=dev,
    )
    t0 = time.time()
    hyb.add_points(data, batch_size=args.batch)
    t_hnsw = time.time() - t0
    print(f"hnsw insert: {t_hnsw:.1f}s "
          f"({len(data) / max(t_hnsw, 1e-9):.0f} pts/s)")
    knn = None
    if args.knn_graph:
        knn = io.read_knn_graph(args.knn_graph)
    t0 = time.time()
    hyb.build_nsg_layer(knn_adj=knn)
    print(f"nsg build: {time.time() - t0:.1f}s")
    hyb.save(args.out)
    stats = device_memory_stats(dev)
    print(f"device bytes in use: {stats['bytes_in_use']}")


def cmd_search_hybrid(args):
    """Recall/latency sweep over search_L (the reference's test_vs_recall
    table, test_hnsw_nsg_search.cpp:199-229)."""
    from .models.hybrid import HybridHNSWNSG
    from .ops.bruteforce import recall as recall_fn

    hyb = HybridHNSWNSG.load(args.index, device=resolve_device(args.device))
    if args.accel:
        hyb.build_accel()
    queries = _load_vectors(args.queries)
    gt = io.read_gt(args.gt) if args.gt else None
    print("search_L\trecall@k\tus/query")
    rows = []
    for sl in [int(e) for e in args.search_ls.split(",")]:
        hyb.search_knn(queries[:8], k=args.k, l_search=sl)  # warm
        t0 = time.time()
        labels, _ = hyb.search_knn(queries, k=args.k, l_search=sl)
        dt = time.time() - t0
        r = recall_fn(labels, gt[:, : args.k]) if gt is not None else -1
        rows.append((sl, r, dt / len(queries) * 1e6))
        print(f"{sl}\t{r:.4f}\t{dt / len(queries) * 1e6:.1f}")
    if args.result:
        with open(args.result, "w") as f:
            json.dump([{"search_L": a, "recall": b, "us_per_query": c}
                       for a, b, c in rows], f)


def cmd_convert(args):
    src, dst = args.src, args.dst
    x = _load_vectors(src) if not src.endswith(".tsv") else io.read_tsv(src)
    if dst.endswith(".fvecs"):
        io.write_fvecs(dst, x.astype(np.float32))
    elif dst.endswith(".bvecs"):
        io.write_bvecs(dst, np.clip(x, 0, 255).astype(np.uint8))
    elif dst.endswith(".bin"):
        if args.int8:
            scale = np.abs(x).max() / 127.0 if np.abs(x).max() else 1.0
            io.write_bin(dst, (x / scale).astype(np.int8))
            print(f"scale={scale}")
        else:
            io.write_bin(dst, x.astype(np.float32))
    elif dst.endswith(".tsv"):
        io.write_tsv(dst, x)
    else:
        raise ValueError(f"unknown target format {dst}")
    print(f"{src} -> {dst} ({x.shape[0]} x {x.shape[1]})")


def cmd_calculate_recall(args):
    from .ops.bruteforce import recall as recall_fn

    res = io.read_ivecs(args.result)
    gt = io.read_gt(args.gt)
    print(json.dumps({"recall": recall_fn(res[:, : args.k],
                                          gt[:, : args.k])}))


def main(argv=None):
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu runs on "
                             "the host)")
    p = argparse.ArgumentParser(prog="hnsw_nsg_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn, **kw):
        s = sub.add_parser(name, parents=[common], **kw)
        s.set_defaults(fn=fn)
        return s

    s = command("build-clusters", cmd_build_clusters)
    s.add_argument("data")
    s.add_argument("n_clusters", type=int)
    s.add_argument("m", type=int)
    s.add_argument("K", type=int)
    s.add_argument("L", type=int)
    s.add_argument("iter", type=int)
    s.add_argument("S", type=int)
    s.add_argument("R", type=int)
    s.add_argument("prefix")
    s.add_argument("--kmeans-iters", type=int, default=15)
    s.add_argument("--force", action="store_true",
                   help="rebuild even if artifacts exist")

    # efanna test_nndescent.cpp:29 argv: data_file save_graph K L iter S R
    s = command("build-knn", cmd_build_knn)
    s.add_argument("data")
    s.add_argument("out")
    s.add_argument("K", type=int)
    s.add_argument("--method", choices=("ivf", "rp", "exact"),
                   default="ivf")
    s.add_argument("--L", type=int, default=100)
    s.add_argument("--iter", type=int, default=0,
                   help="nn-descent refine iters (rp method)")
    s.add_argument("--S", type=int, default=10)
    s.add_argument("--R", type=int, default=100)
    s.add_argument("--trees", type=int, default=8)
    s.add_argument("--n-clusters", type=int, default=None,
                   dest="n_clusters")
    s.add_argument("--probes", type=int, default=8)

    s = command("build-nsg", cmd_build_nsg)
    s.add_argument("prefix")
    s.add_argument("L", type=int)
    s.add_argument("R", type=int)
    s.add_argument("C", type=int)
    s.add_argument("--force", action="store_true",
                   help="rebuild even if artifacts exist")

    s = command("search-clusters", cmd_search_clusters)
    s.add_argument("prefix")
    s.add_argument("queries")
    s.add_argument("--gt")
    s.add_argument("--k", type=int, default=100)
    s.add_argument("--nprobe", type=int, default=8)
    s.add_argument("--search-L", type=int, default=100, dest="search_L")
    s.add_argument("--local", choices=("flat", "nsg", "hnsw"),
                   default="nsg",
                   help="per-cluster engine (the cluster_knn_*/"
                        "cluster_hnsw_hnsw ablation axis)")
    s.add_argument("--router", choices=("flat", "hnsw"), default="flat",
                   help="representative routing: one GEMM (flat) or a "
                        "graph walk over the reps (the reference's faiss "
                        "router)")
    s.add_argument("--rank-by", choices=("hits", "min_dist"),
                   default="hits", dest="rank_by",
                   help="cluster probe order (sort_by_min_dist ablation)")

    s = command("build-hnsw", cmd_build_hnsw)
    s.add_argument("data")
    s.add_argument("out")
    s.add_argument("--M", type=int, default=16)
    s.add_argument("--efc", type=int, default=200)
    s.add_argument("--batch", type=int, default=4096)
    s.add_argument("--force", action="store_true",
                   help="rebuild even if artifacts exist")

    s = command("search-hnsw", cmd_search_hnsw)
    s.add_argument("index")
    s.add_argument("queries")
    s.add_argument("--gt")
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--efs", default="10,20,40,80,160,320")

    # argv mirrors test_hnsw_nsg_search.cpp:369-395:
    # <nn_graph_path> <L> <R> <C> <save_graph_file> <search_L> <search_K>
    s = command("build-hybrid", cmd_build_hybrid)
    s.add_argument("data")
    s.add_argument("out", help="prefix; writes <out>_hnsw.npz + <out>_nsg.npz")
    s.add_argument("--M", type=int, default=16)
    s.add_argument("--efc", type=int, default=40)
    s.add_argument("--L", type=int, default=40)
    s.add_argument("--R", type=int, default=20, help="nsg width")
    s.add_argument("--C", type=int, default=500)
    s.add_argument("--knn-graph", help="prebuilt efanna kNN graph file")
    s.add_argument("--batch", type=int, default=4096)
    s.add_argument("--force", action="store_true",
                   help="rebuild even if artifacts exist")

    s = command("search-hybrid", cmd_search_hybrid)
    s.add_argument("index", help="prefix used at build-hybrid")
    s.add_argument("queries")
    s.add_argument("--gt")
    s.add_argument("--k", type=int, default=100)
    s.add_argument("--search-ls", default="100,150,200,300,500",
                   dest="search_ls")
    s.add_argument("--result", help="write the sweep table as JSON")
    s.add_argument("--accel", action="store_true",
                   help="pack the NSG layer into int8 records "
                        "(one row gather per expansion)")

    s = command("convert", cmd_convert)
    s.add_argument("src")
    s.add_argument("dst")
    s.add_argument("--int8", action="store_true")

    s = command("calculate-recall", cmd_calculate_recall)
    s.add_argument("result")
    s.add_argument("gt")
    s.add_argument("--k", type=int, default=100)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
