"""The grouped scan's share of the sift10m_u8 batch, with this checkout's
kernels and with another tree's, in turns, on one CUDA card.

    python3 scripts/u8_batch_ab.py --tree DIR [--n N]

Builds the index of ``chip_smoke.py``'s sift10m_u8 phase with this
checkout's package: ``make_data(N, 128, 8192, "l2", seed=0, uint8=True)``
(N = 10,000,000 by default, as ``bench.py`` publishes it), int8 slabs of
the rows shifted by 128, ``CNNSConfig(n_clusters=N // 1024, m=4,
kmeans_iters=12, replicate=True)``. Then it times ``CNNSIndex.search``
(Q=8192, 10 repetitions, each fetching its ids to the host) at nprobe 3
and 4 with k=10 and at nprobe 3 with k=100, with the grouped scan's calls
made by DIR's package (a checkout of this repository, imported under
another name, so both libraries live in one process and the index is
built once) and by this checkout's, in the order DIR, this, this, DIR,
and checks that both give the same ids and distances. Last, one search
at nprobe 3, k=10, under torch.profiler: the device time by kernel (the
ten largest), its sum and the idle share of the wall time. Prints one
JSON line a measurement, each with the card's name and power limit.
"""

import argparse
import importlib
import importlib.util
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--n", type=int, default=10_000_000)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from hnsw_nsg_tpu_torch.models import cnns
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    tmp = Path(tempfile.mkdtemp())
    try:
        shutil.copytree(Path(args.tree) / "hnsw_nsg_tpu_torch",
                        tmp / "other_port",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        sys.path.insert(0, str(tmp))
        other = importlib.import_module("other_port.ops.cluster_scan")
        run(smoke, cnns, cs, other, CNNSConfig, make_data, args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(smoke, cnns, cs, other, CNNSConfig, make_data, args):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = smoke.card_line()
    x, queries = make_data(args.n, 128, 8192, "l2", seed=0, uint8=True)
    t0 = time.perf_counter()
    idx = cnns.build_cnns(
        x, CNNSConfig(n_clusters=max(args.n // 1024, 8), m=4,
                      kmeans_iters=12, replicate=True),
        metric="l2", slab_dtype=torch.int8)
    torch.cuda.synchronize()
    print(json.dumps(dict(build_s=time.perf_counter() - t0,
                          slabs=idx.data_c.shape[0], maxc=idx.maxc,
                          card=card)), flush=True)
    del x
    qd = torch.from_numpy(queries).cuda()
    scans = {"this": cs.grouped_cluster_topk_gq,
             args.tree: other.grouped_cluster_topk_gq}

    def search(tree, k, nprobe):
        cnns.grouped_cluster_topk_gq = scans[tree]
        try:
            d, i = idx.search(qd, k=k, nprobe=nprobe)
            return d.cpu(), i.cpu()
        finally:
            cnns.grouped_cluster_topk_gq = scans["this"]

    for k, nprobe in ((10, 3), (10, 4), (100, 3)):
        want = search("this", k, nprobe)
        got = search(args.tree, k, nprobe)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for tree in (args.tree, "this", "this", args.tree):
            search(tree, k, nprobe)
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                search(tree, k, nprobe)
                ts.append(time.perf_counter() - t0)
            print(json.dumps(dict(tree=tree, k=k, nprobe=nprobe,
                                  batch_ms=statistics.median(ts) * 1e3,
                                  min_ms=min(ts) * 1e3, max_ms=max(ts) * 1e3,
                                  same_as_this=same, card=card)),
                  flush=True)

    search("this", 10, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search("this", 10, 3)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        search("this", 10, 3)
        torch.cuda.synchronize()
    top, total = [], 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev = ev.self_device_time_total / 1e3
            total += dev
            top.append((dev, ev.count, ev.key[:70]))
    top.sort(reverse=True)
    print(json.dumps(dict(profile="nprobe=3 k=10", device_ms=total,
                          wall_ms=wall_ms, idle_share=1 - total / wall_ms,
                          top=[dict(ms=t, calls=c, kernel=k)
                               for t, c, k in top[:10]], card=card)))


if __name__ == "__main__":
    main()
