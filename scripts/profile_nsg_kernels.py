"""Device time by kernel of the port's two paths on real states, for one
source tree, on one CUDA card.

    python3 scripts/profile_nsg_kernels.py [--tree DIR]
    python3 scripts/profile_nsg_kernels.py --cnns [--tree DIR]

With ``--cnns``: builds the 1M x 128 CNNS index of ``chip_smoke.py`` and
profiles three searches of 8192 queries at nprobe = 2, printing the wall
time per search, the device time in all and the six kernels that take
most of it. Otherwise: builds the kNN graph and the NSG of ``NSG_N`` =
150,000 x 128 points of ``make_data`` under torch.profiler (a cut: the
figures are not those of ``chip_smoke.py``'s 1M build, whose launches
have another mix of batch and retset sizes), then profiles three
searches of 8192 queries at l_search = 64, and prints for each phase the wall time, the
device time in all and the device time and launch count of the kernels
whose name contains ``merge_select`` or ``scan``. The profiler slows the
host down several times (a run takes about four minutes on an H100), so
only the device times mean anything. ``--tree`` is the root of a checkout
of this repository (default: the one this script is in), so two checkouts
can be profiled one after the other on one card with the same method.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

NSG_N = 150_000


def summarize(prof, wall_s, phase, tree, card, top=0):
    from torch.autograd import DeviceType

    total = 0.0
    picked = {}
    # kernels only: an operator's row repeats the time of its kernels
    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    for rank, ev in enumerate(evs):
        dev = getattr(ev, "self_device_time_total", 0.0)
        total += dev
        if "merge_select" in ev.key or "scan" in ev.key or rank < top:
            picked[ev.key[:60]] = dict(device_ms=dev / 1e3, calls=ev.count)
    print(json.dumps(dict(phase=phase, tree=tree, wall_s=wall_s,
                          device_ms=total / 1e3, kernels=picked, card=card)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--cnns", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from hnsw_nsg_tpu_torch.models.knn_ivf import knn_graph_ivf
    from hnsw_nsg_tpu_torch.models.nsg import build_nsg
    from hnsw_nsg_tpu_torch.utils.params import NSGBuildConfig
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.cnns:
        from hnsw_nsg_tpu_torch.models.cnns import build_cnns
        from hnsw_nsg_tpu_torch.utils.params import CNNSConfig

        n = 1_000_000
        x, q = make_data(n, 128, 8192, "l2", seed=0)
        qd = torch.from_numpy(q).to("cuda")
        idx = build_cnns(x, CNNSConfig(n_clusters=n // 1024, m=4,
                                       kmeans_iters=12, replicate=True),
                         slab_dtype=torch.bfloat16)
        for _ in range(3):
            idx.search(qd, k=10, nprobe=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(3):
                idx.search(qd, k=10, nprobe=2)
            torch.cuda.synchronize()
        summarize(prof, (time.perf_counter() - t0) / 3, "CNNS search "
                  "nprobe=2 (x3, wall per search)", args.tree, card, top=6)
        return
    x, q = make_data(NSG_N, 128, 8192, "l2", seed=0)
    xd = torch.from_numpy(x).to("cuda")
    qd = torch.from_numpy(q).to("cuda")
    cfg = NSGBuildConfig()
    adj = knn_graph_ivf(xd, cfg.L + 10, probes=8, kmeans_iters=8,
                        as_device=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        idx = build_nsg(xd, adj, cfg)
        torch.cuda.synchronize()
    summarize(prof, time.perf_counter() - t0, "build_nsg", args.tree, card)
    idx.search(qd, k=10, l_search=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(3):
            idx.search(qd, k=10, l_search=64)
        torch.cuda.synchronize()
    summarize(prof, (time.perf_counter() - t0) / 3, "search l_search=64 (x3, "
              "wall per search)", args.tree, card)


if __name__ == "__main__":
    main()
