"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on its own:
  1. device and build: require CUDA, print the card's name and power
     limit, compile the kernel from ``hnsw_nsg_tpu_torch/csrc``;
  2. kernel versus its plain PyTorch version on the card, per dtype pair,
     metric and shape, with the tolerance stated beside each case, and
     both times at the bench shape;
  3. the main path at full size: 1M x 128 clustered synthetic data (seed
     0), the f32 brute-force ground truth, ``build_cnns`` with bf16 slabs
     and boundary replication, and an nprobe sweep of ``CNNSIndex.search``
     (Q=8192, k=10) until recall@10 >= 0.95, with the kernel's launch count
     read around it;
  4. the last line: ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

BENCH = dict(c=1152, maxc=2056, d=128, cap=32, k=10, qn=8192)
KERNEL_SOURCE = "hnsw_nsg_tpu_torch/csrc/grouped_scan.cu"
REPLACES = "hnsw_nsg_tpu/ops/pallas_scan.py:244"
TARGET_RECALL = 0.95


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def make_case(gen, c, maxc, d, cap, qn, qdt, sdt, metric, pad_frac=0.1):
    """Random scan inputs on the card: slabs with ragged valid prefixes
    (and some all-pad clusters, as slab-count padding makes), query lists
    with -1 pads, bias = norms (l2) or 1 (ip), +inf on pad slots."""
    dev = "cuda"
    if sdt == torch.int8:
        s = torch.randint(-128, 128, (c, maxc, d), generator=gen,
                          dtype=torch.int8, device=dev)
    else:
        s = torch.randn((c, maxc, d), generator=gen, device=dev).to(sdt)
    if qdt == torch.int8:
        q = torch.randint(-128, 128, (qn, d), generator=gen,
                          dtype=torch.int8, device=dev)
    else:
        q = torch.randn((qn, d), generator=gen, device=dev).to(qdt)
    sizes = torch.randint(maxc // 2, maxc + 1, (c,), generator=gen,
                          device=dev)
    sizes[-max(1, c // 64):] = 0
    valid = torch.arange(maxc, device=dev)[None, :] < sizes[:, None]
    if metric == "l2":
        sf = s.float()
        base = (sf * sf).sum(-1)
        scale = 2.0
    else:
        base = torch.ones((c, maxc), device=dev)
        scale = 1.0
    bias = torch.where(valid, base, float("inf")).contiguous()
    qidx = torch.randint(0, qn, (c, cap), generator=gen, device=dev,
                         dtype=torch.int32)
    pad = torch.rand((c, cap), generator=gen, device=dev) < pad_frac
    qidx = torch.where(pad, -1, qidx).contiguous()
    return q.contiguous(), qidx, s.contiguous(), bias, scale


def check_scan(name, got, want, full_dist, live, rtol, atol):
    """vals allclose where the reference is finite on live rows; +inf where
    it is +inf; each returned slot's own reference distance equals the
    reference value at its rank (so an id may differ from the reference
    only in a tie within tolerance). Returns max |vals error|."""
    kv, ki = got
    rv, ri = want
    live = live[..., None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    if not bool(torch.equal(torch.isinf(kv[live]), torch.isinf(rv[live]))):
        raise AssertionError(f"{name}: +inf pattern differs from the reference")
    err = (kv[fin] - rv[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if not torch.allclose(kv[fin], rv[fin], rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: vals differ, max abs err {max_err}")
    own = torch.gather(full_dist, 2, ki.long().clamp(0, full_dist.shape[2] - 1))
    if not torch.allclose(own[fin], rv[fin], rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: a returned slot is not a top-k slot")
    mism = int((ki[fin] != ri[fin]).sum())
    print(f"  {name}: max_abs_err={max_err:.3g} (rtol={rtol}, atol={atol}) "
          f"id mismatches (ties) {mism}/{int(fin.sum())}")
    return max_err


def phase_kernels(gen):
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs

    b = BENCH
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # (name, c, maxc, d, cap, qn, qdt, sdt, metric, k, rtol, atol). f32
    # sums of d products in another order than cuBLAS: atol covers a few
    # ulps of |bias| (~2d for N(0,1) rows); int8 x int8 is exact integer
    # arithmetic; SQ8 rows have |bias| ~ 7e5 (ulp 0.06)
    cases = [
        ("bench bf16 l2", b["c"], b["maxc"], b["d"], b["cap"], b["qn"],
         bf, bf, "l2", b["k"], 1e-5, 1e-3),
        ("bench f32 l2", b["c"], b["maxc"], b["d"], b["cap"], b["qn"],
         f32, f32, "l2", b["k"], 1e-5, 1e-3),
        ("bench f32 ip", b["c"], b["maxc"], b["d"], b["cap"], b["qn"],
         f32, f32, "ip", b["k"], 1e-5, 1e-4),
        ("bench int8xint8 l2", b["c"], b["maxc"], b["d"], b["cap"], b["qn"],
         i8, i8, "l2", b["k"], 0.0, 0.0),
        ("bench int8 slab x bf16 q l2", b["c"], b["maxc"], b["d"], b["cap"],
         b["qn"], bf, i8, "l2", b["k"], 1e-5, 0.5),
        ("d=960 bf16 l2", 128, 1024, 960, 32, 2048, bf, bf, "l2", 10,
         1e-5, 5e-3),
        ("maxc=8200 cap=80 k=32 bf16 ip", 64, 8200, 128, 80, 4096, bf, bf,
         "ip", 32, 1e-5, 1e-4),
    ]
    bench_err = ms = plain_ms = None
    for (name, c, maxc, d, cap, qn, qdt, sdt, metric, k, rtol,
         atol) in cases:
        qc, qidx, slabs, bias, scale = make_case(
            gen, c, maxc, d, cap, qn, qdt, sdt, metric)
        args = (qc, qidx, slabs, bias, k, scale)
        got = cs.grouped_cluster_topk_gq(*args)
        torch.cuda.synchronize()
        want = cs.grouped_cluster_topk_gq_reference(*args)
        full = bias[:, None, :] - scale * cs._dots_reference(
            cs._gather_queries(qc, qidx), slabs)
        err = check_scan(name, got, want, full, qidx >= 0, rtol, atol)
        k_ms = cuda_ms(lambda: cs.grouped_cluster_topk_gq(*args), reps=10)
        p_ms = cuda_ms(lambda: cs.grouped_cluster_topk_gq_reference(*args),
                       reps=3)
        print(f"    kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms "
              f"(median)")
        if name == "bench bf16 l2":
            bench_err, ms, plain_ms = err, k_ms, p_ms
            # the d-blocked and pre-gathered entry points, same inputs
            got = cs.grouped_cluster_topk_gq_dblk(*args)
            check_scan("gq_dblk wrapper", got, want, full, qidx >= 0,
                       rtol, atol)
            qv = cs._gather_queries(qc, qidx).contiguous()
            got = cs.grouped_cluster_topk(qv, slabs, bias, k, scale)
            check_scan("pre-gathered wrapper", got, want, full, qidx >= 0,
                       rtol, atol)
            pg_ms = cuda_ms(lambda: cs.grouped_cluster_topk(
                qv, slabs, bias, k, scale), reps=10)
            pg_plain = cuda_ms(lambda: cs.grouped_cluster_topk_reference(
                qv, slabs, bias, k, scale), reps=3)
            print(f"    pre-gathered: kernel {pg_ms:.4f} ms, plain PyTorch "
                  f"{pg_plain:.4f} ms (median)")
            del qv
        del qc, qidx, slabs, bias, got, want, full, args
        torch.cuda.empty_cache()
    return bench_err, ms, plain_ms


def phase_main_path(card, n=1_000_000, nq=8192, device="cuda"):
    """The main path; smaller ``n``/``nq`` and ``device="cpu"`` rehearse it
    without a card."""
    from hnsw_nsg_tpu_torch.models.cnns import build_cnns
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    d, k = 128, 10
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    x, queries = make_data(n, d, nq, "l2", seed=0)
    print(f"data: {n}x{d} + {nq} queries in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    xd = torch.from_numpy(x).to(device)
    qd = torch.from_numpy(queries).to(device)
    t0 = time.perf_counter()
    _, gt = brute_force_topk(qd, xd, k, "l2")
    gt = gt.cpu()
    print(f"ground truth (f32, TF32 off): {time.perf_counter() - t0:.1f} s")
    del xd

    cs.launches = 0
    sync()
    t0 = time.perf_counter()
    idx = build_cnns(
        x, CNNSConfig(n_clusters=n // 1024, m=4, kmeans_iters=12,
                      replicate=True),
        slab_dtype=torch.bfloat16, device=device,
    )
    sync()
    build_s = time.perf_counter() - t0
    index_bytes = idx.index_bytes()
    print(f"build: {build_s:.2f} s, C={idx.n_clusters} maxc={idx.maxc} "
          f"index {index_bytes / 1e9:.4f} GB [{card}]")

    sweep = []
    reached = None
    for nprobe in (1, 2, 3, 4, 6, 8, 12, 16):
        dd, ii = idx.search(qd, k=k, nprobe=nprobe)
        r = recall(ii.cpu(), gt)
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            dd, ii = idx.search(qd, k=k, nprobe=nprobe)
            ii_host = ii.cpu()   # every rep copies its ids to the host
            ts.append(time.perf_counter() - t0)
        med = statistics.median(ts)
        sweep.append(dict(nprobe=nprobe, recall=r, ms=med * 1e3,
                          qps=nq / med))
        print(f"nprobe={nprobe}: recall@10={r:.4f} median {med * 1e3:.3f} "
              f"ms QPS={nq / med:.1f} (min {min(ts) * 1e3:.3f}, max "
              f"{max(ts) * 1e3:.3f} ms) [{card}]")
        if r >= TARGET_RECALL:
            reached = nprobe
            break
    launches = cs.launches
    print(f"kernel launches during build + sweep: {launches}")
    if launches <= 0:
        raise AssertionError("the search never launched the grouped scan kernel")
    if reached is None or reached > 4:
        raise AssertionError(
            f"recall@10 >= {TARGET_RECALL} not reached at nprobe <= 4: {sweep}")

    # output check: shape, finiteness, order, in-range ids, and the
    # returned distances against exact f32 distances of the returned ids
    # (bf16 slabs: rtol 1e-2)
    if tuple(dd.shape) != (nq, k) or tuple(ii_host.shape) != (nq, k):
        raise AssertionError(f"bad result shapes {dd.shape} {ii_host.shape}")
    ddh = dd.cpu()
    if not bool(torch.isfinite(ddh).all()):
        raise AssertionError("non-finite distances in the result")
    if not bool((ddh[:, 1:] >= ddh[:, :-1]).all()):
        raise AssertionError("result rows are not ascending")
    if not bool(((ii_host >= 0) & (ii_host < n)).all()):
        raise AssertionError("result ids out of range")
    ex = ((torch.from_numpy(x)[ii_host[:256]]
           - torch.from_numpy(queries)[:256, None, :]) ** 2).sum(-1)
    if not torch.allclose(ddh[:256], ex, rtol=1e-2, atol=1e-1):
        raise AssertionError("returned distances disagree with exact ones")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from hnsw_nsg_tpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    _build.load_library()
    print(f"kernel build: {_build.build_seconds:.2f} s "
          f"({_build.library_path().name})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("kernel vs plain PyTorch version:")
    max_err, ms, plain_ms = phase_kernels(gen)

    launches = phase_main_path(card)

    print(json.dumps({"kernels": [{
        "name": "grouped_cluster_topk_gq", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
