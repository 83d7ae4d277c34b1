"""Device times of the port's merge+select, grouped-scan (bf16, SQ8, f32
and int8 x int8) and cluster-join kernels for one source tree, on one
CUDA card.

    python3 scripts/time_port_kernels.py [--tree DIR] [--only KIND ...]

``--tree`` is the root of a checkout of this repository (default: the one
this script is in) whose ``hnsw_nsg_tpu_torch`` is built and timed;
``--only`` times some of the kinds (merge, scan, join, route, probe). The
inputs, their seeds, the repetitions and the timer (``cuda_ms``: CUDA
events around one launch queued behind a device sleep) are those of this
checkout's ``chip_smoke.py``, so two checkouts can be timed one after the
other on one card with the method and the shapes of ``chip_smoke.py``'s
own lines. The scan runs at ``chip_smoke.BENCH`` (C=1152, maxc=2056,
d=128, cap=32) in bf16 at k = 10, 20, 100 and 200, and with int8 slabs
and a bf16 query (SQ8) at k = 10, 20 and 200 there and at d=960 (C=128,
maxc=1024); the bf16 d=960 shape at k=10; f32 (query and slabs) at the
bench shape at k = 10, 20 and 200 and at d=960 at k=10; int8 x int8 at
the bench shape at k = 10, 20, 100 and 200 and at d=960 at k=10; past
each pair's resident query tile (the wide kernels, chip_smoke.py phase
2's shapes): bf16 at d=1928 (C=64, maxc=512) at k = 10 and 100, SQ8
there at k=10, f32 at d=1536 at k = 10 and 200, int8 x int8 at d=3848
(C=16) at k=10. The join runs at
the 1M build shape of ``chip_smoke.py`` phase 7 (the 1091 clusters that
phase 6's build of the 1M data makes, slabs of 2112 rows, M=8, d=128):
bf16 at k = 52, 102 and 202, f32 at k = 10, 52 and 102. The router
(``ops/route.py``) runs at the benchmark's two router shapes: 8,192
queries x 5,760 reps x d=128, l2, n_rep 10 (sift1m), and 8,192 x 6,400 x
3,072, ip, n_rep 15 with 976 of 1,280 clusters real (dbpedia), and at
n_rep 40 and 80 (nprobe 8 and 16: the selection past 32 columns) at
the first and 40 at the second, each line
with its plain version's time (cuBLAS f32 product and stable sort, the
router before the kernel) and its bound. The per-query probe path's
kernel (``ops/probe_scan.py``) runs at the batch512 cells' shapes
(``chip_smoke.PROBE_CASES``: 512 queries, kk = 20, sift1m's slabs at npr
2 and d=3072's at npr 3) beside its plain version (gather, f32 upcast,
batched product, running merge) and its bytes bounds. Prints one JSON line per
shape, each with ``digest``, a hash of the outputs' bytes, so that two
trees' lines show whether their kernels give the same bits on the same
inputs (the scan's on the rows that carry a result: pad rows are
unspecified; and of an +inf value only the value: the k <= 32 pipeline
kernels give slot 0 there, the CUDA-core kernels they replaced the
slot).
"""

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# chip_smoke.MERGE_CASES timed here, with their seeds
MERGE_TIMED = ("search shape", "collect pool", "build retset", "wide expand",
               "warp kernel L=1024", "general L=1025", "general L=2048",
               "general L=4096", "general scratch L=30000")
# the clusters of the 1M build (chip_smoke.py phase 6 prints its n_slabs)
BUILD_SLABS = 1091


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--only", nargs="+",
                    choices=("merge", "scan", "join", "route", "probe"),
                    default=("merge", "scan", "join", "route", "probe"))
    args = ap.parse_args()
    sys.path.insert(0, args.tree)   # the package under test
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms

    card = smoke.card_line()
    for i, (name, q, l, c, expand, _, _) in enumerate(smoke.MERGE_CASES):
        if name not in MERGE_TIMED or "merge" not in args.only:
            continue
        state = smoke.merge_state(100 + i, q, l, c, expand)
        t = smoke.cuda_ms(lambda: ms.fused_merge_select(*state, expand),
                          reps=50, warmup=5)
        out = digest(*ms.fused_merge_select(*state, expand))
        print(json.dumps(dict(kernel="fused_merge_select", tree=args.tree,
                              Q=q, L=l, C=c, expand=expand, ms=t,
                              digest=out, card=card)))
        del state
    if "scan" in args.only:
        time_scan(smoke, cs, args.tree, card)
    if "join" in args.only:
        time_join(smoke, cs, args.tree, card)
    if "route" in args.only:
        time_route(smoke, args.tree, card)
    if "probe" in args.only:
        time_probe(smoke, args.tree, card)


def time_scan(smoke, cs, tree, card):
    """The scan: one input set a (shape, pair) from chip_smoke's
    generator, every k on it."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b = smoke.BENCH
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    bench = (b["c"], b["maxc"], b["d"], b["cap"], b["qn"])
    d960 = (128, 1024, 960, 32, 2048)
    wide = (64, 512, 1928, 32, 1024)
    wide_f32 = (64, 512, 1536, 32, 1024)
    wide_i8 = (16, 512, 3848, 32, 512)
    label = {(bf, bf): "bf16", (bf, i8): "SQ8", (f32, f32): "f32",
             (i8, i8): "int8xint8"}
    for name, (c, maxc, d, cap, qn), (qdt, sdt), ks in (
            ("bench", bench, (bf, bf), (10, 20, 100, 200)),
            ("bench", bench, (bf, i8), (10, 20, 200)),
            ("d=960", d960, (bf, bf), (10,)),
            ("d=960", d960, (bf, i8), (10, 20, 200)),
            ("bench", bench, (f32, f32), (10, 20, 200)),
            ("d=960", d960, (f32, f32), (10,)),
            ("bench", bench, (i8, i8), (10, 20, 100, 200)),
            ("d=960", d960, (i8, i8), (10,)),
            ("wide", wide, (bf, bf), (10, 100)),
            ("wide", wide, (bf, i8), (10,)),
            ("wide", wide_f32, (f32, f32), (10, 200)),
            ("wide", wide_i8, (i8, i8), (10,))):
        qc, qidx, slabs, bias, scale = smoke.make_case(
            gen, c, maxc, d, cap, qn, qdt, sdt, "l2")
        live = qidx >= 0
        for k in ks:
            t = smoke.cuda_ms(lambda: cs.grouped_cluster_topk_gq(
                qc, qidx, slabs, bias, k, scale), reps=10)
            vals, idx = (o[live] for o in cs.grouped_cluster_topk_gq(
                qc, qidx, slabs, bias, k, scale))
            out = digest(vals, torch.where(torch.isinf(vals), 0, idx))
            print(json.dumps(dict(
                kernel="grouped_cluster_topk_gq " + label[qdt, sdt],
                tree=tree, shape=name, C=c, maxc=maxc, d=d, cap=cap,
                k=k, ms=t, digest=out, card=card)), flush=True)
        del qc, qidx, slabs, bias, live
        torch.cuda.empty_cache()


def time_join(smoke, cs, tree, card):
    """chip_smoke.phase_join_build's inputs (its seed) at three k, bf16
    and f32."""
    import torch

    bf = torch.bfloat16
    c, maxc, probes, d = BUILD_SLABS, 2112, 8, 128
    qv, st, bias, scale = smoke.join_case(4, c, maxc, probes * maxc, d, bf,
                                          "l2")
    for k in (52, 102, 202):
        t = smoke.cuda_ms(lambda: cs.cluster_join_topk(qv, st, bias, k,
                                                       scale),
                          reps=3, warmup=1)
        out = digest(*cs.cluster_join_topk(qv, st, bias, k, scale))
        print(json.dumps(dict(kernel="cluster_join_topk bf16",
                              tree=tree, C=c, maxc=maxc, M=probes, d=d,
                              k=k, ms=t, digest=out, card=card)))
        torch.cuda.empty_cache()
    del qv, st, bias
    torch.cuda.empty_cache()
    # the same in f32 (exact, on CUDA cores) at the k of phase 7's timed
    # calls
    qv, st, bias, scale = smoke.join_case(4, c, maxc, probes * maxc, d,
                                          torch.float32, "l2")
    for k in (10, 52, 102):
        t = smoke.cuda_ms(lambda: cs.cluster_join_topk(qv, st, bias, k,
                                                       scale),
                          reps=3, warmup=1)
        out = digest(*cs.cluster_join_topk(qv, st, bias, k, scale))
        print(json.dumps(dict(kernel="cluster_join_topk f32",
                              tree=tree, C=c, maxc=maxc, M=probes, d=d,
                              k=k, ms=t, digest=out, card=card)))
        torch.cuda.empty_cache()


def time_route(smoke, tree, card):
    """The router's kernel and its plain version on Gaussian rows at the
    benchmark's router shapes. Bound: the larger of 2 Q n_real d over the
    bf16 peak and the operands' bytes (each read once, the columns written
    once) over the HBM rate. A tree without the kernel prints nothing."""
    import torch

    try:
        from hnsw_nsg_tpu_torch.ops import route
    except ImportError:
        return
    from hnsw_nsg_tpu_torch.models.cnns import _route_operands

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name, qn, c, d, n_rep, n_valid, metric in (
            ("sift1m", 8192, 1152, 128, 10, 1152, "l2"),
            ("sift1m", 8192, 1152, 128, 40, 1152, "l2"),
            ("sift1m", 8192, 1152, 128, 80, 1152, "l2"),
            ("dbpedia", 8192, 1280, 3072, 15, 976, "ip"),
            ("dbpedia", 8192, 1280, 3072, 40, 976, "ip")):
        q = torch.randn((qn, d), generator=gen, device="cuda")
        reps = torch.randn((c, 5, d), generator=gen, device="cuda")
        flat, bias, scale = _route_operands(reps, metric, None)
        qb = q.to(torch.bfloat16)
        n_real = n_valid * 5
        args = (qb, flat, bias, n_rep, n_real, scale)
        t = smoke.cuda_ms(lambda: route.route_topk(*args), reps=20)
        t_plain = smoke.cuda_ms(
            lambda: route.route_topk_reference(*args), reps=5)
        out = route.route_topk(*args)
        flops = 2 * qn * n_real * d
        nbytes = 2 * (qn + n_real) * d + 4 * n_real + 8 * qn * n_rep
        bound = 1e3 * max(flops / smoke.PEAK_BF16_FLOPS,
                         nbytes / smoke.PEAK_BYTES)
        print(json.dumps(dict(
            kernel="route_topk", tree=tree, shape=name, Q=qn,
            columns=c * 5, real=n_real, d=d, n_rep=n_rep, metric=metric,
            ms=t, plain_ms=t_plain, bound_ms=bound,
            tflops=flops / t / 1e9, digest=digest(out),
            rows_equal_to_plain=(out == route.route_topk_reference(*args)
                                 ).all(1).float().mean().item(),
            card=card)), flush=True)
        del q, reps, flat, bias, qb, args, out
        torch.cuda.empty_cache()


def time_probe(smoke, tree, card):
    """The per-query probe path's kernel and its plain version at the
    batch512 cells' shapes (chip_smoke.PROBE_CASES, its inputs), with the
    bytes bounds of chip_smoke.probe_bounds: ``bound_ms`` reads each
    distinct slab once, as the call needs, ``bound_per_pair_ms`` once a
    pair. A tree without the kernel
    prints nothing."""
    import torch

    try:
        from hnsw_nsg_tpu_torch.ops import probe_scan
    except ImportError:
        return
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    for what, qn, c, maxc, d, npr, metric, kk in smoke.PROBE_CASES:
        args, _ = smoke.probe_case(gen, qn, c, maxc, d, npr, metric, kk)
        t = smoke.cuda_ms(lambda: probe_scan.probe_topk(*args), reps=20)
        t_plain = smoke.cuda_ms(
            lambda: probe_scan.probe_topk_reference(*args), reps=3,
            warmup=1)
        got = probe_scan.probe_topk(*args)
        want = probe_scan.probe_topk_reference(*args)
        b_pairs, b_distinct = smoke.probe_bounds(args)
        print(json.dumps(dict(
            kernel="probe_topk", tree=tree, shape=what, Q=qn, C=c,
            maxc=maxc, d=d, npr=npr, metric=metric, kk=kk, ms=t,
            plain_ms=t_plain, bound_ms=b_distinct[0],
            bound_per_pair_ms=b_pairs[0],
            share_of_bound=b_distinct[0] / t, digest=digest(*got),
            ids_equal_to_plain=(got[1] == want[1]).float().mean().item(),
            card=card)), flush=True)
        del args, got, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
