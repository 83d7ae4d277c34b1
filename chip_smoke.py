"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on its own:
  1. device and build: require CUDA, print the card's name and power
     limit, compile the kernels from ``hnsw_nsg_tpu_torch/csrc`` (one nvcc
     per source, in parallel);
  2. the grouped-scan kernels versus their plain PyTorch version on the
     card, per dtype pair, metric and shape (the bench shape at k=10, and
     at k=20 in bf16 and f32, d=960 in bf16, f32
     and int8 x int8; past each pair's resident query tile, on the wide
     kernels (the query streamed through the ring), at k=10 and k=100:
     bf16 and SQ8 at d=1928 and d=3072, f32 at d=968 and d=1536, int8 x
     int8 at d=3848, bf16 at d=1930 (rows off 16 bytes); cap=80 with
     k=32, d=100),
     with the tolerance (int8 x int8: exact, ids equal too) and the count
     of near-tie ids stated
     beside each case, and both times and the bound of each; the general
     kernels (k > 32) at k = 33, 64, 100, 256 on the bench shape and
     k = maxc on a small one (and past the pair's width), every dtype
     pair, and at k=200 on the bench
     shape in bf16, f32 and SQ8, timed there and at k=100 (bf16 and int8 x
     int8). (The CNNS search scans at its own k, 10 or 100; a replicated
     index widens only the merge after the scan to 2k.) Each case asserts
     the kernel it launched
     (``cluster_scan.scan_kernel``: scan_mma or scan_general_mma on bf16
     tensor cores for a bf16 query with a bf16 or int8 slab up to
     d = 1920, scan_i8 or scan_general_i8 on s8 tensor cores for int8 x
     int8 up to d = 3840, scan_f32 or scan_general_f32 in exact FMAs for
     f32 up to d = 960, scan_wide or scan_general_wide past those widths,
     the same kernels with the query's d chunks streamed through the
     ring);
 2b. the flat router's kernel (``ops/route.py`` ``route_topk``:
     route_topk_kernel, and route_merge_kernel over the column splits)
     against its plain version on card tensors at the main paths' router
     shapes (ROUTE_CASES: sift1m's 1152 x 5 reps at d=128 and n_rep 10,
     40, 80 and at 512 queries, d=3072's 1280 x 5 with 976 clusters
     real at n_rep 15 and 80): the same rep sets and order ties aside,
     the same clusters visited in >= 99.9% of queries, both times, each
     kernel's device time and bound. The router's launches by kernel are
     read after each main path (``route_tally``) and go into the kernels
     line;
  2c. the per-query probe path's kernel (``ops/probe_scan.py``
     ``probe_topk``: probe_scan_kernel, then probe_merge_kernel) against
     its plain version on card tensors at the batch512 cells' shapes
     (PROBE_CASES: 512 queries, sift1m's 1152 slabs of 2056 x 128 at
     npr 2, l2, and d=3072's 1280 slabs of 2056 x 3072 at npr 3, ip;
     kk = 20): every distance within 1e-5 |q| |x| of its float64 value,
     ids equal but among near-ties (counted), both times, each kernel's
     device time and the bytes bound (each distinct slab read once, as the
     call needs; each pair's read once beside it);
  3. the CNNS flat path at full size: 1M x 128 clustered synthetic data
     (seed 0), the f32 brute-force ground truth, ``build_cnns`` with bf16
     slabs and boundary replication, and an nprobe sweep of
     ``CNNSIndex.search`` (Q=8192, k=10) until recall@10 >= 0.95; at that
     nprobe one search at the entry point's default k=100 (the general
     kernel), whose first 10 columns must keep recall@10 within 0.002,
     with recall@100 and its batch time; the scan's launches by kernel
     are read around it (scan_mma and scan_general_mma only). Then the
     same index with f32 slabs at that nprobe, k=10 and k=100, which runs
     the f32 kernels (scan_f32 and scan_general_f32 only). On the bf16
     index, the batch512 cells' call (512 queries, k=10, nprobe 2: fewer
     pairs than 2 C, the per-query path) with the probe kernels' launches
     zeroed just before and read right after (``probe_main_call``): one
     probe_scan and one probe_merge launch, every pair counted "kernel",
     and the result held against the same call with the plain version;
     these launches go into the kernels line;
 3b. gist1m as bench.py runs it: 1M x 960 L2 data (seed 0), an SQ8 index
     (``build_cnns(..., slab_dtype=torch.int8)`` on non-integral data,
     976 clusters), the exact f32 ground truth, an nprobe sweep (1..16)
     at k=10 with 10 timed repetitions each, one search at k=100; it
     fails unless recall@10 >= 0.95 at some nprobe <= 16 and the k=100
     run's recall@10 is within 0.002 of the k=10 run's, checks the
     output (finite, ascending, in-range ids, distances within rtol 1e-2
     of exact f32 ones), asserts the SQ8 path launched scan_mma and
     scan_general_mma only, and holds the kernel against its plain
     version on the scan inputs of one of its own searches at k=20 and
     k=200 (~70 s on the card);
 3c. sift10m_u8 as bench.py runs it: 10M x 128 uint8-valued L2 data
     (``make_data(..., uint8=True)``, seed 0), an index of int8 slabs of
     the rows shifted by 128 (``qshift == 128``, ``qscale == 1``: exact
     integer arithmetic, the int8 x int8 kernels), 9765 clusters, the
     exact f32 ground truth, an nprobe sweep (1..16) at k=10 with 10
     timed repetitions each and the path each took (per-query flat scan
     while probe pairs are fewer than 2 C, the grouped scan from there),
     one search at k=100 at the first grouped nprobe that reaches
     recall@10 >= 0.95 (within 0.002 of the k=10 run); the returned
     distances must equal the exact integer distances of the uint8 rows;
     the scan's launches must be scan_i8 and scan_general_i8 only; both
     kernels against their plain version (torch.equal on vals and ids) on
     the scan inputs of one of its searches, at k = 10, 20, 100 and 200,
     timed;
 3d. the host-spill index (``SpillCNNSIndex``, bench.py:339-412) over
     phase 3c's index under a device budget of 1.0 GB below its 3.09 GB:
     the spill index takes its pinned host copy, the resident index goes
     (``torch.cuda.empty_cache()``), then an nprobe sweep over 2, 4, 8 at
     k=10 (median of 3 timed repetitions): rounds, bytes moved, the
     largest group (at most the budget), the peak device memory of the
     search, and one group's host gather and host-to-device copy rates.
     The distances at nprobe 2 must equal phase 3c's resident search
     there (the per-query flat path) exactly, the ids too except among
     equal distances (counted);
 3e. an index at the width of OpenAI's text-embedding-3-large (Qdrant's
     dbpedia-entities-openai3-text-embedding-3-large-3072-1M; synthetic at
     that shape): 1M x 3072 unit-norm rows ranked by inner product
     (``make_data(..., "ip")``, seed 0), the exact f32 ground truth at
     k=100, a bf16 index (976 clusters, replicated) swept over nprobe
     1..16 at k=10 (10 timed repetitions each), k=100 at the chosen
     nprobe, the kernel against its plain version on one of its scan
     calls at k=10 and k=100 (times, bound, near-tie ids), then the same
     index on f32 slabs at that nprobe at k=10 and k=100; fails unless
     the f32 index reaches recall@10 >= 0.95 there, bf16 is within 0.01
     of it, each k=100 run within 0.002 of its k=10 run, the results are
     finite, ascending and in range, and the scan launched scan_wide and
     scan_general_wide only; prints the peak device memory and the
     phase's seconds;
  4. the merge+select kernel versus its plain version (``torch.equal`` on
     all five outputs) on states that a membership test can get wrong
     (colliding ids, id 0, ids near 2**31 - 1, candidates that all repeat
     one id, an all-PAD retset), at the search, collect-pool, build-retset
     and wide-expand shapes, the HNSW insert and search shapes, a ragged
     Q, all-PAD candidates and a converged retset, with its resident warps
     per SM; its 32-slot build (513 <= L <= 1024) on the same kinds of
     states at L = 513, 800, 1024, timed at (Q, L, C) = (8192, 1024, 32);
     its general kernel (L > 1024 or C > 1024) at (L, C) = (1025, 50),
     (4096, 128), (200, 1025), timed at L = 1025, 2048 and 4096 and at
     L = 30000 (its arrays in global scratch); and the
     cluster-join kernels versus their plain versions at small shapes
     (f32 on CUDA cores: l2 group 1, an inf tail, k = 65, 102, 107, 108
     and at d = 200 140, 141 (the heaps in global scratch from 108 and
     141), group 8 with a sparse last cluster; bf16 on
     tensor cores: ip group 4, group 8 with a ragged bucket tile, d=960,
     d=100, maxc=200, k=64, a sparse last cluster, k = 65, 102 with a
     sparse last cluster, 202, and 450 with its heaps in global scratch);
  5. the HNSW path at 1M points through the hnswlib-compatible API:
     ``Index("l2", 128)``, ``init_index(N, M=16, ef_construction=200)``,
     ``add_items`` (seconds, points/s, each insert phase's seconds),
     ``check_integrity``, a BFS from the enterpoint that must reach every
     node, the mean level-0 degree and the count of level >= 1 nodes; then
     ``knn_query`` (Q=8192, k=10) with ``set_ef`` over 16..256 and one
     batch at ef=1024, which runs merge+select's warp kernel at 32 slots a
     lane on real beam states, and one at ef=2048, its general kernel. It
     fails unless recall@10 >= 0.95 at some ef <= 256 and ef=1024 and
     ef=2048 are no lower than ef=256. Then ``build_accel`` (seconds,
     bytes) and the same ef sweep over the packed int8 records (recall
     beside the plain path's, batch ms, expansions and evaluations),
     gated the same and failing unless merge+select launched; one plain
     and one records search at ef=96 under torch.profiler (device ms a
     hop, the gather's and the products' shares, the idle share, bytes
     gathered a hop);
 5c. on phase 5's index (made with ``allow_replace_deleted=True``, which
     leaves the build as it is), after its graph was copied out for
     phase 6: (a) ``epsilon_query`` over the 8192 queries at
     max_candidates 128, epsilon the median over queries of the exact
     10th-NN distance: batch ms, mean and largest count, range recall
     against the exact in-range set capped at its 128 nearest (>= 0.9),
     every returned distance the exact one (allclose) and <= epsilon;
     (b) churn: ``mark_deleted`` of CHURN (100, cut from 1,000: 30-60
     s) seeded labels, then
     ``add_items(replace_deleted=True)`` of as many fresh rows of the
     same mixture, one point at a time as in the reference: ms per
     replaced point; the count unchanged, the deleted labels gone, the
     new points' self-query recall@1 >= 0.95, and recall@10 at phase 5's
     first ef >= 0.95 within 0.01 of phase 5's there, against a ground
     truth over the changed set. Merge+select's warp kernel must launch
     in both parts;
 5b. ``add_items(accel=True)`` on the first 250,000 points: seconds,
     points/s and each stage; the maintained record rows must equal a
     fresh pack of the final graph at the same scale; recall at ef=96
     against the cut's brute force;
  6. the hybrid path on the same data: ``HybridHNSWNSG(128, N,
     nsg_cfg=NSGBuildConfig())``, ``add_points`` (a second insert of the
     same seed: its graph must equal phase 5's at every level),
     ``build_nsg_layer()`` (``knn_graph_ivf`` with k=50, probes=8, then
     ``build_nsg`` with L=40, R=50, C=500; each stage's wall time, the kNN
     graph's recall on a 10k sample, the mean degree, a BFS proving
     connectivity); on its NSG an l_search sweep of ``NSGIndex.search``
     from the medoid (16..256, reported) and ``search_from_enterpoint``
     from sampled entries; then ``search_knn`` over the same sweep with
     ``entry="routed"`` and at l_search=64 with ``entry="descend"``. It
     fails unless the routed entry reaches recall@10 >= 0.95 at some
     l_search <= 256. Then ``build_accel`` and the routed sweep over the
     records, gated the same, profiled as in phase 5; kNN graphs through
     ``knn_graph_ivf`` at k=100 (join k = 102: the tensor-core join at 128
     rows a block) and k=200 (join k = 202: 64 rows a block), with their
     recall, and one at k=50 with f32 slabs (the CUDA-core join). The
     kernels' launch counts are set to 0 before and read after each
     path, merge+select's also by shape and by kernel, the join's by
     kernel;
 6b. CNNS with NSG locals on phase 3's data (bench.py:414-444, engine
     cnns_nsg): ``build_cnns(x, CNNSConfig(n_clusters=976, m=4,
     kmeans_iters=12), local_index="nsg")`` with f32 slabs, no
     replication: build seconds by stage (k-means, pools+prune,
     interinsert, repair), the arena's mean degree, a BFS from the entry
     points that must reach every node, the bytes of ``flat_adj`` and of
     the index; an nprobe sweep at k=10, l_search=100 (median of 10) that
     fails unless recall@10 >= 0.95 at some nprobe <= 8, with
     merge+select's launches by shape and kernel around it (it fails if
     none launched), and the output checked against exact f32 distances;
     at that nprobe ``router="hnsw"`` on this index and on phase 3's flat
     index, each within 0.05 recall of its flat router; then
     ``local_index="hnsw"`` on the first 65,536 rows in 64 clusters (cut:
     an ablation whose build runs one HNSW a cluster in turn): its arena
     must reach every node, its recall@10 at l_search 64 and nprobe 1, 2,
     4, 6 is printed (it falls as more clusters share the beam: reported,
     not gated), and its search on the card must equal the same index's
     on the CPU for 1,024 queries (ids at >= 99% of the slots, distances
     within rtol 1e-5, atol 1e-3 where the ids agree);
 6c. the small-N graph builders on the first 200,000 rows (the top of
     the hybrid's rp-tree range), the same queries and a ground truth
     over those rows: (a) ``HybridHNSWNSG(128, 200_000,
     nsg_cfg=NSGBuildConfig())``, ``add_points``, ``build_nsg_layer()``
     (rp-trees refined by two nn-descent iterations, then NSG): seconds
     of the insert, the rp-trees, nn-descent and the NSG build, kNN
     recall@50 on a 10k sample, mean degree, a BFS that must reach every
     node, the routed sweep over l_search 16..256 that must reach
     recall@10 >= 0.95; (b) ``nn_descent`` from random init on the first
     100,000 rows with ``NNDescentConfig()`` (the reference's defaults):
     recall@100 on 100 control rows each iteration (it must not fall) and
     seconds, a final recall@100 >= 0.8 on a 10k sample (the reference's
     10 iterations from random ids reach ~0.86 at this N); (c)
     ``graph_add`` of rows
     100,000-109,999 into (b)'s graph: the new rows' recall@100 against
     the exact graph over 110,000, 10k old rows' before and after; (d)
     ``MultiVectorIndex`` over the 200,000 rows as 25,000 documents of 8
     consecutive rows (M=16, ef_construction=200), ``knn_doc_query(k=10,
     ef=128)``: distinct documents in each row, doc recall@10 against the
     exact best-vector-per-document top-10. Merge+select's launches by
     kernel for each part; the warp kernel must launch in (a), (c), (d);
  7. the cluster-join kernels versus their plain versions at the build
     shape (C from phase 6, maxc 2112, M=8, d=128; bf16 at k=52, 102 and
     202, f32 at k=10, 52 and 102): both times, the rows a block, the id
     mismatches at near-ties, the bound (the products of the finite-bias
     slots only) and the kernel's share of it;
  8. the kernels line (seventeen entries, the scan's nine by kernel and
     slab type, the wide ones timed on phase 3e's own scan call, the
     router's two timed at sift1m's nprobe 2 call of phase 2b: times,
     launches, errors and each kernel's bound:
     the larger of its bytes over 3.35 TB/s and its operations over the
     peak of their type: 989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s
     f32), and the last line:
     ``{"ok": true, "device": ...}``.
  9. (run after 6c, before 7) the sharded indexes (``parallel/mesh.py``)
     on a mesh naming the card four times (four logical shards, so every
     merge runs on it), on
     phase 3's data and index: (a) ``ShardedFlatIndex`` at k=10 against
     ``brute_force_topk`` (distances within rtol 1e-5, ids equal outside
     ties); (b) ``sharded_knn_build_step`` at k=10 over the 1M rows, its
     seconds and its recall on a 10k-row sample (1.0 outside exact ties);
     (c) ``ShardedGraphIndex`` over four 250,000-row blocks, an NSG each
     (``knn_graph_ivf`` k=50 + ``NSGBuildConfig()``, blocks of 4096) and 1024
     representatives a shard, nprobe 4 and 2 over l_search 32, 64, 128:
     recall@10 >= 0.95 at nprobe 4 by l_search 128, fewer evaluations at
     nprobe 2, merge+select's warp kernel launched; (d)
     ``ShardedCNNSIndex`` over phase 3's index: with every probe kept
     four shards give one shard's distances exactly; an nprobe sweep (2,
     4, 8) at the default slots within 0.03 recall of one shard; the f32
     scans only; (e) ``MultiSliceCNNSIndex`` on a (2, 2) mesh equal row
     for row to two shards; (f) a 100,000-row uint8 index sharded gives
     ``CNNSIndex.search``'s distances exactly (F-R9); ``entry()`` and
     ``dryrun_multichip(4)``; the peak device memory of (a)-(e);
 10. (run after 9) the command line and the examples, as processes of
     their own: 200,000 rows, 1,000 queries and their exact top-10 as fvecs/ivecs, then
     ``python -m hnsw_nsg_tpu_torch.cli`` build-clusters -> build-nsg ->
     search-clusters (nsg and flat locals), build-knn --method ivf,
     build-hnsw -> search-hnsw (recall@10 >= 0.9 at its largest ef),
     build-hybrid -> search-hybrid --accel, convert (a byte-identical round
     trip), calculate-recall, in five chains side by side, each rc 0 with
     its seconds and recall, and beside them the eight examples, each rc
     0 (their launches are their processes' own, not in the kernels line);
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

BENCH = dict(c=1152, maxc=2056, d=128, cap=32, k=10, qn=8192)
# the scan's kernels: the ring pipeline's (bf16, SQ8, int8 x int8 and f32,
# each pair's instantiations in a file of their own), the wide ones (past
# a pair's resident query tile) in the d-blocked TPU kernel's place
PIPELINE_SOURCE = "hnsw_nsg_tpu_torch/csrc/scan_pipeline.cuh"
REPLACES = "hnsw_nsg_tpu/ops/pallas_scan.py:244"
WIDE_REPLACES = "hnsw_nsg_tpu/ops/pallas_scan.py:354"
TARGET_RECALL = 0.95
# the graph phases' point count: the sift1m shape (bench.py:65)
GRAPH_N = 1_000_000
EF_SWEEP = (16, 32, 64, 96, 128, 256)
EF_WIDE = 1024     # merge+select's warp kernel at 32 slots a lane
EF_WIDER = 2048    # past the warp kernel's L = 1024: the general kernel
L_SWEEP = (16, 24, 32, 48, 64, 96, 128, 192, 256)
# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the peak of each (query, slab) product type: exact f32 runs on CUDA
# cores (no TF32); int8 x int8 on int8 tensor cores; an int8 slab with a
# bf16 query as bf16
PEAK_OPS = {(torch.float32, torch.float32): 67e12,
            (torch.bfloat16, torch.bfloat16): PEAK_BF16_FLOPS,
            (torch.int8, torch.int8): 1979e12,
            (torch.bfloat16, torch.int8): PEAK_BF16_FLOPS}


# the flat router's kernels (ops/route.py), and their launches on the
# main paths by kernel, gathered by route_tally
ROUTE_SOURCE = "hnsw_nsg_tpu_torch/csrc/route.cu"
ROUTE_LAUNCHES: Counter = Counter()
# the router's calls on the main paths: (what, Q, C, real clusters, m1, d,
# metric, nprobe); n_rep = nprobe m1. sift1m (phase 3 and the sift1m
# cells, C = 1152, m = 4): nprobe 2 (the cells' call), 8 (the spill and
# sharded phases) and 16 (the top of phase 3's sweep), and the batch512
# cell's 512 queries; d = 3072 (phase 3e and the dbpedia cells: 976 of
# 1280 clusters real): nprobe 3 (the cells' call) and 16
ROUTE_CASES = (
    ("sift1m nprobe 2", 8192, 1152, 1152, 5, 128, "l2", 2),
    ("sift1m nprobe 8", 8192, 1152, 1152, 5, 128, "l2", 8),
    ("sift1m nprobe 16", 8192, 1152, 1152, 5, 128, "l2", 16),
    ("sift1m batch512", 512, 1152, 1152, 5, 128, "l2", 2),
    ("d=3072 nprobe 3", 8192, 1280, 976, 5, 3072, "ip", 3),
    ("d=3072 nprobe 16", 8192, 1280, 976, 5, 3072, "ip", 16),
)


def bound(n_bytes: float, flops: float = 0.0,
          peak_flops: float = PEAK_BF16_FLOPS):
    """The least time in ms the card could take for the work: the larger
    of the bytes over the memory rate and the operations over the peak
    rate of their type. Returns (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() in ms, CUDA events around each call.
    Each call is queued behind ~1 ms of device sleep, so the host has
    enqueued all of it before the device starts: a kernel of a few tens of
    microseconds is then timed by the device, not by how fast the host
    launches it."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
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
    if rtol == atol == 0.0 and mism:
        # exact arithmetic (int8 x int8): ties go to the lowest slot
        raise AssertionError(f"{name}: {mism} ids differ from the reference")
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
        # twice the bench k
        ("main path bf16 l2 k=20", b["c"], b["maxc"], b["d"], b["cap"],
         b["qn"], bf, bf, "l2", 20, 1e-5, 1e-3),
        ("bench f32 l2", b["c"], b["maxc"], b["d"], b["cap"], b["qn"],
         f32, f32, "l2", b["k"], 1e-5, 1e-3),
        ("main path f32 l2 k=20", b["c"], b["maxc"], b["d"], b["cap"],
         b["qn"], f32, f32, "l2", 20, 1e-5, 1e-3),
        ("bench f32 ip", b["c"], b["maxc"], b["d"], b["cap"], b["qn"],
         f32, f32, "ip", b["k"], 1e-5, 1e-4),
        ("bench int8xint8 l2", b["c"], b["maxc"], b["d"], b["cap"], b["qn"],
         i8, i8, "l2", b["k"], 0.0, 0.0),
        ("bench int8 slab x bf16 q l2", b["c"], b["maxc"], b["d"], b["cap"],
         b["qn"], bf, i8, "l2", b["k"], 1e-5, 0.5),
        ("d=960 bf16 l2", 128, 1024, 960, 32, 2048, bf, bf, "l2", 10,
         1e-5, 5e-3),
        ("d=960 f32 l2", 128, 1024, 960, 32, 2048, f32, f32, "l2", 10,
         1e-5, 5e-3),
        ("d=960 int8xint8 l2", 128, 1024, 960, 32, 2048, i8, i8, "l2", 10,
         0.0, 0.0),
        # past each pair's resident query tile (int8 x int8 3840, a bf16
        # query 1920, f32 960): the wide kernels, the query streamed
        # through the ring, at k <= 32 and k > 32
        ("d=3848 int8xint8 l2", 16, 512, 3848, 32, 512, i8, i8, "l2", 10,
         0.0, 0.0),
        ("d=3848 int8xint8 l2 k=100", 16, 512, 3848, 32, 512, i8, i8, "l2",
         100, 0.0, 0.0),
        ("d=1928 bf16 l2", 64, 512, 1928, 32, 1024, bf, bf, "l2", 10,
         1e-5, 1e-2),
        ("d=1928 bf16 l2 k=100", 64, 512, 1928, 32, 1024, bf, bf, "l2",
         100, 1e-5, 1e-2),
        ("d=1928 SQ8 l2", 64, 512, 1928, 32, 1024, bf, i8, "l2", 10,
         1e-5, 0.5),
        ("d=1928 SQ8 l2 k=100", 64, 512, 1928, 32, 1024, bf, i8, "l2", 100,
         1e-5, 0.5),
        ("d=3072 bf16 l2", 64, 512, 3072, 32, 1024, bf, bf, "l2", 10,
         1e-5, 2e-2),
        ("d=3072 bf16 l2 k=100", 64, 512, 3072, 32, 1024, bf, bf, "l2",
         100, 1e-5, 2e-2),
        ("d=3072 SQ8 l2", 64, 512, 3072, 32, 1024, bf, i8, "l2", 10,
         1e-5, 0.5),
        ("d=3072 SQ8 l2 k=100", 64, 512, 3072, 32, 1024, bf, i8, "l2", 100,
         1e-5, 0.5),
        ("d=968 f32 l2", 64, 512, 968, 32, 1024, f32, f32, "l2", 10,
         1e-5, 5e-3),
        ("d=968 f32 l2 k=100", 64, 512, 968, 32, 1024, f32, f32, "l2", 100,
         1e-5, 5e-3),
        ("d=1536 f32 l2", 64, 512, 1536, 32, 1024, f32, f32, "l2", 10,
         1e-5, 1e-2),
        ("d=1536 f32 l2 k=100", 64, 512, 1536, 32, 1024, f32, f32, "l2",
         100, 1e-5, 1e-2),
        # bf16 rows that start off 16 bytes: plain loads of slab and query
        ("d=1930 bf16 l2", 64, 512, 1930, 32, 1024, bf, bf, "l2", 10,
         1e-5, 1e-2),
        ("d=1930 bf16 l2 k=100", 64, 512, 1930, 32, 1024, bf, bf, "l2",
         100, 1e-5, 1e-2),
        ("maxc=8200 cap=80 k=32 bf16 ip", 64, 8200, 128, 80, 4096, bf, bf,
         "ip", 32, 1e-5, 1e-4),
        # rows that start off 16 bytes (plain loads), d padded to 112
        ("d=100 bf16 l2", 256, 1000, 100, 32, 2048, bf, bf, "l2", 10,
         1e-5, 1e-3),
    ]
    # the general kernel (k > 32): the bench shape at k = 33, 64, 100 and
    # 256 and a small case at k = maxc, every dtype pair, with the
    # tolerances of the cases above
    pair_tol = {(bf, bf): (1e-5, 1e-3), (f32, f32): (1e-5, 1e-3),
                (i8, i8): (0.0, 0.0), (bf, i8): (1e-5, 0.5)}
    for (qdt, sdt), (rtol, atol) in pair_tol.items():
        tag = "int8xint8" if qdt == i8 else "SQ8" if sdt == i8 else \
            str(qdt).split(".")[-1]
        for k in (33, 64, 100, 256):
            cases.append((f"general {tag} l2 k={k}", b["c"], b["maxc"],
                          b["d"], b["cap"], b["qn"], qdt, sdt, "l2", k,
                          rtol, atol))
        cases.append((f"general {tag} l2 k=maxc=300", 16, 300, 64, 32, 500,
                      qdt, sdt, "l2", 300, rtol, atol))
        # the same past the pair's resident width (the wide kernel)
        wide_d = {(bf, bf): 1928, (f32, f32): 968, (i8, i8): 3848,
                  (bf, i8): 1928}[qdt, sdt]
        cases.append((f"wide {tag} l2 k=maxc=300", 16, 300, wide_d, 32,
                      500, qdt, sdt, "l2", 300, rtol,
                      atol if qdt == i8 or sdt == i8 else 1e-2))
    # k = 200 (each row's buffer 2k + 32 keys, one block an SM), on the
    # bf16, f32 and SQ8 general kernels
    cases.append(("main path bf16 l2 k=200", b["c"], b["maxc"], b["d"],
                  b["cap"], b["qn"], bf, bf, "l2", 200, 1e-5, 1e-3))
    cases.append(("main path f32 l2 k=200", b["c"], b["maxc"], b["d"],
                  b["cap"], b["qn"], f32, f32, "l2", 200, 1e-5, 1e-3))
    cases.append(("main path SQ8 l2 k=200", b["c"], b["maxc"], b["d"],
                  b["cap"], b["qn"], bf, i8, "l2", 200, 1e-5, 0.5))
    # the k > 32 cases timed here (the others are checked only)
    timed_general = ("general bfloat16 l2 k=100", "general int8xint8 l2 k=100",
                     "main path bf16 l2 k=200",
                     "main path f32 l2 k=200", "main path SQ8 l2 k=200",
                     *(name for name, *_ in cases if name.startswith("wide ")
                       or name.startswith("d=") and name.endswith("k=100")))
    times = {}     # case name -> (kernel ms, plain ms, bound)
    errs = {}      # (kernel name, slab dtype) -> max |vals error|
    for (name, c, maxc, d, cap, qn, qdt, sdt, metric, k, rtol,
         atol) in cases:
        qc, qidx, slabs, bias, scale = make_case(
            gen, c, maxc, d, cap, qn, qdt, sdt, metric)
        args = (qc, qidx, slabs, bias, k, scale)
        kern = cs.scan_kernel(qdt, sdt, d, k)
        k0 = cs.launches_by_kernel[kern]
        got = cs.grouped_cluster_topk_gq(*args)
        torch.cuda.synchronize()
        if cs.launches_by_kernel[kern] != k0 + 1:
            raise AssertionError(f"{name}: k={k} did not run {kern}")
        want = cs.grouped_cluster_topk_gq_reference(*args)
        full = bias[:, None, :] - scale * cs._dots_reference(
            cs._gather_queries(qc, qidx), slabs)
        err = check_scan(f"{name} ({kern})", got, want, full, qidx >= 0,
                         rtol, atol)
        errs[kern, sdt] = max(errs.get((kern, sdt), 0.0), err)
        if k > cs.MAX_K and name not in timed_general:
            del qc, qidx, slabs, bias, got, want, full, args
            torch.cuda.empty_cache()
            continue
        k_ms = cuda_ms(lambda: cs.grouped_cluster_topk_gq(*args), reps=10)
        p_ms = cuda_ms(lambda: cs.grouped_cluster_topk_gq_reference(*args),
                       reps=3)
        b_case = scan_bound(qc, qidx, slabs, bias, got, qdt, sdt)
        times[name] = (k_ms, p_ms, b_case)
        print(f"    kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms "
              f"(median); bound {b_case[0]:.4f} ms ({b_case[1]}), kernel "
              f"at {b_case[0] / k_ms:.1%} of it")
        if name == "bench bf16 l2":
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
            pg_bound = bound(nbytes(qv, slabs, bias, *got),
                             2.0 * int((qidx >= 0).sum()) * maxc * d)
            print(f"    pre-gathered: kernel {pg_ms:.4f} ms, plain PyTorch "
                  f"{pg_plain:.4f} ms (median); bound {pg_bound[0]:.4f} ms "
                  f"({pg_bound[1]})")
            del qv
        del qc, qidx, slabs, bias, got, want, full, args
        torch.cuda.empty_cache()
    return errs, times


def scan_bound(qc, qidx, slabs, bias, out, qdt, sdt):
    """The scan's bound: its bytes (inputs read once, outputs written once;
    of the slabs and their bias only those a live query row probes: a slab
    whose query list is all pad needs no byte) and the products of its
    live query rows (pad rows need no work) at their type's peak."""
    c, maxc, d = slabs.shape
    flops = 2.0 * int((qidx >= 0).sum()) * maxc * d
    probed = int((qidx >= 0).any(1).sum())
    slab_bytes = probed * maxc * (d * slabs.element_size() + 4)
    return bound(nbytes(qc, qidx, *out) + slab_bytes, flops,
                 PEAK_OPS[(qdt, sdt)])


def kernel_ms(fn, names, calls: int = 5):
    """Device ms a call of each kernel whose name contains one of
    ``names``: ``calls`` calls of fn() under torch.profiler, each kernel's
    self device time over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            for name in names:
                if name in ev.key:
                    out[name] += ev.self_device_time_total / 1e3 / calls
    return out


def phase_route(card):
    """The flat router's kernel (``ops/route.py`` ``route_topk``: the
    product on bf16 tensor cores and the top-n_rep in its epilogue, plus
    ``route_merge`` over the column splits) against its plain version
    (``route_topk_reference``: cuBLAS f32 product of the bf16 values, a
    stable sort) on card tensors at the main paths' router shapes
    (ROUTE_CASES), on Gaussian rows (unit rows for ip). Fails unless every
    column that one takes and the other does not lies within
    1e-5 |q| max |r| of the row's n_rep-th distance (float64: ties aside,
    the same rep set), the two columns at each rank lie within 2e-5 |q|
    max |r| of each other (ties aside, the same order), and the two route
    to the same clusters in >= 99.9% of the queries. Prints, by case, the launches by kernel, the column
    splits, the rows with another rep set or order, the largest gap
    between the float64 distances of the two columns at a rank, both
    times, each kernel's device time (torch.profiler) and the bounds.
    Returns {what: dict}."""
    from hnsw_nsg_tpu_torch.models.cnns import _rank_rep_hits, _route_operands
    from hnsw_nsg_tpu_torch.ops import route
    from hnsw_nsg_tpu_torch.ops._build import load_library

    route_tally()        # launches before here are the main paths'
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    out = {}
    for what, qn, c, real, m1, d, metric, nprobe in ROUTE_CASES:
        q = torch.randn((qn, d), generator=gen, device="cuda")
        reps = torch.randn((c, m1, d), generator=gen, device="cuda")
        if metric == "ip":
            q = q / q.norm(dim=1, keepdim=True)
            reps = reps / reps.norm(dim=2, keepdim=True)
        flat, bias, scale = _route_operands(reps, metric, None)
        n_rep, n_real = nprobe * m1, real * m1
        qb = q.to(torch.bfloat16)
        args = (qb, flat, bias, n_rep, n_real, scale)
        before = dict(route.launches_by_kernel)
        got = route.route_topk(*args)
        launched = {k: v - before.get(k, 0)
                    for k, v in route.launches_by_kernel.items()
                    if v != before.get(k, 0)}
        want = route.route_topk_reference(*args)
        splits = load_library().route_topk_splits(
            qn, min(c * m1, n_real + n_rep), sms)
        if launched != ({"route_topk": 1, "route_merge": 1} if splits > 1
                        else {"route_topk": 1}):
            raise AssertionError(f"route {what}: launched {launched} with "
                                 f"{splits} splits")
        qd, fd = qb.double(), flat[:n_real].double()
        exact = bias[:n_real].double()[None] - scale * (qd @ fd.T)
        g_d, w_d = torch.gather(exact, 1, got), torch.gather(exact, 1, want)
        gap = (g_d - w_d).abs().max(1).values
        err = float(gap.max())
        tol_q = 1e-5 * qd.norm(dim=1) * fd.norm(dim=1).max()
        if not bool((gap <= 2 * tol_q).all()):
            raise AssertionError(f"route {what}: a column out of order by "
                                 f"{err} (more than 2e-5 |q| |r|)")
        other_order = int((got != want).any(1).sum())
        rows = (~(got.sort(1).values == want.sort(1).values).all(1)
                ).nonzero()[:, 0]
        if rows.numel():
            kth = w_d[rows].max(1).values[:, None]
            tol = tol_q[rows][:, None]
            for a, b, a_d in ((got[rows], want[rows], g_d[rows]),
                              (want[rows], got[rows], w_d[rows])):
                only = ~(a[:, :, None] == b[:, None, :]).any(2)
                if not bool(((a_d - kth).abs() <= tol)[only].all()):
                    raise AssertionError(
                        f"route {what}: a rep off the n_rep-th distance "
                        f"by more than 1e-5 |q| |r|")
        same = (_rank_rep_hits(got, m1, nprobe, "hits")
                == _rank_rep_hits(want, m1, nprobe, "hits")
                ).all(1).float().mean().item()
        if same < 0.999:
            raise AssertionError(f"route {what}: equal visits in {same}")
        del exact, g_d, w_d, qd, fd, gap, tol_q
        k_ms = cuda_ms(lambda: route.route_topk(*args), reps=20)
        p_ms = cuda_ms(lambda: route.route_topk_reference(*args), reps=5)
        by_kernel = kernel_ms(lambda: route.route_topk(*args),
                              ("route_topk_kernel", "route_merge_kernel"))
        n_cols = min(c * m1, n_real + n_rep)
        b_k = bound(2 * (qn + n_cols) * d + 4 * n_cols + 8 * qn * n_rep,
                    2 * qn * n_real * d)
        b_m = bound(8 * qn * n_rep * (splits + 1)) if splits > 1 else None
        out[what] = dict(n_rep=n_rep, splits=splits, err=err,
                         rows_other_set=int(rows.numel()),
                         rows_other_order=other_order, visits_equal=same,
                         ms=k_ms, plain_ms=p_ms,
                         topk_ms=by_kernel["route_topk_kernel"],
                         merge_ms=by_kernel["route_merge_kernel"],
                         bound=b_k, merge_bound=b_m)
        print(f"route {what} (Q={qn}, {c * m1} columns, {n_real} real, "
              f"d={d}, {metric}, n_rep={n_rep}, {splits} splits): launched "
              f"{launched}; {int(rows.numel())} rows with another rep set, "
              f"{other_order} with another order, largest gap at a rank "
              f"{err:.3e}, visits equal in {same:.5f}; kernel {k_ms:.4f} ms "
              f"(route_topk_kernel {by_kernel['route_topk_kernel']:.4f}, "
              f"route_merge_kernel {by_kernel['route_merge_kernel']:.4f}), "
              f"plain {p_ms:.4f} ms; bound {b_k[0]:.4f} ms ({b_k[1]}), "
              f"route_topk_kernel at "
              f"{b_k[0] / max(by_kernel['route_topk_kernel'], 1e-9):.1%} "
              f"of it [{card}]")
        del q, reps, flat, bias, qb, args, got, want
        torch.cuda.empty_cache()
    route.launches = 0            # the checks' own, not a main path's
    route.launches_by_kernel.clear()
    return out


PROBE_SOURCE = "hnsw_nsg_tpu_torch/csrc/probe_scan.cu"
# the per-query path's calls in the benchmark's batch512 cells: (what, Q,
# C, maxc, d, npr, metric, kk); kk = 2k, the slabs being replicated
PROBE_CASES = (
    ("sift1m batch512", 512, 1152, 2056, 128, 2, "l2", 20),
    ("dbpedia batch512", 512, 1280, 2056, 3072, 3, "ip", 20),
)


def probe_case(gen, qn, c, maxc, d, npr, metric, kk):
    """probe_topk's arguments on the card: Gaussian slabs (unit rows for
    ip) made a chunk of clusters at a time, 7 dead rows a slab, each
    query's npr clusters drawn without repeats."""
    from hnsw_nsg_tpu_torch.ops.distance import squared_norms

    data_c = torch.empty((c, maxc, d), dtype=torch.bfloat16, device="cuda")
    for s in range(0, c, 64):
        x = torch.randn((min(64, c - s), maxc, d), generator=gen,
                        device="cuda")
        if metric == "ip":
            x = x / x.norm(dim=2, keepdim=True)
        data_c[s : s + 64] = x.to(torch.bfloat16)
        del x
    q = torch.randn((qn, d), generator=gen, device="cuda")
    if metric == "ip":
        q = q / q.norm(dim=1, keepdim=True)
    ids_c = torch.arange(c * maxc, dtype=torch.int32,
                         device="cuda").reshape(c, maxc)
    ids_c[:, -7:] = -1
    visit = torch.rand((qn, c), generator=gen, device="cuda").argsort(1)[
        :, :npr].contiguous()
    l2 = metric == "l2"
    return (q.to(torch.bfloat16), visit, data_c, ids_c,
            squared_norms(data_c) if l2 else None,
            squared_norms(q) if l2 else None, kk, metric), q


def probe_bounds(args):
    """The bytes bound of a probe_topk call in ms: each pair's slab, ids
    and norms read once (and, the second, each distinct cluster's once),
    the query rows read and the [Q, kk] outputs written once."""
    qc, visit, data_c, ids_c, cn, qn, kk, _ = args
    _, maxc, d = data_c.shape
    row = 2 * d + 4 + (4 if cn is not None else 0)
    fixed = nbytes(qc) + 8 * visit.numel() + 8 * qc.shape[0] * kk
    live = int((visit >= 0).sum())
    distinct = int(torch.unique(visit[visit >= 0]).numel())
    return (bound(fixed + live * maxc * row),
            bound(fixed + distinct * maxc * row))


def phase_probe(card, cases=PROBE_CASES):
    """The per-query probe path's kernel (``ops/probe_scan.py``
    ``probe_topk``: probe_scan_kernel scores each (pair, row split) where
    the slab lies, probe_merge_kernel folds each query's lists) against
    its plain version (``probe_topk_reference``: a gather of each probe
    slot's slabs, their f32 upcast, a batched f32 product, a stable running
    merge) at the batch512 cells' shapes (PROBE_CASES). Fails unless every
    returned distance of either lies within 1e-5 |q| max |x| (l2: + |q|^2
    + max |x|^2) of its float64 value, the two agree there where they
    return one id, and every id that one returns and the other does not
    lies within twice that of the kk-th distance (a near-tie). Prints the
    near-ties, the launches, both times, each kernel's device time
    (torch.profiler) and the two bytes bounds; the kernel's share is of
    the bound that reads each distinct slab once, which is all the call
    needs. Returns {what: dict}."""
    from hnsw_nsg_tpu_torch.ops import probe_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    out = {}
    for what, qn, c, maxc, d, npr, metric, kk in cases:
        args, q = probe_case(gen, qn, c, maxc, d, npr, metric, kk)
        before = dict(probe_scan.launches_by_kernel)
        gd, gi = probe_scan.probe_topk(*args)
        launched = {k: v - before.get(k, 0)
                    for k, v in probe_scan.launches_by_kernel.items()
                    if v != before.get(k, 0)}
        if launched != {"probe_scan": 1, "probe_merge": 1}:
            raise AssertionError(f"probe {what}: launched {launched}")
        wd, wi = probe_scan.probe_topk_reference(*args)
        qc, visit, data_c = args[:3]
        flat = data_c.reshape(-1, d)
        qd = qc.double()
        qnrm = qd.norm(dim=1)[:, None]
        xnrm = max(float(data_c[s : s + 64].float().norm(dim=2).max())
                   for s in range(0, c, 64))
        l2 = metric == "l2"
        tol = 1e-5 * (qnrm * xnrm + (qnrm ** 2 + xnrm ** 2 if l2 else 0))

        def exact(ids):
            xs = flat[ids.long().clamp(min=0)].double()
            dots = (xs * qd[:, None, :]).sum(2)
            if l2:
                return ((xs * xs).sum(2) - 2 * dots
                        + (q.double() ** 2).sum(1)[:, None])
            return 1 - dots

        err = max(float((gd - exact(gi)).abs().max()),
                  float((wd - exact(wi)).abs().max()))
        if not (bool(((gd - exact(gi)).abs() <= tol).all())
                and bool(((wd - exact(wi)).abs() <= tol).all())):
            raise AssertionError(f"probe {what}: a distance off its float64 "
                                 f"value by {err:.3e}")
        same = gi == wi
        if not bool(((gd - wd).abs() <= 2 * tol)[same].all()):
            raise AssertionError(f"probe {what}: one id, two distances")
        kth = torch.maximum(gd[:, -1], wd[:, -1])[:, None]
        for a, b, ad in ((gi, wi, gd), (wi, gi, wd)):
            only = ~(a[:, :, None] == b[:, None, :]).any(2)
            if not bool(((kth - ad).abs() <= 2 * tol)[only].all()):
                raise AssertionError(f"probe {what}: an id off the kk-th "
                                     f"distance (not a near-tie)")
        near = int((~same).sum())
        k_ms = cuda_ms(lambda: probe_scan.probe_topk(*args), reps=20)
        p_ms = cuda_ms(lambda: probe_scan.probe_topk_reference(*args),
                       reps=3, warmup=1)
        by_kernel = kernel_ms(lambda: probe_scan.probe_topk(*args),
                              ("probe_scan_kernel", "probe_merge_kernel"))
        b_pairs, b_distinct = probe_bounds(args)
        s_ms = by_kernel["probe_scan_kernel"]
        out[what] = dict(err=err, near_ties=near, ms=k_ms, plain_ms=p_ms,
                         scan_ms=s_ms,
                         merge_ms=by_kernel["probe_merge_kernel"],
                         bound=b_distinct, bound_per_pair=b_pairs)
        print(f"probe {what} (Q={qn}, C={c}, maxc={maxc}, d={d}, npr={npr}, "
              f"{metric}, kk={kk}): launched {launched}; {near} ids at "
              f"another place (near-ties), largest distance error "
              f"{err:.3e}; kernel {k_ms:.4f} ms (probe_scan_kernel "
              f"{s_ms:.4f}, probe_merge_kernel "
              f"{by_kernel['probe_merge_kernel']:.4f}), plain {p_ms:.4f} ms; "
              f"bound {b_distinct[0]:.4f} ms ({b_distinct[1]}, each "
              f"distinct slab read once; {b_pairs[0]:.4f} reading it once "
              f"a pair), probe_scan_kernel at "
              f"{b_distinct[0] / max(s_ms, 1e-9):.1%} of it [{card}]",
              flush=True)
        del args, q, gd, gi, wd, wi, flat, qd
        torch.cuda.empty_cache()
    return out


def probe_main_call(card, idx, q, k, nprobe, device="cuda"):
    """The batch512 cells' call on a main path's bf16 index:
    ``idx.search(q, k, nprobe)`` with fewer pairs than 2 C, so
    ``_flat_probe_search`` answers it. The probe kernels' launches are
    zeroed just before and read right after; then the same call runs with
    the plain version (``probe_topk_reference``) in ``probe_topk``'s
    place. Fails unless, on the card, it launched probe_scan and
    probe_merge once each and counted every pair "kernel" (on the CPU:
    "plain", no launch), and the two results agree: where they return one
    id, distances within 1e-5 (|q| max |x| + |q|^2 + max |x|^2); every id
    one returns and the other does not within twice that of the k-th
    distance (a near-tie). Returns the launches by kernel."""
    from unittest import mock

    from hnsw_nsg_tpu_torch.models import cnns
    from hnsw_nsg_tpu_torch.ops import probe_scan

    qn = q.shape[0]
    probe_scan.launches_by_kernel.clear()
    before = dict(cnns.probe_counts)
    gd, gi = idx.search(q, k=k, nprobe=nprobe)
    launched = dict(probe_scan.launches_by_kernel)
    pairs = {key: cnns.probe_counts[key] - before.get(key, 0)
             for key in ("kernel", "plain")}
    on_card = device == "cuda"
    want_pairs = {"kernel": qn * nprobe if on_card else 0,
                  "plain": 0 if on_card else qn * nprobe}
    want_launched = ({"probe_scan": 1, "probe_merge": 1} if on_card
                     else {})
    if launched != want_launched or pairs != want_pairs:
        raise AssertionError(f"batch512 call: launched {launched}, pairs "
                             f"{pairs}; want {want_launched}, {want_pairs}")
    with mock.patch.object(cnns, "probe_topk",
                           probe_scan.probe_topk_reference):
        wd, wi = idx.search(q, k=k, nprobe=nprobe)
    qnrm = q.double().norm(dim=1)[:, None]
    xnrm = max(float(idx.data_c[s : s + 64].float().norm(dim=2).max())
               for s in range(0, idx.data_c.shape[0], 64))
    tol = 1e-5 * (qnrm * xnrm + qnrm ** 2 + xnrm ** 2)
    same = gi == wi
    if not bool(((gd - wd).abs() <= 2 * tol)[same].all()):
        raise AssertionError("batch512 call: one id, two distances")
    kth = torch.maximum(gd[:, -1], wd[:, -1])[:, None]
    for a, b, ad in ((gi, wi, gd), (wi, gi, wd)):
        only = ~(a[:, :, None] == b[:, None, :]).any(2)
        if not bool(((kth - ad).abs() <= 2 * tol)[only].all()):
            raise AssertionError("batch512 call: an id off the k-th "
                                 "distance (not a near-tie)")
    print(f"batch512 call (Q={qn}, k={k}, nprobe={nprobe}): launched "
          f"{launched}, pairs {pairs}; {int((~same).sum())} ids of "
          f"{same.numel()} at another place than the plain version's "
          f"(near-ties) [{card}]")
    probe_scan.launches_by_kernel.clear()
    return launched


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
    _, gt100 = brute_force_topk(qd, xd, 100, "l2")
    gt100 = gt100.cpu()
    print(f"ground truth (f32, TF32 off), k=10 and k=100: "
          f"{time.perf_counter() - t0:.1f} s")
    del xd

    reset_scan_counts(cs)
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
    if reached is None or reached > 4:
        raise AssertionError(
            f"recall@10 >= {TARGET_RECALL} not reached at nprobe <= 4: {sweep}")
    # the entry point's own default, k = 100 (the general kernel): its
    # first 10 columns are the same exact top-10 of the probed slabs
    d100, i100 = idx.search(qd, k=100, nprobe=reached)
    r10, r100 = recall(i100[:, :10].cpu(), gt), recall(i100.cpu(), gt100)
    med, lo, hi = timed_query(
        lambda: idx.search(qd, k=100, nprobe=reached)[1].cpu())
    print(f"nprobe={reached} k=100: recall@10={r10:.4f} (k=10 run: "
          f"{sweep[-1]['recall']:.4f}) recall@100={r100:.4f} median "
          f"{med * 1e3:.3f} ms QPS={nq / med:.1f} (min {lo * 1e3:.3f}, max "
          f"{hi * 1e3:.3f} ms) [{card}]")
    if tuple(i100.shape) != (nq, 100) or abs(r10 - sweep[-1]["recall"]) > 0.002:
        raise AssertionError(f"k=100 gives shape {tuple(i100.shape)}, "
                             f"recall@10 {r10} against {sweep[-1]['recall']}")
    if not bool(torch.isfinite(d100).all()):
        raise AssertionError("non-finite distances at k=100")
    counts = scan_counts(cs, "build + sweep + k=100", device, routed=True)
    if device == "cuda" and set(counts) != {"scan_mma", "scan_general_mma"}:
        raise AssertionError(f"the bf16 search ran other scan kernels than "
                             f"scan_mma and scan_general_mma: {counts}")

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
    del dd, d100, i100
    probe_launches = probe_main_call(card, idx, qd[:512], k, 2, device)
    f32_counts = phase_f32_search(card, x, qd, gt, reached,
                                  sweep[-1]["recall"], device)
    # the index stays for phase 6b's HNSW router
    return counts, f32_counts, idx, probe_launches


def phase_f32_search(card, x, qd, gt, nprobe, bf16_recall, device="cuda"):
    """The same index with exact f32 slabs (the f32 scan kernels:
    scan_f32_kernel at the search's k = 10, scan_general_f32_kernel at
    k = 100), searched at ``nprobe``: recall@10 of both, the batch
    time, and the launches by kernel. Fails unless recall@10 is within
    0.005 of the bf16 index's at k=10 and the k=100 run's within 0.002 of
    its own k=10 run's."""
    from hnsw_nsg_tpu_torch.models.cnns import build_cnns
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import recall
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig

    nq = qd.shape[0]
    reset_scan_counts(cs)
    t0 = time.perf_counter()
    idx = build_cnns(
        x, CNNSConfig(n_clusters=x.shape[0] // 1024, m=4, kmeans_iters=12,
                      replicate=True),
        slab_dtype=torch.float32, device=device)
    build_s = time.perf_counter() - t0
    rec = {}
    for k in (10, 100):
        _, ii = idx.search(qd, k=k, nprobe=nprobe)
        rec[k] = recall(ii[:, :10].cpu(), gt)
        med, lo, hi = timed_query(
            lambda: idx.search(qd, k=k, nprobe=nprobe)[1].cpu())
        print(f"f32 slabs (build {build_s:.2f} s), nprobe={nprobe} k={k}: "
              f"recall@10={rec[k]:.4f} median {med * 1e3:.3f} ms QPS="
              f"{nq / med:.1f} (min {lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) "
              f"[{card}]")
    if rec[10] < bf16_recall - 0.005 or abs(rec[100] - rec[10]) > 0.002:
        raise AssertionError(f"f32 slabs: recall@10 {rec} against the bf16 "
                             f"index's {bf16_recall}")
    counts = scan_counts(cs, "f32 slabs, build + k=10 + k=100", device,
                          routed=True)
    if device == "cuda" and set(counts) != {"scan_f32", "scan_general_f32"}:
        raise AssertionError(f"the f32 search ran other scan kernels than "
                             f"scan_f32 and scan_general_f32: {counts}")
    return counts


GIST_NPROBE = (1, 2, 3, 4, 6, 8, 12, 16)


def phase_gist(card, n=1_000_000, d=960, nq=8192, device="cuda",
               n_clusters=976):
    """gist1m as bench.py runs it (bench.py:66-69, :156, :414-492): 1M x
    960 L2 clustered synthetic data (seed 0), an SQ8 index (int8 slabs of
    non-integral data), the exact f32 ground truth, an nprobe sweep of
    ``CNNSIndex.search`` at k=10 (10 timed repetitions, each fetching its
    ids to the host) and one search at k=100 (the general tensor-core
    kernel at k = 200). Then the kernel against its plain version on the
    scan inputs of one of the phase's own searches, at k=20 and k=200.
    Smaller ``n``/``nq`` and ``device="cpu"`` rehearse it without a
    card. Returns the scan's launches by kernel and, on the card, the
    kernel's (error, ms, plain ms, bound) at both k."""
    from hnsw_nsg_tpu_torch.models import cnns as cnns_mod
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, queries = make_data(n, d, nq, "l2", seed=0)
    print(f"gist1m data: {n}x{d} + {nq} queries in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    xd = torch.from_numpy(x).to(device)
    qd = torch.from_numpy(queries).to(device)
    t0 = time.perf_counter()
    _, gt100 = brute_force_topk(qd, xd, 100, "l2")
    gt100 = gt100.cpu()
    gt = gt100[:, :10].contiguous()
    print(f"gist1m ground truth (f32, TF32 off), k=100: "
          f"{time.perf_counter() - t0:.1f} s")
    del xd

    reset_scan_counts(cs)
    sync()
    t0 = time.perf_counter()
    idx = cnns_mod.build_cnns(
        x, CNNSConfig(n_clusters=n_clusters, m=4, kmeans_iters=12,
                      replicate=True),
        slab_dtype=torch.int8, device=device)
    sync()
    build_s = time.perf_counter() - t0
    if idx.qscale == 1.0 or idx.data_c.dtype != torch.int8:
        raise AssertionError("the gist1m index is not SQ8")
    print(f"gist1m SQ8 build: {build_s:.2f} s, C={idx.n_clusters} "
          f"maxc={idx.maxc} index {idx.index_bytes() / 1e9:.4f} GB, qscale "
          f"{idx.qscale:.5f} [{card}]")
    sweep, res10 = {}, {}
    for nprobe in GIST_NPROBE:
        dd, ii = idx.search(qd, k=10, nprobe=nprobe)
        res10[nprobe] = (dd.cpu(), ii.cpu())
        r = recall(res10[nprobe][1], gt)
        med, lo, hi = timed_query(
            lambda: idx.search(qd, k=10, nprobe=nprobe)[1].cpu())
        sweep[nprobe] = r
        print(f"gist1m nprobe={nprobe}: recall@10={r:.4f} median "
              f"{med * 1e3:.3f} ms QPS={nq / med:.1f} (min {lo * 1e3:.3f}, "
              f"max {hi * 1e3:.3f} ms) [{card}]")
    reached = min((p for p, r in sweep.items() if r >= TARGET_RECALL),
                  default=None)
    if reached is None:
        raise AssertionError(f"gist1m: recall@10 >= {TARGET_RECALL} not "
                             f"reached at nprobe <= 16: {sweep}")
    d100, i100 = idx.search(qd, k=100, nprobe=reached)
    i100h = i100.cpu()
    r10, r100 = recall(i100h[:, :10], gt), recall(i100h, gt100)
    med, lo, hi = timed_query(
        lambda: idx.search(qd, k=100, nprobe=reached)[1].cpu())
    print(f"gist1m nprobe={reached} k=100: recall@10={r10:.4f} (k=10 run: "
          f"{sweep[reached]:.4f}) recall@100={r100:.4f} median "
          f"{med * 1e3:.3f} ms QPS={nq / med:.1f} (min {lo * 1e3:.3f}, max "
          f"{hi * 1e3:.3f} ms) [{card}]")
    if tuple(i100h.shape) != (nq, 100) or abs(r10 - sweep[reached]) > 0.002:
        raise AssertionError(f"gist1m k=100: shape {tuple(i100h.shape)}, "
                             f"recall@10 {r10} against {sweep[reached]}")
    counts = scan_counts(cs, "gist1m build + sweep + k=100", device,
                          routed=True)
    if device == "cuda" and set(counts) != {"scan_mma", "scan_general_mma"}:
        raise AssertionError(f"the SQ8 search ran other scan kernels than "
                             f"scan_mma and scan_general_mma: {counts}")
    # as phase 3, on the k=10 result at that nprobe: finite, ascending
    # distances, in-range ids, and the returned distances (SQ8: from the
    # quantized slabs) against exact f32 distances of the returned ids,
    # rtol 1e-2
    ddh, iih = res10[reached]
    pad = check_rows(ddh, iih, n, f"gist1m k=10, nprobe={reached}")
    check_rows(d100.cpu(), i100h, n, f"gist1m k=100, nprobe={reached}")
    real = ~pad[:256]
    ex = ((torch.from_numpy(x)[iih[:256].clamp(min=0)]
           - torch.from_numpy(queries)[:256, None, :]) ** 2).sum(-1)
    rel = float(((ddh[:256] - ex).abs() / ex.abs())[real].max())
    if not torch.allclose(ddh[:256][real], ex[real], rtol=1e-2, atol=1e-1):
        raise AssertionError(f"gist1m: returned distances disagree with "
                             f"exact ones (max rel err {rel})")
    print(f"gist1m output: k=10 distances within {rel:.2e} (relative) of "
          f"exact f32 ones")
    del x, d100, i100, res10

    # the scan inputs of one search at the reached nprobe, then the
    # kernel against its plain version on them at k = 20 and k = 200
    qc, qidx, slabs, bias, _, scale = scan_call(
        lambda: idx.search(qd, k=10, nprobe=reached))
    del idx
    peak = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
            else 0.0)
    print(f"gist1m peak device memory: {peak:.2f} GB; the scan call: "
          f"C={slabs.shape[0]} cap={qidx.shape[1]} maxc={slabs.shape[1]} "
          f"d={slabs.shape[2]}, {int((qidx >= 0).sum())} live rows")
    timed = {}
    for k in (20, 200):
        kern = cs.scan_kernel(qc.dtype, slabs.dtype, slabs.shape[2], k)
        args = (qc, qidx, slabs, bias, k, scale)
        got = cs.grouped_cluster_topk_gq(*args)
        sync()
        want = cs.grouped_cluster_topk_gq_reference(*args)
        full = bias[:, None, :] - scale * cs._dots_reference(
            cs._gather_queries(qc, qidx), slabs)
        err = check_scan(f"gist1m scan call k={k} ({kern})", got, want,
                         full, qidx >= 0, 1e-5, 0.5)
        del want, full
        if device == "cuda":
            k_ms = cuda_ms(lambda: cs.grouped_cluster_topk_gq(*args),
                           reps=10)
            p_ms = cuda_ms(
                lambda: cs.grouped_cluster_topk_gq_reference(*args), reps=3)
            b_k = scan_bound(qc, qidx, slabs, bias, got, qc.dtype,
                             slabs.dtype)
            timed[kern] = (err, k_ms, p_ms, b_k)
            print(f"    kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms "
                  f"(median); bound {b_k[0]:.4f} ms ({b_k[1]}), kernel at "
                  f"{b_k[0] / k_ms:.1%} of it [{card}]")
        del got
    if device == "cuda":
        torch.cuda.empty_cache()
    return counts, timed


WIDE_NPROBE = (1, 2, 3, 4, 6, 8, 12, 16)
WIDE_KERNELS = {"scan_wide", "scan_general_wide"}


def phase_wide(card, n=1_000_000, d=3072, nq=8192, device="cuda",
               n_clusters=976):
    """An index at the published width of OpenAI's text-embedding-3-large
    (d = 3072; Qdrant's dbpedia-entities-openai3-text-embedding-3-large-
    3072-1M), the data synthetic at that shape: 1M unit-norm rows and
    queries ranked by inner product (``make_data(..., "ip")``, seed 0, as
    bench.py's glove configuration), the exact f32 ground truth at k=100.
    A bf16 index (976 clusters, replicated): an nprobe sweep at k=10 with
    10 timed repetitions each, ids fetched to the host, and one search at
    k=100 at the chosen nprobe (the first whose recall@10 reaches 0.95,
    else 16); then the kernel against its plain version on the scan
    inputs of one of its searches at k=10 and k=100. The same index on
    f32 slabs at that nprobe at k=10 and k=100. Every scan is past the
    resident query tile's width (bf16 1920, f32 960): the wide kernels
    only, the query streamed through the ring. Fails unless the f32 index
    reaches recall@10 >= 0.95 there, the bf16 index is within 0.01 of it,
    each k=100 run keeps recall@10 within 0.002 of its k=10 run, and the
    results are finite, ascending and in range with distances near the
    exact ones. One index at a time stays on the card. Smaller
    ``n``/``nq`` and ``device="cpu"`` rehearse it without a card. Returns
    the scan's launches by kernel and, on the card, each kernel's (error,
    ms, plain ms, bound) on that call."""
    from hnsw_nsg_tpu_torch.models import cnns as cnns_mod
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, queries = make_data(n, d, nq, "ip", seed=0)
    print(f"wide data: {n}x{d} ip + {nq} queries in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    qd = torch.from_numpy(queries).to(device)
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to(device)
    _, gt100 = brute_force_topk(qd, xd, 100, "ip")
    gt100 = gt100.cpu()
    gt = gt100[:, :10].contiguous()
    del xd   # the rows' device copy goes before the first index
    if on_card:
        torch.cuda.empty_cache()
    print(f"wide ground truth (f32, TF32 off), k=100: "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = CNNSConfig(n_clusters=n_clusters, m=4, kmeans_iters=12,
                     replicate=True)

    def build(dtype):
        sync()
        t0 = time.perf_counter()
        idx = cnns_mod.build_cnns(x, cfg, metric="ip", slab_dtype=dtype,
                                  device=device)
        sync()
        print(f"wide {dtype} build: {time.perf_counter() - t0:.2f} s, "
              f"C={idx.n_clusters} maxc={idx.maxc} index "
              f"{idx.index_bytes() / 1e9:.4f} GB [{card}]")
        return idx

    def search(idx, label, k, nprobe, reps=10):
        """recall@10 of one search, its host result, and the median batch
        time of ``reps`` more, each fetching its ids to the host."""
        dd, ii = idx.search(qd, k=k, nprobe=nprobe)
        ddh, iih = dd.cpu(), ii.cpu()
        r = recall(iih[:, :10], gt)
        med, lo, hi = timed_query(
            lambda: idx.search(qd, k=k, nprobe=nprobe)[1].cpu(), reps)
        line = (f"wide {label} nprobe={nprobe} k={k}: recall@10={r:.4f}")
        if k == 100:
            line += f" recall@100={recall(iih, gt100):.4f}"
        print(f"{line} median {med * 1e3:.3f} ms QPS={nq / med:.1f} (min "
              f"{lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) [{card}]")
        return r, ddh, iih

    def check_output(ddh, iih, what, rtol, atol):
        """check_rows, and the returned distances of 256 queries against
        exact ones, 1 - <x, q> in float64."""
        pad = check_rows(ddh, iih, n, f"wide {what}")[:256]
        xs = torch.from_numpy(x)[iih[:256].clamp(min=0)].double()
        ex = 1.0 - (xs * torch.from_numpy(queries)[:256, None, :].double()
                    ).sum(-1)
        got = ddh[:256].double()
        err = float((got - ex).abs()[~pad].max())
        if not torch.allclose(got[~pad], ex[~pad], rtol=rtol, atol=atol):
            raise AssertionError(f"wide {what}: distances off the exact "
                                 f"ones by up to {err}")
        print(f"wide {what}: distances within {err:.2e} of exact ones")

    def wide_counts(what):
        counts = scan_counts(cs, what, device, routed=True)
        if on_card and set(counts) != WIDE_KERNELS:
            raise AssertionError(f"wide {what}: scan kernels {counts}, not "
                                 f"{sorted(WIDE_KERNELS)} only")
        return counts

    # the bf16 index: the sweep, k=100 at the chosen nprobe, and the
    # kernels against their plain version on one of its scan calls
    reset_scan_counts(cs)
    idx = build(torch.bfloat16)
    sweep = {}
    for nprobe in WIDE_NPROBE:
        sweep[nprobe] = search(idx, "bf16", 10, nprobe)
    chosen = min((p for p, r in sweep.items() if r[0] >= TARGET_RECALL),
                 default=WIDE_NPROBE[-1])
    r10_bf16, ddh, iih = sweep[chosen]
    check_output(ddh, iih, f"bf16 k=10 nprobe={chosen}", 1e-3, 1e-3)
    r100, ddh, iih = search(idx, "bf16", 100, chosen, reps=3)
    check_output(ddh, iih, f"bf16 k=100 nprobe={chosen}", 1e-3, 1e-3)
    if abs(r100 - r10_bf16) > 0.002:
        raise AssertionError(f"wide bf16 k=100: recall@10 {r100} against "
                             f"{r10_bf16} at k=10")
    bf16_counts = wide_counts("wide bf16 build + sweep + k=100")
    del sweep, ddh, iih
    qc, qidx, slabs, bias, _, scale = scan_call(
        lambda: idx.search(qd, k=10, nprobe=chosen))
    print(f"wide scan call: C={slabs.shape[0]} cap={qidx.shape[1]} "
          f"maxc={slabs.shape[1]} d={slabs.shape[2]}, "
          f"{int((qidx >= 0).sum())} live rows")
    timed = {}
    for k in (10, 100):
        kern = cs.scan_kernel(qc.dtype, slabs.dtype, slabs.shape[2], k)
        args = (qc, qidx, slabs, bias, k, scale)
        got = cs.grouped_cluster_topk_gq(*args)
        sync()
        want = cs.grouped_cluster_topk_gq_reference(*args)
        full = bias[:, None, :] - scale * cs._dots_reference(
            cs._gather_queries(qc, qidx), slabs)
        err = check_scan(f"wide scan call k={k} ({kern})", got, want, full,
                         qidx >= 0, 1e-5, 1e-4)
        del want, full
        if on_card:
            k_ms = cuda_ms(lambda: cs.grouped_cluster_topk_gq(*args),
                           reps=10)
            p_ms = cuda_ms(
                lambda: cs.grouped_cluster_topk_gq_reference(*args), reps=3)
            b_k = scan_bound(qc, qidx, slabs, bias, got, qc.dtype,
                             slabs.dtype)
            timed[kern] = (err, k_ms, p_ms, b_k)
            print(f"    kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms "
                  f"(median); bound {b_k[0]:.4f} ms ({b_k[1]}), kernel at "
                  f"{b_k[0] / k_ms:.1%} of it [{card}]")
        del got
    del qc, qidx, slabs, bias, args, idx
    if on_card:
        torch.cuda.empty_cache()

    # the same index on f32 slabs at the chosen nprobe
    reset_scan_counts(cs)
    idx = build(torch.float32)
    r10_f32, ddh, iih = search(idx, "f32", 10, chosen)
    check_output(ddh, iih, f"f32 k=10 nprobe={chosen}", 1e-5, 1e-5)
    r100, ddh, iih = search(idx, "f32", 100, chosen, reps=3)
    check_output(ddh, iih, f"f32 k=100 nprobe={chosen}", 1e-5, 1e-5)
    f32_counts = wide_counts("wide f32 build + k=10 + k=100")
    del idx, ddh, iih
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    print(f"wide recall@10 at nprobe={chosen}: f32 {r10_f32:.4f}, bf16 "
          f"{r10_bf16:.4f}; peak device memory {peak:.2f} GB; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    if (r10_f32 < TARGET_RECALL or abs(r10_bf16 - r10_f32) > 0.01
            or abs(r100 - r10_f32) > 0.002):
        raise AssertionError(
            f"wide: f32 recall@10 {r10_f32} (k=100: {r100}), bf16 "
            f"{r10_bf16} at nprobe {chosen}")
    del x, queries, qd
    if on_card:
        torch.cuda.empty_cache()
    counts = Counter(bf16_counts) + Counter(f32_counts)
    return dict(counts), timed


def check_rows(dd, ii, n, what):
    """A CNNS search's host result: finite, ascending distances and ids
    in range. A query may get PAD slots (PAD_ID with PAD_DIST): its probe
    pairs past a cluster's list capacity and past the spill budget drop,
    as in the reference, and a small probed cluster fills fewer than k.
    They are counted; every other id must be in range. Returns the PAD
    mask."""
    from hnsw_nsg_tpu_torch.ops.distance import PAD_DIST

    pad = ii < 0
    if not bool(torch.isfinite(dd).all()):
        raise AssertionError(f"{what}: non-finite distances")
    if not bool((dd[:, 1:] >= dd[:, :-1]).all()):
        raise AssertionError(f"{what}: rows are not ascending")
    if not bool((ii < n).all()) or not bool(
            (dd[pad] == float(PAD_DIST)).all()):
        raise AssertionError(f"{what}: ids out of range")
    print(f"{what}: {int(pad.sum())} PAD slots in "
          f"{int(pad.any(1).sum())} of {ii.shape[0]} rows")
    return pad


def scan_call(search):
    """The arguments (qc, qidx, slabs, bias, k, scale) of the first
    grouped-scan call that ``search()`` makes, caught at the call."""
    from hnsw_nsg_tpu_torch.models import cnns as cnns_mod

    caught = []
    scan = cnns_mod.grouped_cluster_topk_gq

    def catch(*args):
        caught.append(args)
        return scan(*args)

    cnns_mod.grouped_cluster_topk_gq = catch
    try:
        search()
    finally:
        cnns_mod.grouped_cluster_topk_gq = scan
    return caught[0]


U8_NPROBE = (1, 2, 3, 4, 6, 8, 12, 16)


def phase_sift10m_u8(card, n=10_000_000, nq=8192, device="cuda"):
    """sift10m_u8 as bench.py runs it (bench.py:72-77, :156; the uint8
    configuration of sift_1b.cpp:243-344): 10M x 128 uint8-valued L2 data
    (``make_data(..., uint8=True)``, seed 0), an index of int8 slabs
    holding the rows shifted by 128 (exact integer arithmetic: the int8 x
    int8 scan kernels), the exact f32 ground truth, an nprobe sweep at
    k=10 (10 timed repetitions each, the path each took: the per-query
    flat scan while probe pairs are fewer than 2 C, the grouped scan
    from there, the reference's rule) and one search at k=100 at the
    first nprobe that reaches recall@10 >= 0.95 on the grouped path.
    The returned distances must equal the exact integer distances of the
    uint8 rows. Then both kernels against their plain version on the scan
    inputs of that search, at k = 10, 20, 100 and 200, torch.equal on
    vals and ids. Smaller ``n``/``nq`` and ``device="cpu"`` rehearse it
    without a card. Returns the scan's launches by kernel and, on the
    card, each k's (error, ms, plain ms, bound)."""
    from hnsw_nsg_tpu_torch.models import cnns as cnns_mod
    from hnsw_nsg_tpu_torch.models.spill import SpillCNNSIndex
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops.distance import PAD_DIST
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    x, queries = make_data(n, 128, nq, "l2", seed=0, uint8=True)
    print(f"sift10m_u8 data: {n}x128 uint8-valued + {nq} queries in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    xd = torch.from_numpy(x).to(device)
    qd = torch.from_numpy(queries).to(device)
    t0 = time.perf_counter()
    # exact: every product and partial sum is an integer below 2**24
    _, gt100 = brute_force_topk(qd, xd, 100, "l2")
    gt100 = gt100.cpu()
    gt = gt100[:, :10].contiguous()
    print(f"sift10m_u8 ground truth (f32, TF32 off), k=100: "
          f"{time.perf_counter() - t0:.1f} s")
    del xd

    sync()
    t0 = time.perf_counter()
    idx = cnns_mod.build_cnns(
        x, CNNSConfig(n_clusters=max(n // 1024, 8), m=4, kmeans_iters=12,
                      replicate=True),
        metric="l2", slab_dtype=torch.int8, device=device)
    sync()
    build_s = time.perf_counter() - t0
    if (idx.qshift != 128.0 or idx.qscale != 1.0
            or idx.data_c.dtype != torch.int8):
        raise AssertionError("the sift10m_u8 index is not int8 x int8 "
                             f"(qshift {idx.qshift}, qscale {idx.qscale})")
    c = idx.data_c.shape[0]
    print(f"sift10m_u8 build: {build_s:.2f} s, C={c} ({idx.n_real} real "
          f"slabs) maxc={idx.maxc} index {idx.index_bytes() / 1e9:.4f} GB "
          f"[{card}]")

    reset_scan_counts(cs)
    sweep, res10 = {}, {}
    for nprobe in U8_NPROBE:
        # the reference's rule (CNNSIndex._search_flat)
        grouped = nq * nprobe >= 2 * c and c % 64 == 0
        before = cs.launches
        dd, ii = idx.search(qd, k=10, nprobe=nprobe)
        if on_card and (cs.launches > before) != grouped:
            raise AssertionError(f"nprobe={nprobe}: the scan launched "
                                 f"{cs.launches - before} times on the "
                                 f"{'grouped' if grouped else 'flat'} path")
        res10[nprobe] = (dd.cpu(), ii.cpu())
        r = recall(res10[nprobe][1], gt)
        med, lo, hi = timed_query(
            lambda: idx.search(qd, k=10, nprobe=nprobe)[1].cpu())
        sweep[nprobe] = (r, grouped)
        print(f"sift10m_u8 nprobe={nprobe} ({'grouped' if grouped else 'flat'}"
              f" path): recall@10={r:.4f} median {med * 1e3:.3f} ms "
              f"QPS={nq / med:.1f} (min {lo * 1e3:.3f}, max {hi * 1e3:.3f} "
              f"ms) [{card}]")
    reached = min((p for p, (r, g) in sweep.items()
                   if r >= TARGET_RECALL and g), default=None)
    if not any(r >= TARGET_RECALL for r, _ in sweep.values()):
        raise AssertionError(f"sift10m_u8: recall@10 >= {TARGET_RECALL} not "
                             f"reached at nprobe <= 16: {sweep}")
    if reached is None:
        raise AssertionError(f"sift10m_u8: no grouped nprobe reaches "
                             f"recall@10 >= {TARGET_RECALL}: {sweep}")
    d100, i100 = idx.search(qd, k=100, nprobe=reached)
    d100, i100 = d100.cpu(), i100.cpu()
    r10, r100 = recall(i100[:, :10], gt), recall(i100, gt100)
    med, lo, hi = timed_query(
        lambda: idx.search(qd, k=100, nprobe=reached)[1].cpu())
    print(f"sift10m_u8 nprobe={reached} k=100: recall@10={r10:.4f} (k=10 "
          f"run: {sweep[reached][0]:.4f}) recall@100={r100:.4f} median "
          f"{med * 1e3:.3f} ms QPS={nq / med:.1f} (min {lo * 1e3:.3f}, max "
          f"{hi * 1e3:.3f} ms) [{card}]")
    if (tuple(i100.shape) != (nq, 100)
            or abs(r10 - sweep[reached][0]) > 0.002):
        raise AssertionError(f"sift10m_u8 k=100: shape {tuple(i100.shape)}, "
                             f"recall@10 {r10} against {sweep[reached][0]}")
    counts = scan_counts(cs, "sift10m_u8 sweep + k=100", device,
                          routed=True)
    if on_card and set(counts) != {"scan_i8", "scan_general_i8"}:
        raise AssertionError(f"the uint8 search ran other scan kernels than "
                             f"scan_i8 and scan_general_i8: {counts}")

    # finite, ascending distances and in-range ids; every distance equals
    # the exact squared L2 distance of the uint8 rows (float64 here; the
    # index's arithmetic is exact integer arithmetic end to end). PAD
    # slots (pairs dropped past the spill budget, as in the reference)
    # must hold PAD_DIST; they are counted.
    def check_rows(dd, ii, what):
        pad = ii < 0
        if not bool(torch.isfinite(dd).all()):
            raise AssertionError(f"sift10m_u8 {what}: non-finite distances")
        if not bool((dd[:, 1:] >= dd[:, :-1]).all()):
            raise AssertionError(f"sift10m_u8 {what}: rows not ascending")
        if not bool((ii < n).all()) or not bool(
                (dd[pad] == float(PAD_DIST)).all()):
            raise AssertionError(f"sift10m_u8 {what}: ids out of range")
        xs = torch.from_numpy(x)
        qs = torch.from_numpy(queries).double()
        for s in range(0, nq, 512):
            ids = ii[s : s + 512]
            ex = ((xs[ids.clamp(min=0)].double() - qs[s : s + 512, None, :])
                  ** 2).sum(-1)
            real = ids >= 0
            if not torch.equal(dd[s : s + 512][real].double(), ex[real]):
                raise AssertionError(f"sift10m_u8 {what}: a distance is "
                                     f"not the exact integer one")
        print(f"sift10m_u8 {what}: every distance exact; {int(pad.sum())} "
              f"PAD slots in {int(pad.any(1).sum())} of {nq} rows")

    check_rows(*res10[reached], f"k=10, nprobe={reached}")
    check_rows(d100, i100, f"k=100, nprobe={reached}")
    res2 = res10[SPILL_CHECK_NPROBE]   # phase 3d's reference
    del x, d100, i100, res10

    # the scan inputs of the k=10 search at that nprobe, then both
    # kernels against their plain version on them
    qc, qidx, slabs, bias, call_k, scale = scan_call(
        lambda: idx.search(qd, k=10, nprobe=reached))
    # phase 3d's spill index takes its host copy of this index; then the
    # resident index goes (its slabs with the scan call's inputs below)
    sync()
    t0 = time.perf_counter()
    sp = SpillCNNSIndex(idx, SPILL_BUDGET)
    spill_copy_s = time.perf_counter() - t0
    index_bytes = idx.index_bytes()
    del idx
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    live = qidx >= 0
    print(f"sift10m_u8 peak device memory: {peak:.2f} GB; the scan call "
          f"(k={call_k}): C={slabs.shape[0]} cap={qidx.shape[1]} "
          f"maxc={slabs.shape[1]} d={slabs.shape[2]}, {int(live.sum())} "
          f"live rows, {int(live.any(1).sum())} slabs with a live row")
    timed = {}
    for k in (10, 20, 100, 200):
        kern = cs.scan_kernel(qc.dtype, slabs.dtype, slabs.shape[2], k)
        args = (qc, qidx, slabs, bias, k, scale)
        got = cs.grouped_cluster_topk_gq(*args)
        sync()
        want = cs.grouped_cluster_topk_gq_reference(*args)
        kv, ki = got[0][live], got[1][live]
        rv, ri = want[0][live], want[1][live]
        if k <= cs.MAX_K:   # the heap kernels give slot 0 past the finite
            ri = torch.where(torch.isinf(rv), 0, ri)
        if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
            raise AssertionError(f"sift10m_u8 scan call k={k} ({kern}): "
                                 f"not the plain version's vals and ids")
        del want, kv, ki, rv, ri
        if on_card:
            k_ms = cuda_ms(lambda: cs.grouped_cluster_topk_gq(*args),
                           reps=10)
            p_ms = cuda_ms(
                lambda: cs.grouped_cluster_topk_gq_reference(*args), reps=3)
            b_k = scan_bound(qc, qidx, slabs, bias, got, qc.dtype,
                             slabs.dtype)
            timed[k] = (0.0, k_ms, p_ms, b_k)
            print(f"  sift10m_u8 scan call k={k} ({kern}): equal to the "
                  f"plain version; kernel {k_ms:.4f} ms, plain PyTorch "
                  f"{p_ms:.4f} ms (median); bound {b_k[0]:.4f} ms "
                  f"({b_k[1]}), kernel at {b_k[0] / k_ms:.1%} of it [{card}]")
        del got
    del qc, qidx, slabs, bias, live
    if on_card:
        torch.cuda.empty_cache()
    print(f"sift10m_u8 phase: {time.perf_counter() - t_phase:.1f} s")
    spill_in = dict(sp=sp, qd=qd, gt=gt, resident=res2,
                    copy_s=spill_copy_s, index_bytes=index_bytes)
    return counts, timed, spill_in


# phase 3d: the host-spill index over phase 3c's index (bench.py:339-412)
SPILL_BUDGET = int(1.0e9)
SPILL_NPROBE = (2, 4, 8)
SPILL_CHECK_NPROBE = 2   # phase 3c took the per-query flat path there


def tie_mismatches(dd, ii, ref_d, ref_i, boundary=False):
    """Positions where ids differ although the distances are equal, when
    every such position lies in a run of equal distances of its row (the
    two searches merged equal candidates in another order; with
    ``boundary`` also a run ending at the row's last column, whose ties
    past k either search may have kept); raises at any other difference.
    Returns the count of differing ids."""
    if not torch.equal(dd, ref_d):
        raise AssertionError("the distances are not the reference's")
    diff = ii != ref_i
    tied = (dd == dd[:, -1:]) if boundary else torch.zeros_like(diff)
    tied[:, 1:] |= dd[:, 1:] == dd[:, :-1]
    tied[:, :-1] |= dd[:, :-1] == dd[:, 1:]
    if bool((diff & ~tied).any()):
        raise AssertionError(f"{int((diff & ~tied).sum())} ids differ at "
                             f"distances that are not tied")
    return int(diff.sum())


def phase_spill(card, sp, qd, gt, resident, copy_s, index_bytes,
                device="cuda"):
    """Phase 3d, the host-spill CNNS index (``SpillCNNSIndex``) under a
    device budget of 1.0 GB below the size of phase 3c's index, which it
    wraps; the resident index is gone. An nprobe sweep over 2, 4, 8 at
    k=10 (bench.py:386), the median of 3 timed repetitions each: rounds,
    bytes moved, the largest group (which must fit the budget), the peak
    device memory of the search and the host-to-device rate of a group's
    copy. The distances at nprobe 2 must equal phase 3c's resident search
    (the per-query flat path there) exactly, the ids too except among
    equal distances (counted). Smaller inputs and ``device="cpu"``
    rehearse it without a card."""
    from hnsw_nsg_tpu_torch.models.spill import SpillStats
    from hnsw_nsg_tpu_torch.ops import recall

    on_card = device == "cuda"
    nq = qd.shape[0]
    print(f"spill: index {index_bytes / 1e9:.4f} GB, budget "
          f"{SPILL_BUDGET / 1e9:.2f} GB, {sp.slab_bytes} B a slab, "
          f"group_size={sp.group_size} slabs "
          f"({sp.group_size * sp.slab_bytes / 1e9:.4f} GB a group), host "
          f"copy {copy_s:.2f} s (pinned: {sp.data_h.is_pinned()}); device "
          f"memory after the resident index went: "
          f"{torch.cuda.memory_allocated() / 1e9 if on_card else 0.0:.2f} "
          f"GB [{card}]")
    if sp.group_size * sp.slab_bytes > SPILL_BUDGET:
        raise AssertionError("a spill group passes the budget")
    out = {}
    for nprobe in SPILL_NPROBE:
        sp.stats = SpillStats()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dd, ii = sp.search(qd, k=10, nprobe=nprobe)
        dd, ii = dd.cpu(), ii.cpu()
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        st = dataclasses.replace(sp.stats)   # this one search's counts
        r = recall(ii, gt)
        med, lo, hi = timed_query(
            lambda: sp.search(qd, k=10, nprobe=nprobe)[1].cpu(), reps=3)
        print(f"spill nprobe={nprobe}: recall@10={r:.4f} median "
              f"{med * 1e3:.3f} ms QPS={nq / med:.1f} (min {lo * 1e3:.3f}, "
              f"max {hi * 1e3:.3f} ms); a search: {st.transfer_rounds} "
              f"rounds, {st.bytes_transferred / 1e9:.4f} GB moved, largest "
              f"group {st.peak_group_bytes / 1e9:.4f} GB, peak device memory "
              f"{peak:.2f} GB [{card}]")
        if st.peak_group_bytes > SPILL_BUDGET or st.transfer_rounds < 1:
            raise AssertionError(f"spill nprobe={nprobe}: {st}")
        if not bool(torch.isfinite(dd).all()) or not bool(
                (dd[:, 1:] >= dd[:, :-1]).all()):
            raise AssertionError(f"spill nprobe={nprobe}: bad distances")
        out[nprobe] = dict(recall=r, ms=med * 1e3, rounds=st.transfer_rounds,
                           bytes=st.bytes_transferred,
                           peak_group=st.peak_group_bytes, peak_mem=peak)
        if nprobe == SPILL_CHECK_NPROBE:
            n_diff = tie_mismatches(dd, ii, *resident)
            print(f"spill nprobe={nprobe}: every distance equal to phase "
                  f"3c's resident search; {n_diff} of {ii.numel()} ids "
                  f"differ, all among equal distances")
    # one group's copy: the host gather into the pinned staging rows and
    # the copy to the card (as a search makes it), then the copy alone
    grp = np.arange(min(sp.group_size, sp.data_h.shape[0]))
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    *_, nbytes = sp._load_group(grp)
    if on_card:
        torch.cuda.synchronize()
    both_s = time.perf_counter() - t0
    rows = -(-len(grp) // sp.group_pad) * sp.group_pad
    copy_ms = (cuda_ms(lambda: [st[:rows].to(device, non_blocking=True)
                                for st in sp._stage], reps=3)
               if on_card else float("nan"))
    print(f"spill group copy ({nbytes / 1e9:.4f} GB): host gather + copy "
          f"{both_s * 1e3:.1f} ms ({nbytes / both_s / 1e9:.2f} GB/s), "
          f"host-to-device copy alone {copy_ms:.2f} ms "
          f"({nbytes / copy_ms / 1e6:.2f} GB/s) [{card}]")
    return out


def route_tally():
    """The flat router's launches (``ops/route.py``) since the last call,
    by kernel, added to ROUTE_LAUNCHES and set to 0 there; fails unless
    they add up."""
    from hnsw_nsg_tpu_torch.ops import route

    got = dict(route.launches_by_kernel)
    if sum(got.values()) != route.launches:
        raise AssertionError(f"route launches by kernel: {got}, all "
                             f"{route.launches}")
    ROUTE_LAUNCHES.update(got)
    route.launches = 0
    route.launches_by_kernel.clear()
    return got


def reset_scan_counts(cs):
    route_tally()
    cs.launches = 0
    cs.launches_by_kernel.clear()


def scan_counts(cs, what, device="cuda", routed=False):
    """The scan's launches since reset_scan_counts, by kernel; fails
    unless they add up (and, on the card, unless there are some). Prints
    the flat router's launches since the last count, and on the card
    fails unless a ``routed`` path launched its kernel."""
    counts = dict(cs.launches_by_kernel)
    print(f"scan kernel launches, {what}: {cs.launches}, by kernel {counts}")
    if sum(counts.values()) != cs.launches or (
            device == "cuda" and not cs.launches):
        raise AssertionError(f"scan launches by kernel: {counts}, all "
                             f"{cs.launches}")
    routes = route_tally()
    print(f"route kernel launches, {what}: {routes}")
    if routed and device == "cuda" and not routes.get("route_topk"):
        raise AssertionError(f"{what}: the flat router launched no kernel")
    return counts


def merge_state(seed, q, l, c, expand, n_ids=20000, fill=0.7):
    """Kernel-A inputs on the card, built like
    tests/test_merge_select.py:_random_state (numpy, seeded): a sorted,
    partly expanded retset with a PAD tail, and candidates with repeats
    (vs the retset and internal), PADs and forced ties."""
    from hnsw_nsg_tpu_torch.ops.topk import init_retset

    rng = np.random.default_rng(seed)
    dev = "cuda"
    ni = int(rng.integers(4, int(l * fill) + 4))
    ids = torch.from_numpy(rng.choice(n_ids, (q, ni)).astype(np.int32))
    d = torch.from_numpy(rng.random((q, ni)).astype(np.float32))
    # init_retset compares [rows, ni, l]: ~2 GB of rows at a time
    rows = max(1, (2 << 30) // (ni * l))
    parts = [init_retset(d[s:s + rows].to(dev), ids[s:s + rows].to(dev), l)
             for s in range(0, q, rows)]
    r_d, r_i, r_e = (torch.cat(t) for t in zip(*parts))
    r_e = r_e | torch.from_numpy(rng.random((q, l)) < 0.5).to(dev)
    c_i = rng.choice(n_ids, (q, c)).astype(np.int32)
    c_i[rng.random((q, c)) < 0.15] = -1
    # repeats of retset ids and of earlier candidates
    r_np = r_i.cpu().numpy()
    c_i[:, 1] = r_np[:, 0]
    c_i[:, 2] = c_i[:, 3]
    c_d = rng.random((q, c)).astype(np.float32)
    c_d[:, : c // 4] = np.float32(0.5)
    return [r_d, r_i, r_e, torch.from_numpy(c_d).to(dev),
            torch.from_numpy(c_i).to(dev)]


# phase_merge_select's states, each made by merge_state(100 + its index):
# (name, Q, L, C, expand, mutation, timed)
MERGE_CASES = [
    ("search shape", 8192, 100, 50, 1, None, True),
    ("collect pool", 4096, 500, 50, 1, None, True),
    ("build retset", 4096, 40, 50, 1, None, True),
    ("wide expand", 8192, 64, 120, 4, None, False),
    ("ragged Q", 8195, 100, 50, 2, None, False),
    ("all-PAD candidates", 1000, 100, 50, 1, "pad", False),
    ("converged retset", 1000, 100, 50, 4, "converged", False),
    ("hnsw insert", 4096, 200, 128, 4, None, True),
    ("hnsw insert upper", 4096, 200, 64, 4, None, True),
    ("hnsw search ef=96", 8192, 96, 32, 1, None, True),
    ("warp kernel L=512", 8192, 512, 32, 1, None, True),
    ("warp kernel L=513", 8192, 513, 32, 1, None, True),
    ("warp kernel L=1024", 8192, 1024, 32, 1, None, True),
    ("general L=1025", 8192, 1025, 32, 1, None, True),
    ("general L=2048", 8192, 2048, 32, 1, None, True),
    ("general L=4096", 8192, 4096, 32, 1, None, True),
    # past shared memory: the general kernel's arrays in global scratch
    ("general scratch L=30000", 256, 30000, 32, 1, None, True),
]


def phase_merge_select():
    """Kernel A against its plain version: torch.equal on all five
    outputs. Returns (max |dists error| (0 when equal) by kernel
    (``ms_kernel``), and kernel ms, plain ms and bound by timed case)."""
    from hnsw_nsg_tpu_torch.ops import merge_select as ms

    from hnsw_nsg_tpu_torch.utils.synth import (MERGE_STATE_KINDS,
                                                 adversarial_merge_state)

    names = ("dists", "ids", "expanded", "sel_ids", "sel_valid")
    # states a hash table can get wrong: colliding ids, id 0 and ids near
    # 2**31 - 1, candidates all one retset id or one new id, a PAD retset
    n_adv = 0
    for kind in MERGE_STATE_KINDS:
        for l, c, expand in ((40, 50, 1), (100, 50, 4), (500, 50, 1),
                             (500, 120, 4), (102, 50, 2)):
            state = [torch.from_numpy(a).cuda() for a in
                     adversarial_merge_state(kind, l + c + expand, 515, l, c)]
            got = ms.fused_merge_select(*state, expand)
            torch.cuda.synchronize()
            want = ms.merge_select_reference(*state, expand)
            for nm, a, b in zip(names, got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"merge_select adversarial {kind} L={l} C={c} "
                        f"expand={expand}: {nm} differs from the plain version")
            n_adv += 1
    print(f"  merge_select adversarial states ({', '.join(MERGE_STATE_KINDS)}"
          f"): {n_adv} cases, all five outputs equal")
    print("  merge_select resident queries (warps) per SM: "
          + ", ".join(f"L={l} C={c}: {ms.occupancy(l, c)}"
                      for l, c in ((100, 50), (500, 50), (40, 50),
                                   (1024, 32), (1024, 128))))

    # the warp kernel at 32 slots a lane (513 <= L <= 1024) and the
    # general kernel (a block a query; L > 1024 or C > 1024) on the same
    # adversarial kinds and on random states
    wide = ((513, 50, 1), (800, 128, 4), (1024, 32, 1), (1024, 128, 4))
    general = ((1025, 50, 1), (4096, 128, 1), (200, 1025, 4))
    g0 = ms.general_launches
    for l, c, expand in wide + general:
        states = [(kind, [torch.from_numpy(a).cuda() for a in
                          adversarial_merge_state(kind, l + c, 48, l, c)])
                  for kind in MERGE_STATE_KINDS]
        states.append(("random", merge_state(l + c, 256, l, c, expand,
                                             n_ids=4 * l)))
        for kind, state in states:
            got = ms.fused_merge_select(*state, expand)
            torch.cuda.synchronize()
            want = ms.merge_select_reference(*state, expand)
            for nm, a, b in zip(names, got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"merge_select general kernel {kind} L={l} C={c} "
                        f"expand={expand}: {nm} differs from the plain "
                        f"version")
        del states
    n_gen = ms.general_launches - g0
    if n_gen != len(general) * (len(MERGE_STATE_KINDS) + 1):
        raise AssertionError("the general kernel ran a shape of the warp "
                             "kernel, or missed one of its own")
    print(f"  merge_select warp kernel at 32 slots a lane, (L, C) = "
          f"{[w[:2] for w in wide]}, and general kernel at "
          f"{[g[:2] for g in general]}: "
          f"{(len(wide) + len(general)) * (len(MERGE_STATE_KINDS) + 1)} "
          f"cases (adversarial and random states), all five outputs equal")
    torch.cuda.empty_cache()

    times = {}
    max_err = {"warp": 0.0, "warp, 32 slots": 0.0, "general": 0.0}
    for i, (name, q, l, c, expand, mut, timed) in enumerate(MERGE_CASES):
        state = merge_state(100 + i, q, l, c, expand)
        if mut == "pad":
            state[3].fill_(3.4e37)
            state[4].fill_(-1)
        elif mut == "converged":
            state[2].fill_(True)
            state[3].fill_(3.4e37)
            state[4].fill_(-1)
        g0 = ms.general_launches
        got = ms.fused_merge_select(*state, expand)
        torch.cuda.synchronize()
        if ms.general_launches - g0 != (l > ms.MAX_L or c > ms.MAX_C):
            raise AssertionError(f"merge_select {name}: the wrong kernel ran")
        want = ms.merge_select_reference(*state, expand)
        for nm, a, b in zip(names, got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"merge_select {name}: {nm} differs "
                                     f"from the plain version")
        kern = ms_kernel(ms, l, c)
        max_err[kern] = max(max_err[kern],
                            float((got[0] - want[0]).abs().max()))
        if mut == "converged" and bool(got[4].any()):
            raise AssertionError("a converged retset selected a frontier")
        line = f"  merge_select {name} (Q={q} L={l} C={c} expand={expand}): "
        line += "all five outputs equal"
        if timed:
            k_ms = cuda_ms(lambda: ms.fused_merge_select(*state, expand),
                           reps=50, warmup=5)
            p_ms = cuda_ms(lambda: ms.merge_select_reference(*state, expand),
                           reps=5)
            # a merge moves data and compares: the bytes bound it
            b_ms, b_by = bound(nbytes(*state, *got))
            times[name] = (k_ms, p_ms, b_ms, b_by)
            line += (f"; kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms "
                     f"(median), bound {b_ms:.4f} ms ({b_by}), kernel at "
                     f"{b_ms / k_ms:.1%} of it")
        print(line)
        del state, got, want
        torch.cuda.empty_cache()
    return max_err, times


def join_case(seed, c, maxc, mm, d, dtype, metric, sparse_last=None):
    """Kernel-B inputs made on the card from a seed: member rows, stacked
    slabs with ragged valid prefixes, bias = norms (l2) or 1 (ip), +inf
    on pad slots; ``sparse_last`` leaves the last cluster that many
    finite slots."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qv = torch.randn((c, maxc, d), generator=gen, device=dev).to(dtype)
    st = torch.randn((c, mm, d), generator=gen, device=dev).to(dtype)
    sizes = torch.randint(mm // 2, mm + 1, (c,), generator=gen, device=dev)
    if sparse_last is not None:
        sizes[-1] = sparse_last
    valid = torch.arange(mm, device=dev)[None, :] < sizes[:, None]
    if metric == "l2":
        base, scale = (st.float() ** 2).sum(-1), 2.0
    else:
        base, scale = torch.ones((c, mm), device=dev), 1.0
    bias = torch.where(valid, base, float("inf")).contiguous()
    return qv.contiguous(), st.contiguous(), bias, scale


def check_join(name, qv, st, bias, k, scale, rtol, atol, time_it=False):
    """Kernel B vs its plain version: vals allclose where finite, +inf in
    the same places, ids equal where finite except near-ties, whose slot
    must score the plain value within the tolerance. Returns (max |vals
    error|, kernel ms, plain ms)."""
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs

    kv, ki = cs.cluster_join_topk(qv, st, bias, k, scale)
    torch.cuda.synchronize()
    rv, ri = cs.cluster_join_topk_reference(qv, st, bias, k, scale)
    fin = torch.isfinite(rv)
    if not torch.equal(torch.isfinite(kv), fin):
        raise AssertionError(f"cluster_join {name}: +inf pattern differs")
    err = (kv[fin] - rv[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if not torch.allclose(kv[fin], rv[fin], rtol=rtol, atol=atol):
        raise AssertionError(f"cluster_join {name}: vals differ, max abs "
                             f"err {max_err}")
    mism = (ki != ri) & fin
    n_mism = int(mism.sum())
    if n_mism:
        c_, r_, j_ = mism.nonzero(as_tuple=True)
        slot = ki[c_, r_, j_].long()
        own = bias[c_, slot] - scale * (qv[c_, r_].double()
                                        * st[c_, slot].double()).sum(-1)
        if not torch.allclose(own.float(), rv[c_, r_, j_], rtol=rtol,
                              atol=atol):
            raise AssertionError(f"cluster_join {name}: a returned slot "
                                 f"does not score its value")
    line = (f"  cluster_join {name}: max_abs_err={max_err:.3g} "
            f"(rtol={rtol}, atol={atol}) id mismatches (near-ties) "
            f"{n_mism}/{int(fin.sum())}")
    k_ms = p_ms = None
    if time_it:
        k_ms = cuda_ms(lambda: cs.cluster_join_topk(qv, st, bias, k, scale),
                       reps=3, warmup=1)
        p_ms = cuda_ms(lambda: cs.cluster_join_topk_reference(
            qv, st, bias, k, scale), reps=1, warmup=0)
        line += (f"; kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms "
                 f"(median)")
    print(line)
    return max_err, k_ms, p_ms


def phase_join_small():
    """Kernel B vs plain at small shapes. f32 (the CUDA-core kernel): l2
    with group 1, an inf tail, k = 65 and 102, k = 107 and 108 at d = 37
    and 140 and 141 at d = 200 (its heaps in shared memory, then in
    global scratch, beside a resident or a streamed query), group 8 with
    a sparse last cluster (slices of all +inf bias skipped). bf16 (the
    tensor-core
    kernel): ip group 4; l2 group 8 with g = 200, not a multiple of the
    bucket tile; d = 960 (the query streams); d = 100 (padded to 104);
    maxc = 200, not a multiple of the 128-row tile; k = 64; a sparse last
    cluster whose finite buckets are fewer than k; and k > 64: k = 65,
    102 with a sparse last cluster (128 rows a block), 202 (64 rows), 450
    (64 rows, the heaps in global scratch). f32 sums of d exact products
    in another order: atol covers a few ulps of |bias| (~2d). Returns the
    worst |vals error| by kernels-line entry (``join_entry``)."""
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs

    f32, bf = torch.float32, torch.bfloat16
    worst = {128: 0.0, 64: 0.0, "f32": 0.0}   # by join_entry
    before = dict(cs.join_launches_by_kernel)
    n_cases = {f32: 0, bf: 0}
    # (name, join_case args (seed, c, maxc, mm, d, dtype, metric[,
    # sparse_last]), k, (rtol, atol))
    for name, args, k, tol in [
        ("f32 l2 group 1", (1, 16, 100, 128, 64, f32, "l2"), 10,
         (1e-5, 1e-3)),
        ("f32 l2 inf tail", (3, 8, 64, 512, 32, f32, "l2", 3), 10,
         (1e-5, 1e-3)),
        ("bf16 ip group 4", (2, 32, 256, 2048, 128, bf, "ip"), 20,
         (1e-5, 1e-4)),
        ("bf16 l2 group 8 g=200", (5, 3, 150, 1600, 128, bf, "l2"), 8,
         (1e-5, 1e-3)),
        ("bf16 l2 d=960", (6, 2, 130, 1024, 960, bf, "l2"), 10,
         (1e-5, 5e-3)),
        ("bf16 l2 d=100", (7, 3, 96, 512, 100, bf, "l2"), 10,
         (1e-5, 1e-3)),
        ("bf16 l2 maxc=200", (8, 3, 200, 2048, 64, bf, "l2"), 16,
         (1e-5, 1e-3)),
        ("bf16 l2 k=64", (9, 2, 128, 8192, 128, bf, "l2"), 64,
         (1e-5, 1e-3)),
        ("bf16 l2 sparse last cluster", (10, 3, 64, 512, 128, bf, "l2", 5),
         20, (1e-5, 1e-3)),
        # k > 64: the tensor-core kernel at 128 rows a block up to
        # k = 110, 64 above, the heaps in global scratch past k = 285; a
        # sparse last cluster with fewer finite buckets than k
        ("bf16 l2 k=65", (11, 4, 200, 4096, 128, bf, "l2"), 65,
         (1e-5, 1e-3)),
        ("bf16 l2 k=102 sparse last", (12, 3, 150, 8192, 128, bf, "l2", 40),
         102, (1e-5, 1e-3)),
        ("bf16 l2 k=202", (15, 2, 100, 16384, 128, bf, "l2", 60), 202,
         (1e-5, 1e-3)),
        ("bf16 l2 k=450 heaps in scratch", (16, 2, 70, 8192, 64, bf, "l2",
                                            30), 450, (1e-5, 1e-3)),
        ("f32 ip k=65", (13, 2, 100, 2048, 64, f32, "ip"), 65,
         (1e-5, 1e-4)),
        ("f32 l2 k=102", (14, 2, 100, 4096, 64, f32, "l2"), 102,
         (1e-5, 1e-3)),
        # the f32 kernel's heaps: shared memory up to k = 107 beside the
        # resident query (d <= 128), 140 when it streams, global scratch
        # above; d = 37 and 200, not multiples of its 16-wide d chunk
        ("f32 l2 k=107", (17, 3, 130, 2700, 37, f32, "l2"), 107,
         (1e-5, 1e-3)),
        ("f32 l2 k=108 heaps in scratch", (18, 3, 130, 2725, 37, f32, "l2"),
         108, (1e-5, 1e-3)),
        ("f32 l2 d=200 k=140 query streamed", (20, 2, 130, 3500, 200, f32,
                                               "l2"), 140, (1e-5, 1e-3)),
        ("f32 l2 d=200 k=141 heaps in scratch", (21, 2, 130, 3525, 200, f32,
                                                 "l2"), 141, (1e-5, 1e-3)),
        # group 8 with a sparse last cluster: (tile, e) slices of all +inf
        # bias, which the f32 kernel skips, and (+inf, b) tails
        ("f32 l2 group 8 sparse last", (19, 3, 200, 16896, 64, f32, "l2",
                                        40), 52, (1e-5, 1e-3)),
    ]:
        qv, st, bias, scale = join_case(*args)
        err, _, _ = check_join(name, qv, st, bias, k, scale, *tol)
        entry = join_entry(cs, args[4], k, qv.dtype)
        worst[entry] = max(worst[entry], err)
        n_cases[qv.dtype] += 1
    for dt, n in n_cases.items():
        kern = cs.JOIN_KERNELS[dt]
        if cs.join_launches_by_kernel[kern] - before.get(kern, 0) != n:
            raise AssertionError(f"the {dt} cases did not all run {kern}")
    return worst


def join_entry(cs, d, k, dtype):
    """The kernels-line entry that a join call reports under: the rows a
    block of the bf16 tensor-core kernel (128 or 64), or "f32"."""
    if dtype == torch.bfloat16:
        return cs.join_block_rows(d, k, dtype)
    return "f32"


def phase_join_build(card, n_slabs, maxc=2112, probes=8, d=128, k=52,
                     dtype=torch.bfloat16):
    """Kernel B vs plain at the build shape of phase 6 (the plain version
    runs chunked over clusters: the whole f32 block would be ~140 GB), at
    the hybrid's join k = 52 (bf16: the tensor-core kernel at 128 rows a
    block), k = 102, the k of phase 6's kNN graph at k = 100 (128 rows),
    or k = 202, that of its graph at k = 200 (64 rows); f32 runs the
    CUDA-core kernel. One launch a call.
    Returns (max |vals error|, kernel ms, plain ms, (bound ms, bound by))."""
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs

    qv, st, bias, scale = join_case(4, n_slabs, maxc, probes * maxc, d,
                                    dtype, "l2")
    rows = cs.join_block_rows(d, k, dtype)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    name = (f"build shape (C={n_slabs} maxc={maxc} M={probes} d={d} {tag} "
            f"k={k}; {cs.JOIN_KERNELS[dtype]}, {rows} rows a block)")
    err, k_ms, p_ms = check_join(name, qv, st, bias, k, scale, 1e-5, 1e-3,
                                 time_it=True)
    # a slot with +inf bias scores +inf whatever its product: only the
    # finite slots need their stack rows read and their products made
    # (every member row of join_case is live)
    finite = int(torch.isfinite(bias).sum())
    out_bytes = n_slabs * maxc * k * 8          # vals f32 + idx int32
    flops = 2.0 * maxc * d * finite
    b = bound(nbytes(qv, bias) + finite * d * st.element_size() + out_bytes,
              flops, PEAK_OPS[(dtype, dtype)])
    if dtype == torch.float32:
        # join_f32_kernel makes the products of 128-row x 128-bucket
        # tiles, skipping the (bucket tile, e) slices of all +inf bias
        group = cs.join_group(probes * maxc, k)
        g = probes * maxc // group
        tiles = -(-g // 128)
        live = torch.nn.functional.pad(
            bias.view(n_slabs, group, g) != float("inf"),
            (0, tiles * 128 - g)).view(n_slabs, group, tiles, 128).any(-1)
        done = 2.0 * int(live.sum()) * 128 * (-(-maxc // 128) * 128) * d
        what = "makes the products of its live 128 x 128 slices,"
    else:
        done = 2.0 * n_slabs * maxc * probes * maxc * d
        what = "computes all"
    print(f"  cluster_join at the build shape: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}: {flops / 1e12:.3f} "
          f"TFLOP needed, {finite}/{bias.numel()} slots finite), kernel at "
          f"{b[0] / k_ms:.2%} of the bound; it {what} "
          f"{done / 1e12:.3f} TFLOP, {done / k_ms / 1e9:.1f} TFLOP/s [{card}]")
    del qv, st, bias
    torch.cuda.empty_cache()
    return err, k_ms, p_ms, b


def exact_knn_recall(x_dev, adj, sample: int = 10_000, seed: int = 0,
                     rows=None):
    """Recall of the kNN graph's rows (``rows``, else a random sample of
    ``sample`` nodes) against their exact neighbours among the rows of
    ``x_dev`` (f32 brute force, self removed). adj: [N, k], a tensor or
    numpy."""
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall

    adj = torch.as_tensor(adj)
    n, k = adj.shape
    if rows is None:
        rows = np.random.default_rng(seed).choice(n, min(sample, n),
                                                  replace=False)
    rows = torch.as_tensor(rows).to(x_dev.device)
    _, ids = brute_force_topk(x_dev[rows], x_dev, k + 1)
    exact = torch.stack([r[r != s][:k] for r, s in zip(ids.cpu(),
                                                        rows.cpu())])
    return recall(adj[rows.to(adj.device)].cpu(), exact)


def bfs_reaches_all(adj_np, ep):
    visited = np.zeros(len(adj_np), bool)
    frontier = np.array([ep])
    visited[ep] = True
    while len(frontier):
        nxt = adj_np[frontier].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~visited[nxt]]
        visited[nxt] = True
        frontier = nxt
    return bool(visited.all()), int(visited.sum())


def sampled_entries(qd, xd, sample: int = 4096, seed: int = 0):
    """Per query, the nearest of ``sample`` random points: an entry that
    does not depend on navigating from the medoid."""
    from hnsw_nsg_tpu_torch.ops import brute_force_topk

    gen = torch.Generator(device=xd.device)
    gen.manual_seed(seed)
    pick = torch.randperm(xd.shape[0], generator=gen, device=xd.device)
    pick = pick[:sample]
    _, near = brute_force_topk(qd, xd[pick], 1)
    return pick[near[:, 0]].to(torch.int32)


def ms_kernel(ms, l, c):
    """The merge+select kernel that (L, C) runs: the warp kernel (up to 16
    retset slots a lane, L <= 512), its 32-slot build (512 < L <= 1024)
    or the general kernel."""
    if l > ms.MAX_L or c > ms.MAX_C:
        return "general"
    return "warp, 32 slots" if l > 512 else "warp"


def launch_split(ms, what, tally):
    """Print merge+select's launches since the counts were last cleared,
    by (L, C, expand) and by kernel, and add them to ``tally`` by kernel."""
    split = {}
    for (q_, l_, c_, e_), cnt in ms.launches_by_shape.items():
        ent = split.setdefault((l_, c_, e_), [0, q_, q_])
        ent[0] += cnt
        ent[1], ent[2] = min(ent[1], q_), max(ent[2], q_)
    for (l_, c_, e_), (cnt, q_lo, q_hi) in sorted(split.items()):
        kern = ms_kernel(ms, l_, c_)
        tally[kern] = tally.get(kern, 0) + cnt
        print(f"  merge_select launches, {what}, L={l_} C={c_} expand={e_}: "
              f"{cnt} (Q {q_lo}..{q_hi}; {kern} kernel)")
    if sum(v[0] for v in split.values()) != ms.launches:
        raise AssertionError("the launch split does not add up")
    share = ms.general_launches / max(ms.launches, 1)
    print(f"  merge_select launches, {what}: {ms.launches}, of them "
          f"{ms.general_launches} ({share:.2%}) by the general kernel")


def reset_counts(cs, ms):
    reset_scan_counts(cs)
    cs.join_launches = 0
    cs.join_launches_by_kernel.clear()
    ms.launches = ms.general_launches = 0
    ms.launches_by_shape.clear()


def profile_search(label, fn, wall_ms, row_bytes, card):
    """One search under torch.profiler: device time (the kernels' self
    time), its lockstep hops (merge+select launches), device ms a hop, the
    share of the gather kernels (names with "index" or "gather") and of
    the products (cuBLAS "gemv"/"gemm"), the idle share against
    ``wall_ms`` (the median of the unprofiled runs), and the bytes
    gathered a hop: rows gathered (the Q of every launch, dead rows
    included) times ``row_bytes``, over the hops. On the host side: the
    self CPU time of the host events (aten ops and CUDA runtime calls,
    inflated by the profiler's own cost) a hop, apart from the time spent
    waiting in synchronize calls; the aten calls and kernel launches a
    hop; and the events that take the most host time. Returns the dict it
    prints."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hnsw_nsg_tpu_torch.ops import merge_select as ms

    torch.cuda.synchronize()
    m0 = ms.launches
    shapes0 = dict(ms.launches_by_shape)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hops = ms.launches - m0
    rows = sum(q_ * (cnt - shapes0.get((q_, l_, c_, e_), 0)) * e_
               for (q_, l_, c_, e_), cnt in ms.launches_by_shape.items())
    total = gather = prod = host = wait = 0.0
    top, host_top = [], []
    aten_calls = launch_calls = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            cpu = ev.self_cpu_time_total / 1e3
            if "Synchronize" in ev.key:
                wait += cpu
                continue
            host += cpu
            aten_calls += ev.count if ev.key.startswith("aten::") else 0
            launch_calls += ev.count if ev.key == "cudaLaunchKernel" else 0
            host_top.append((cpu, ev.count, ev.key[:40]))
            continue
        dev = ev.self_device_time_total / 1e3
        total += dev
        key = ev.key.lower()
        if "index" in key or "gather" in key:
            gather += dev
        elif "gemv" in key or "gemm" in key:
            prod += dev
        top.append((dev, ev.count, ev.key[:70]))
    top.sort(reverse=True)
    host_top.sort(reverse=True)
    per_hop = max(hops, 1)
    out = dict(search=label, device_ms=total, wall_ms=wall_ms,
               idle_share=1.0 - total / wall_ms, lockstep_hops=hops,
               device_ms_per_hop=total / per_hop,
               gather_share=gather / max(total, 1e-9),
               product_share=prod / max(total, 1e-9),
               bytes_gathered_per_hop=rows * row_bytes / per_hop,
               top=[dict(ms=t, calls=c, kernel=k) for t, c, k in top[:6]],
               host_ms_per_hop=host / per_hop, host_wait_ms=wait,
               aten_calls_per_hop=aten_calls / per_hop,
               launches_per_hop=launch_calls / per_hop,
               host_top=[dict(ms=t, calls=c, event=k)
                         for t, c, k in host_top[:8]],
               card=card)
    print("profile " + json.dumps(out))
    return out


def timed_query(fn, reps=10):
    """fn() returns host arrays: median wall seconds of ``reps`` calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), max(ts)


def check_answers(labels, dists, x, queries, n, nq, k, rtol, atol):
    """Shape, finiteness, order, in-range labels, and the returned
    distances against exact f32 distances of the returned points."""
    if labels.shape != (nq, k) or dists.shape != (nq, k):
        raise AssertionError(f"bad result shapes {labels.shape} {dists.shape}")
    if not np.isfinite(dists).all():
        raise AssertionError("non-finite distances in the result")
    if not (dists[:, 1:] >= dists[:, :-1]).all():
        raise AssertionError("result rows are not ascending")
    if not ((labels >= 0) & (labels < n)).all():
        raise AssertionError("result labels out of range")
    ex = ((x[labels[:256]] - queries[:256, None, :]) ** 2).sum(-1)
    if not np.allclose(dists[:256], ex, rtol=rtol, atol=atol):
        raise AssertionError("returned distances disagree with exact ones")


def phase_hnsw(card, x, queries, gt, tally):
    """The HNSW path through the hnswlib-compatible API, on the card by
    default. Returns (the graph's host arrays for the hybrid phase to
    compare its own insert with, merge launches of the records search, the
    index for phase 5c, the first ef of the plain sweep that reached the
    target, the plain recall@10 there)."""
    from hnsw_nsg_tpu_torch.api import Index
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms
    from hnsw_nsg_tpu_torch.ops import recall

    n, d = x.shape
    nq, k = queries.shape[0], 10
    print(f"HNSW path at N={n} (Index('l2', {d}), M=16, ef_construction=200)")
    reset_counts(cs, ms)
    p = Index("l2", d)
    # allow_replace_deleted only lets phase 5c reuse deleted slots; the
    # build is the same
    p.init_index(n, M=16, ef_construction=200, allow_replace_deleted=True)
    idx = p._index
    if idx.data.device.type != "cuda":
        raise AssertionError("Index() did not put its arrays on the card")
    idx.stage_seconds = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.add_items(x)
    torch.cuda.synchronize()
    ins_s = time.perf_counter() - t0
    # the cold start's 32..2048 doubling (7 batches, 4064 points), then 4096s
    batches = 7 + -(-(n - 4064) // 4096)
    stages = ", ".join(f"{nm} {sec:.2f}" for nm, sec in
                       idx.stage_seconds.items())
    print(f"HNSW add_items: {ins_s:.2f} s, {n / ins_s:.1f} points/s, "
          f"{batches} batches; seconds by phase: {stages} (the rest: "
          f"connectivity repair and host bookkeeping) [{card}]")
    idx.stage_seconds = None
    launch_split(ms, "HNSW build", tally)

    t0 = time.perf_counter()
    if not idx.check_integrity():
        raise AssertionError("HNSW check_integrity failed")
    adj0 = idx.adj0[:n].cpu().numpy()
    ok, reached_n = bfs_reaches_all(adj0, idx.ep)
    n_up = int((idx.levels[:n] >= 1).sum())
    print(f"HNSW check_integrity ok; BFS from ep {idx.ep} reaches "
          f"{reached_n}/{n}; mean level-0 degree "
          f"{float((adj0 >= 0).sum(1).mean()):.3f} (cap 32); max level "
          f"{idx.max_level}; level >= 1 nodes {n_up} "
          f"({time.perf_counter() - t0:.1f} s of host checks)")
    if not ok:
        raise AssertionError("the HNSW level-0 graph is not connected")
    graph = dict(adj0=adj0, adj_up=[a[:n].cpu().numpy() for a in idx.adj_up],
                 levels=idx.levels[:n].copy(), ep=idx.ep)

    reset_counts(cs, ms)
    sweep, reached = {}, None
    for ef in EF_SWEEP:
        p.set_ef(ef)
        labels, dists = p.knn_query(queries, k=k)
        r = recall(labels, gt)
        med, lo, hi = timed_query(lambda: p.knn_query(queries, k=k))
        sweep[ef] = r
        print(f"ef={ef}: recall@10={r:.4f} median {med * 1e3:.3f} ms "
              f"QPS={nq / med:.1f} (min {lo * 1e3:.3f}, max {hi * 1e3:.3f} "
              f"ms) [{card}]")
        if r >= TARGET_RECALL and reached is None:
            reached = ef
    check_answers(labels, dists, x, queries, n, nq, k, 1e-4, 1e-2)
    # the reference's per-level greedy walk as the entry, for comparison
    labels, _ = idx.knn_query(queries, k=k, ef=reached or 256,
                              entry="descend")
    print(f"ef={reached or 256} with entry='descend': recall@10="
          f"{recall(labels, gt):.4f} (routed: {sweep[reached or 256]:.4f})")
    p.set_ef(EF_WIDE)
    t0 = time.perf_counter()
    labels, dists = p.knn_query(queries, k=k)
    wide_s = time.perf_counter() - t0
    r_wide = recall(labels, gt)
    print(f"ef={EF_WIDE} (merge+select's warp kernel, 32 slots a lane): "
          f"recall@10={r_wide:.4f}, one batch {wide_s * 1e3:.1f} ms [{card}]")
    check_answers(labels, dists, x, queries, n, nq, k, 1e-4, 1e-2)
    if ms.general_launches:
        raise AssertionError(f"an ef <= {EF_WIDE} search reached the "
                             f"general merge+select kernel")
    p.set_ef(EF_WIDER)
    t0 = time.perf_counter()
    labels, dists = p.knn_query(queries, k=k)
    wider_s = time.perf_counter() - t0
    r_wider = recall(labels, gt)
    print(f"ef={EF_WIDER} (the general merge+select kernel): recall@10="
          f"{r_wider:.4f}, one batch {wider_s * 1e3:.1f} ms [{card}]")
    check_answers(labels, dists, x, queries, n, nq, k, 1e-4, 1e-2)
    launch_split(ms, "HNSW search", tally)
    if ms.general_launches <= 0:
        raise AssertionError(f"ef={EF_WIDER} did not launch the general "
                             f"kernel")
    if reached is None:
        raise AssertionError(
            f"HNSW recall@10 >= {TARGET_RECALL} not reached at ef <= 256: "
            f"{sweep}")
    if min(r_wide, r_wider) < sweep[256]:
        raise AssertionError(f"recall at ef={EF_WIDE} ({r_wide}) or "
                             f"ef={EF_WIDER} ({r_wider}) is below ef=256 "
                             f"({sweep[256]})")
    print(f"HNSW recall@10 >= {TARGET_RECALL} first at ef={reached}")
    plain_ms = {}
    for ef in (96, 256):
        p.set_ef(ef)
        plain_ms[ef] = timed_query(lambda: p.knn_query(queries, k=k))[0] * 1e3
    # a plain level-0 hop gathers the adjacency row, R data rows and R
    # norms of each frontier node (R = 2M = 32, f32 rows)
    r0 = idx.adj0.shape[1]
    p.set_ef(96)
    profile_search("HNSW plain ef=96", lambda: p.knn_query(queries, k=k),
                   plain_ms[96], r0 * 4 + r0 * (4 * d + 4), card)

    # the packed int8 records (build_accel) and the same sweep over them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.build_accel()
    torch.cuda.synchronize()
    g = idx._records
    print(f"HNSW build_accel: {time.perf_counter() - t0:.2f} s, records "
          f"{g.nbytes() / 1e9:.4f} GB ({g.n} rows of {g.s * 512} B, R={g.r}) "
          f"[{card}]")
    reset_counts(cs, ms)
    rec, reached_rec = {}, None
    for ef in EF_SWEEP:
        p.set_ef(ef)
        h0, e0 = idx.metric_hops, idx.metric_distance_computations
        labels, dists = p.knn_query(queries, k=k)
        hops, evals = (idx.metric_hops - h0,
                       idx.metric_distance_computations - e0)
        r = recall(labels, gt)
        med, lo, hi = timed_query(lambda: p.knn_query(queries, k=k))
        rec[ef] = (r, med * 1e3)
        print(f"records ef={ef}: recall@10={r:.4f} (plain {sweep[ef]:.4f}) "
              f"median {med * 1e3:.3f} ms QPS={nq / med:.1f} (min "
              f"{lo * 1e3:.3f}, max {hi * 1e3:.3f} ms); expansions {hops}, "
              f"distance evaluations {evals} [{card}]")
        if r >= TARGET_RECALL and reached_rec is None:
            reached_rec = ef
    check_answers(labels, dists, x, queries, n, nq, k, 1e-4, 1e-2)
    launch_split(ms, "HNSW records search", tally)
    rec_launches = ms.launches
    if rec_launches <= 0:
        raise AssertionError("the records search did not launch merge_select")
    if reached_rec is None:
        raise AssertionError(f"HNSW records recall@10 >= {TARGET_RECALL} not "
                             f"reached at ef <= 256: {rec}")
    print(f"HNSW records recall@10 >= {TARGET_RECALL} first at ef="
          f"{reached_rec} (plain: ef={reached})")
    p.set_ef(96)
    profile_search("HNSW records ef=96", lambda: p.knn_query(queries, k=k),
                   rec[96][1], g.s * 512, card)
    print(f"HNSW ef=96 a batch: plain {plain_ms[96]:.3f} ms, records "
          f"{rec[96][1]:.3f} ms; ef=256: plain {plain_ms[256]:.3f}, records "
          f"{rec[256][1]:.3f} [{card}]")
    return graph, rec_launches, p, reached, sweep[reached]


def part_launches(ms, what, tally, need="warp"):
    """launch_split for one part of a phase, which fails unless
    merge+select's ``need`` kernel launched in it."""
    by = {}
    for (_, l_, c_, _), cnt in ms.launches_by_shape.items():
        kern = ms_kernel(ms, l_, c_)
        by[kern] = by.get(kern, 0) + cnt
    launch_split(ms, what, tally)
    if by.get(need, 0) <= 0:
        raise AssertionError(f"{what}: merge+select's {need} kernel did not "
                             f"launch ({by})")


# phase 5c: slots replaced one at a time, as the reference does. Cut from
# 1,000: a replacement takes 0.32-0.61 s on the card (a width-200 beam at
# each of the index's levels, ~960 host-bound hops), so 100 take 30-60 s
CHURN = 100


def phase_range_churn(card, p, x, queries, ef, plain_recall, tally):
    """Phase 5c on phase 5's index: (a) ``epsilon_query`` at the API's
    max_candidates=128, epsilon the median over queries of the exact
    10th-NN distance; (b) ``mark_deleted`` of CHURN sampled labels, then
    ``add_items(replace_deleted=True)`` of as many fresh rows of phase
    5's mixture (its centres drawn again from seed 0, the rows from the
    seed-1 generator that drew the labels)."""
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms

    idx = p._index
    n, d = x.shape
    nq = len(queries)
    xd = idx.data[:n]                       # phase 5's labels are its rows
    qd = torch.from_numpy(queries).cuda()

    # (a) range search against the exact in-range set, capped at its 128
    # nearest (the beam's width)
    ex_d, ex_i = brute_force_topk(qd, xd, 128)
    ex_d, ex_i = ex_d.cpu().numpy(), ex_i.cpu().numpy()
    eps = float(np.median(ex_d[:, 9]))
    reset_counts(cs, ms)
    labels, dists, counts = p.epsilon_query(queries, eps)
    med, lo, hi = timed_query(lambda: p.epsilon_query(queries, eps))
    part_launches(ms, "range search", tally)
    live = labels >= 0
    if not (counts == live.sum(1)).all():
        raise AssertionError("epsilon_query counts disagree with its labels")
    rows = torch.from_numpy(np.where(live, labels, 0)).cuda()
    exact = ((xd[rows] - qd[:, None]) ** 2).sum(-1).cpu().numpy()
    if not np.allclose(dists[live], exact[live], rtol=1e-4, atol=1e-2):
        raise AssertionError("range search distances disagree with exact ones")
    if (dists[live] > eps).any():
        raise AssertionError("range search returned a point past epsilon")
    want = ex_d <= eps
    hit = ((labels[:, :, None] == ex_i[:, None, :]) & live[:, :, None]
           & want[:, None, :]).any(1)
    r_range = float(hit.sum() / max(want.sum(), 1))
    print(f"range search (epsilon={eps:.4f}, the median exact 10th-NN "
          f"distance; max_candidates=128): one batch of {nq} median "
          f"{med * 1e3:.3f} ms (min {lo * 1e3:.3f}, max {hi * 1e3:.3f}); "
          f"count mean {counts.mean():.2f}, largest {counts.max()}; range "
          f"recall {r_range:.4f} against the exact in-range set capped at "
          f"its 128 nearest ({int(want.sum())} points) [{card}]")
    if r_range < 0.9:
        raise AssertionError(f"range recall {r_range} < 0.9")
    del rows, exact

    # (b) churn: delete, then replacing adds one point at a time
    rng = np.random.default_rng(1)
    dead = np.sort(rng.choice(n, CHURN, replace=False))
    centres = np.random.default_rng(0).standard_normal(
        (max(n // 2500, 8), d)).astype(np.float32)
    fresh = centres[rng.integers(0, len(centres), CHURN)] + \
        rng.standard_normal((CHURN, d), dtype=np.float32)
    new_labels = np.arange(n, n + CHURN)
    count0 = p.get_current_count()
    for lab in dead:
        p.mark_deleted(int(lab))
    reset_counts(cs, ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.add_items(fresh, new_labels, replace_deleted=True)
    torch.cuda.synchronize()
    churn_s = time.perf_counter() - t0
    print(f"churn: {CHURN} labels deleted, {CHURN} fresh rows added with "
          f"replace_deleted=True in {churn_s:.2f} s, "
          f"{churn_s / CHURN * 1e3:.2f} ms per replaced point [{card}]")
    part_launches(ms, "churn (replace_point beams)", tally)
    if p.get_current_count() != count0:
        raise AssertionError("replacing adds changed the element count")
    if set(dead.tolist()) & set(p.get_ids_list()):
        raise AssertionError("a deleted label survived the replacing adds")
    if not torch.equal(idx.data[torch.from_numpy(dead).cuda()],
                       torch.from_numpy(fresh).cuda()):
        raise AssertionError("the fresh rows did not land in the dead slots")
    p.set_ef(ef)
    found, _ = p.knn_query(fresh, k=1)
    self_r = float((found[:, 0] == new_labels).mean())
    # the ground truth over the changed set, as labels
    _, gt_slots = brute_force_topk(qd, idx.data[:n], 10)
    gt2 = idx.labels[gt_slots.cpu().numpy()]
    got, _ = p.knn_query(queries, k=10)
    r_churn = recall(got, gt2)
    print(f"after churn: self-query recall@1 of the new points {self_r:.4f}; "
          f"recall@10 at ef={ef} {r_churn:.4f} against the changed set's "
          f"ground truth (phase 5 at ef={ef}: {plain_recall:.4f}) [{card}]")
    if self_r < 0.95:
        raise AssertionError(f"new points' self-query recall {self_r} < 0.95")
    if abs(r_churn - plain_recall) > 0.01:
        raise AssertionError(f"recall after churn {r_churn} is not within "
                             f"0.01 of phase 5's {plain_recall}")


def phase_accel_insert(card, x, queries, tally, n=250_000):
    """add_items(accel=True) on the first ``n`` points: the records are
    maintained through the inserts and the level-0 beams walk them. The
    maintained rows must equal a fresh pack of the final graph at the
    same scale. Returns merge+select's launches."""
    from hnsw_nsg_tpu_torch.models.hnsw import HNSWIndex
    from hnsw_nsg_tpu_torch.models.records import build_record_graph
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms
    from hnsw_nsg_tpu_torch.utils.params import HNSWConfig

    d = x.shape[1]
    reset_counts(cs, ms)
    idx = HNSWIndex(d, n, HNSWConfig(M=16, ef_construction=200))
    idx.stage_seconds = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.add_items(x[:n], accel=True)
    torch.cuda.synchronize()
    ins_s = time.perf_counter() - t0
    stages = ", ".join(f"{nm} {sec:.2f}" for nm, sec in
                       idx.stage_seconds.items())
    print(f"HNSW add_items(accel=True) at N={n}: {ins_s:.2f} s, "
          f"{n / ins_s:.1f} points/s; seconds by phase: {stages} [{card}]")
    idx.stage_seconds = None
    launch_split(ms, "HNSW accel insert", tally)
    g = idx._records
    fresh = build_record_graph(idx.data, idx.adj0[:, : g.r], idx.norms,
                               scale=g.scale)
    if not torch.equal(fresh.rows, g.rows):
        raise AssertionError("the maintained records differ from a fresh "
                             "pack of the final graph")
    print(f"maintained records ({g.nbytes() / 1e9:.4f} GB, scale "
          f"{g.scale:.6g}) equal a fresh pack of the final adj0[:, :{g.r}]")
    if not idx.check_integrity():
        raise AssertionError("the accel-built HNSW fails check_integrity")
    qd = torch.from_numpy(queries).cuda()
    _, gt = brute_force_topk(qd, idx.data[:n], 10)
    labels, _ = idx.knn_query(queries, k=10, ef=96)
    print(f"accel-built N={n}, records search ef=96: recall@10="
          f"{recall(labels, gt.cpu()):.4f} (against the cut's brute force)")
    launches = ms.launches
    if launches <= 0:
        raise AssertionError("the accel insert did not launch merge_select")
    del idx, g, fresh, qd
    torch.cuda.empty_cache()
    return launches


def phase_hybrid(card, x, queries, gt, hnsw_graph, tally):
    """The hybrid path (HNSW upper levels routing into an NSG base layer)
    and, on its NSG, the NSG path from the medoid; then two more kNN
    graphs. Returns (the join launches at 128 rows a block: the NSG
    build's and the k=100 graph's, n_slabs, the records search's merge
    launches, the k=200 graph's join launches at 64 rows a block, the f32
    graph's join launches)."""
    from hnsw_nsg_tpu_torch.models.hybrid import HybridHNSWNSG
    from hnsw_nsg_tpu_torch.models.knn_ivf import knn_graph_ivf
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms
    from hnsw_nsg_tpu_torch.ops import recall
    from hnsw_nsg_tpu_torch.utils.params import NSGBuildConfig

    n, d = x.shape
    nq, k = queries.shape[0], 10
    cfg = NSGBuildConfig()
    print(f"hybrid path at N={n} (HybridHNSWNSG, NSG L={cfg.L} R={cfg.R} "
          f"C={cfg.C})")
    reset_counts(cs, ms)
    hyb = HybridHNSWNSG(d, n, nsg_cfg=cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyb.add_points(x)
    torch.cuda.synchronize()
    ins_s = time.perf_counter() - t0
    print(f"hybrid add_points: {ins_s:.2f} s, {n / ins_s:.1f} points/s "
          f"[{card}]")
    h = hyb.hnsw
    same = (h.ep == hnsw_graph["ep"]
            and np.array_equal(h.levels[:n], hnsw_graph["levels"])
            and np.array_equal(h.adj0[:n].cpu().numpy(), hnsw_graph["adj0"])
            and len(h.adj_up) == len(hnsw_graph["adj_up"])
            and all(np.array_equal(a[:n].cpu().numpy(), b)
                    for a, b in zip(h.adj_up, hnsw_graph["adj_up"])))
    if not same:
        raise AssertionError("two HNSW inserts of one seed gave two graphs")
    print("two HNSW inserts of one seed (phase 5's and this one): one graph "
          "at every level")
    hnsw_graph.clear()
    insert_launches = ms.launches

    stats = {}
    t0 = time.perf_counter()
    hyb.build_nsg_layer(stats=stats)
    torch.cuda.synchronize()
    layer_s = time.perf_counter() - t0
    adj = stats.pop("knn_adj")
    print(f"kNN graph (k={adj.shape[1]}, probes={stats['probes']}, "
          f"C={stats['n_slabs']} maxc={stats['maxc']} join k={stats['k']}): "
          f"{stats['knn']:.2f} s [{card}]")
    for st in ("collect_prune", "interinsert", "tree_grow"):
        print(f"NSG {st}: {stats[st]:.2f} s [{card}]")
    print(f"build_nsg_layer total (kNN + medoid + NSG): {layer_s:.2f} s "
          f"[{card}]")
    idx = hyb.nsg
    xd = h.data[:n]
    qd = torch.from_numpy(queries).to(xd.device)
    knn_r = exact_knn_recall(xd, adj)
    print(f"kNN graph recall on a 10k-node sample: {knn_r:.4f}")
    del adj
    adj_np = idx.adj.cpu().numpy()
    mean_deg = float((adj_np >= 0).sum(1).mean())
    ok, reached_n = bfs_reaches_all(adj_np, idx.ep)
    print(f"NSG mean degree {mean_deg:.3f} (R={cfg.R}); BFS from ep "
          f"{idx.ep} reaches {reached_n}/{n}")
    if not ok:
        raise AssertionError("the NSG is not connected from its entry point")
    if (adj_np == np.arange(n)[:, None]).any():
        raise AssertionError("the NSG has a self edge")
    del adj_np
    launch_split(ms, "hybrid build (HNSW insert + NSG build)", tally)
    if ms.launches <= insert_launches or cs.join_launches <= 0:
        raise AssertionError("the NSG build did not launch both kernels")
    build_join = cs.join_launches_by_kernel["join_mma_kernel"]
    if build_join != cs.join_launches or cs.join_block_rows(
            d, stats["k"], torch.bfloat16) != 128:
        raise AssertionError("the NSG build's join did not run the "
                             "tensor-core kernel at 128 rows a block")

    # the NSG path from its single medoid entry (reported, not gated: the
    # 400 mixture components of the 1M data keep a beam from the medoid
    # inside too few of them, as in the JAX package)
    reset_counts(cs, ms)
    for ls in L_SWEEP:
        dd, ii = idx.search(qd, k=k, l_search=ls)
        r = recall(ii.cpu(), gt)
        med, lo, hi = timed_query(
            lambda: idx.search(qd, k=k, l_search=ls)[1].cpu())
        print(f"NSG from the medoid, l_search={ls}: recall@10={r:.4f} median "
              f"{med * 1e3:.3f} ms QPS={nq / med:.1f} (min {lo * 1e3:.3f}, "
              f"max {hi * 1e3:.3f} ms) [{card}]")
    check_answers(ii.cpu().numpy(), dd.cpu().numpy(), x, queries, n, nq, k,
                  1e-4, 1e-2)
    entries = sampled_entries(qd, xd)
    for ls in (64, 128):
        _, ei = idx.search_from_enterpoint(qd, entries, k=k, l_search=ls)
        print(f"search_from_enterpoint (nearest of 4096 sampled points) "
              f"l_search={ls}: recall@10={recall(ei.cpu(), gt):.4f}")
    launch_split(ms, "NSG search from the medoid", tally)

    # the hybrid's own search: the routed entry, then SearchFromEnterpoint
    reset_counts(cs, ms)
    sweep, reached = {}, None
    for ls in L_SWEEP:
        labels, dists = hyb.search_knn(queries, k=k, l_search=ls)
        r = recall(labels, gt)
        med, lo, hi = timed_query(
            lambda: hyb.search_knn(queries, k=k, l_search=ls))
        sweep[ls] = r
        print(f"hybrid routed, l_search={ls}: recall@10={r:.4f} median "
              f"{med * 1e3:.3f} ms QPS={nq / med:.1f} (min {lo * 1e3:.3f}, "
              f"max {hi * 1e3:.3f} ms) [{card}]")
        if r >= TARGET_RECALL and reached is None:
            reached = ls
    check_answers(labels, dists, x, queries, n, nq, k, 1e-4, 1e-2)
    labels, _ = hyb.search_knn(queries, k=k, l_search=64, entry="descend")
    med, _, _ = timed_query(lambda: hyb.search_knn(
        queries, k=k, l_search=64, entry="descend"))
    print(f"hybrid descend, l_search=64: recall@10={recall(labels, gt):.4f} "
          f"median {med * 1e3:.3f} ms (routed: {sweep[64]:.4f}) [{card}]")
    launch_split(ms, "hybrid search", tally)
    if ms.launches <= 0:
        raise AssertionError("the hybrid search did not launch merge_select")
    if reached is None:
        raise AssertionError(
            f"hybrid recall@10 >= {TARGET_RECALL} not reached at l_search "
            f"<= 256: {sweep}")
    print(f"hybrid recall@10 >= {TARGET_RECALL} first at l_search={reached} "
          f"(N={n})")
    plain_ms = {ls: timed_query(lambda: hyb.search_knn(
        queries, k=k, l_search=ls))[0] * 1e3 for ls in (64, 256)}
    # a plain NSG hop gathers the adjacency row, R data rows and R norms of
    # each frontier node (R = 50, f32 rows)
    r_nsg = idx.adj.shape[1]
    profile_search("hybrid plain l_search=64",
                   lambda: hyb.search_knn(queries, k=k, l_search=64),
                   plain_ms[64], r_nsg * 4 + r_nsg * (4 * d + 4), card)

    # the NSG layer packed into records, and the routed sweep over them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyb.build_accel()
    torch.cuda.synchronize()
    g = idx.records
    print(f"hybrid build_accel: {time.perf_counter() - t0:.2f} s, records "
          f"{g.nbytes() / 1e9:.4f} GB ({g.n} rows of {g.s * 512} B, R={g.r}) "
          f"[{card}]")
    reset_counts(cs, ms)
    rec, reached_rec = {}, None
    for ls in L_SWEEP:
        labels, dists = hyb.search_knn(queries, k=k, l_search=ls)
        r = recall(labels, gt)
        med, lo, hi = timed_query(
            lambda: hyb.search_knn(queries, k=k, l_search=ls))
        rec[ls] = (r, med * 1e3)
        print(f"hybrid records routed, l_search={ls}: recall@10={r:.4f} "
              f"(plain {sweep[ls]:.4f}) median {med * 1e3:.3f} ms QPS="
              f"{nq / med:.1f} (min {lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) "
              f"[{card}]")
        if r >= TARGET_RECALL and reached_rec is None:
            reached_rec = ls
    check_answers(labels, dists, x, queries, n, nq, k, 1e-4, 1e-2)
    launch_split(ms, "hybrid records search", tally)
    rec_launches = ms.launches
    if rec_launches <= 0:
        raise AssertionError("the records search did not launch merge_select")
    if reached_rec is None:
        raise AssertionError(f"hybrid records recall@10 >= {TARGET_RECALL} "
                             f"not reached at l_search <= 256: {rec}")
    print(f"hybrid records recall@10 >= {TARGET_RECALL} first at l_search="
          f"{reached_rec} (plain: {reached})")
    profile_search("hybrid records l_search=64",
                   lambda: hyb.search_knn(queries, k=k, l_search=64),
                   rec[64][1], g.s * 512, card)
    print(f"hybrid l_search=64 a batch: plain {plain_ms[64]:.3f} ms, records "
          f"{rec[64][1]:.3f} ms; l_search=256: plain {plain_ms[256]:.3f}, "
          f"records {rec[256][1]:.3f} [{card}]")
    n_slabs = stats["n_slabs"]
    del hyb, idx, h, qd, g

    # the kNN graph at k = 100 (join k = 102: the tensor-core join at 128
    # rows a block), at k = 200 (join k = 202: 64 rows a block), and at
    # k = 50 with exact f32 slabs (the CUDA-core join)
    graphs = {}
    for kg, dt in ((100, torch.bfloat16), (200, torch.bfloat16),
                   (50, torch.float32)):
        torch.cuda.empty_cache()
        reset_counts(cs, ms)
        t0 = time.perf_counter()
        adj = knn_graph_ivf(xd, kg, slab_dtype=dt, as_device=True)
        torch.cuda.synchronize()
        knn_s = time.perf_counter() - t0
        kern = cs.JOIN_KERNELS[dt]
        rows = cs.join_block_rows(d, kg + 2, dt)
        print(f"kNN graph k={kg} ({str(dt).split('.')[-1]} slabs; {kern}, "
              f"{rows} rows a block): {knn_s:.2f} s, recall on a 10k-node "
              f"sample {exact_knn_recall(xd, adj):.4f} [{card}]")
        graphs[kg] = cs.join_launches_by_kernel[kern]
        if graphs[kg] <= 0 or graphs[kg] != cs.join_launches:
            raise AssertionError(f"the k={kg} kNN graph did not run {kern}")
        del adj
    if [cs.join_block_rows(d, kj, torch.bfloat16) for kj in (102, 202)] != [
            128, 64]:
        raise AssertionError("join k=102 is not at 128 rows a block or "
                             "k=202 not at 64")
    del xd
    torch.cuda.empty_cache()
    return (build_join + graphs[100], n_slabs, rec_launches, graphs[200],
            graphs[50])


# phase 6b: CNNS with NSG locals (bench.py:414-444, engine cnns_nsg) and
# the router x local ablation (the reference's experiment_feature/)
NSG_NPROBE = (1, 2, 3, 4, 6, 8)
HNSW_LOCAL_N = 65_536       # the local HNSW ablation's cut of the data
HNSW_LOCAL_CLUSTERS = 64
LOCAL_NPROBE = (1, 2, 4, 6)
PARITY_Q = 1024


def arena_reach(idx):
    """Live rows of a graph-local index's arena, and how many of them a
    BFS from every non-empty cluster's entry point reaches."""
    from hnsw_nsg_tpu_torch.models.cnns import _bfs, _dead_rows

    adj = idx.flat_adj.cpu().numpy()
    live = ~_dead_rows(idx.sizes, idx.maxc)
    seeds = np.asarray(idx.eps_flat)[idx.sizes > 0]
    reached = _bfs(adj, seeds, ~live)
    return adj, live, int(reached[live].sum())


def phase_cnns_nsg(card, x, queries, gt, flat_idx, tally, device="cuda",
                   n_clusters=None, local_n=HNSW_LOCAL_N,
                   local_clusters=HNSW_LOCAL_CLUSTERS):
    """Phase 6b: ``build_cnns(x, CNNSConfig(n_clusters=976, m=4,
    kmeans_iters=12), local_index="nsg")`` on phase 3's data, f32 slabs, no
    replication (bench.py:419-444): build seconds by stage, the arena's
    mean degree, a BFS from the entry points reaching every real node, the
    bytes of ``flat_adj`` and of the index; an nprobe sweep at k=10 and
    l_search=100 (median of 10) that must reach recall@10 >= 0.95 at some
    nprobe <= 8, merge+select's launches by shape and kernel around it
    (some must launch), and the output checks; at that nprobe
    ``router="hnsw"`` on this index and on phase 3's flat index, each
    within 0.05 recall of its flat router; then ``local_index="hnsw"`` on
    the first 65,536 rows in 64 clusters (cut: an ablation of sequential
    per-cluster HNSW builds): BFS, the recall at l_search 64 by nprobe,
    and the card's search against the CPU's. Smaller inputs and
    ``device="cpu"`` rehearse it.
    Returns the scan's launches by kernel of the flat index's HNSW-routed
    search."""
    from hnsw_nsg_tpu_torch.models.cnns import build_cnns
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n, nq = x.shape[0], queries.shape[0]
    qd = torch.from_numpy(queries).to(device)
    n_clusters = n_clusters or max(n // 1024, 8)
    t_phase = time.perf_counter()

    stages = {}
    reset_counts(cs, ms)
    sync()
    t0 = time.perf_counter()
    idx = build_cnns(x, CNNSConfig(n_clusters=n_clusters, m=4,
                                   kmeans_iters=12),
                     local_index="nsg", device=device, stage_seconds=stages)
    sync()
    build_s = time.perf_counter() - t0
    rest = build_s - sum(stages.values())
    launch_split(ms, "cnns nsg build", tally)
    adj, live, reached_nodes = arena_reach(idx)
    deg = (adj[live] >= 0).sum(1)
    # every member of a slab with another member has an out-edge (a slab
    # of one member, the tail of a split cluster, has none)
    alone = np.repeat(idx.sizes == 1, idx.maxc)[live]
    print(f"cnns nsg build: {build_s:.2f} s (k-means {stages['kmeans']:.2f}, "
          f"pools+prune {stages['pools_prune']:.2f}, interinsert "
          f"{stages['interinsert']:.2f}, repair {stages['repair']:.2f}, "
          f"layout and slabs {rest:.2f} s), C={idx.n_clusters} "
          f"({idx.n_real} real) maxc={idx.maxc}, arena "
          f"{adj.shape[0]} x {adj.shape[1]}; mean degree {deg.mean():.3f} "
          f"(max {deg.max()}; {int(alone.sum())} members alone in their "
          f"slab); BFS from the entry points reaches "
          f"{reached_nodes} of {int(live.sum())} real nodes; flat_adj "
          f"{adj.nbytes / 1e9:.4f} GB, index {idx.index_bytes() / 1e9:.4f} "
          f"GB [{card}]")
    if reached_nodes != int(live.sum()) or int(live.sum()) != n:
        raise AssertionError("the local NSG arena does not reach every node")
    if deg.max() > idx.flat_adj.shape[1] or deg[~alone].min() < 1:
        raise AssertionError(f"arena degrees {deg.min()}..{deg.max()}")
    del adj, live

    reset_counts(cs, ms)
    sweep, reached = {}, None
    for nprobe in NSG_NPROBE:
        dd, ii = idx.search(qd, k=10, nprobe=nprobe)
        dd, ii = dd.cpu(), ii.cpu()
        r = recall(ii, gt)
        med, lo, hi = timed_query(
            lambda: idx.search(qd, k=10, nprobe=nprobe)[1].cpu())
        sweep[nprobe] = r
        print(f"cnns nsg nprobe={nprobe} l_search=100: recall@10={r:.4f} "
              f"median {med * 1e3:.3f} ms QPS={nq / med:.1f} (min "
              f"{lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) [{card}]")
        if r >= TARGET_RECALL:
            reached = nprobe
            break
    if reached is None:
        raise AssertionError(f"cnns nsg: recall@10 >= {TARGET_RECALL} not "
                             f"reached at nprobe <= 8: {sweep}")
    launch_split(ms, "cnns nsg sweep", tally)
    if on_card and ms.launches <= 0:
        raise AssertionError("the nsg-local sweep launched no merge+select")
    if on_card and cs.launches:
        raise AssertionError("the nsg-local search launched the grouped scan")
    # finite, ascending, in-range ids, distances within rtol 1e-4 of the
    # exact f32 ones (f32 slabs)
    if not bool(torch.isfinite(dd).all()) or not bool(
            (dd[:, 1:] >= dd[:, :-1]).all()):
        raise AssertionError("cnns nsg: bad distances")
    if not bool(((ii >= 0) & (ii < n)).all()):
        raise AssertionError("cnns nsg: ids out of range")
    ex = ((torch.from_numpy(x)[ii[:256].long()]
           - torch.from_numpy(queries)[:256, None, :]) ** 2).sum(-1)
    if not torch.allclose(dd[:256], ex, rtol=1e-4, atol=1e-2):
        raise AssertionError("cnns nsg: distances disagree with exact ones")

    # the HNSW router at that nprobe, on this index and on phase 3's flat
    # index (bf16 slabs, replicated); its knn_query runs merge+select
    routed = {}
    scan_hnsw = {}
    for name, ix in (("nsg locals", idx), ("flat locals", flat_idx)):
        reset_counts(cs, ms)
        sync()
        t0 = time.perf_counter()
        ix.build_router_hnsw()
        sync()
        rb_s = time.perf_counter() - t0
        r_flat = recall(ix.search(qd, k=10, nprobe=reached)[1].cpu(), gt)
        reset_counts(cs, ms)
        r_h = recall(ix.search(qd, k=10, nprobe=reached,
                               router="hnsw")[1].cpu(), gt)
        med, lo, hi = timed_query(
            lambda: ix.search(qd, k=10, nprobe=reached,
                              router="hnsw")[1].cpu(), reps=3)
        print(f"router=hnsw on {name}, nprobe={reached}: recall@10={r_h:.4f} "
              f"(flat router {r_flat:.4f}); router build {rb_s:.2f} s over "
              f"{ix._router_hnsw.n} representatives; median {med * 1e3:.3f} "
              f"ms (min {lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) [{card}]")
        launch_split(ms, f"router=hnsw on {name}", tally)
        if name == "flat locals":
            scan_hnsw = scan_counts(cs, "router=hnsw on the flat index",
                                    device)
        routed[name] = (r_h, r_flat)
        if r_h < r_flat - 0.05:
            raise AssertionError(f"router=hnsw on {name}: {r_h} against "
                                 f"the flat router's {r_flat}")
        ix._router_hnsw = None
    del idx

    # the local HNSW ablation on a cut of the data
    xs = x[:local_n]
    _, gt_s = brute_force_topk(qd, torch.from_numpy(xs).to(device), 10)
    gt_s = gt_s.cpu()
    reset_counts(cs, ms)
    sync()
    t0 = time.perf_counter()
    idx_h = build_cnns(xs, CNNSConfig(n_clusters=local_clusters, m=4,
                                      kmeans_iters=12),
                       local_index="hnsw", device=device)
    sync()
    hb_s = time.perf_counter() - t0
    launch_split(ms, "local hnsw build", tally)
    _, live_h, reach_h = arena_reach(idx_h)
    deg_h = (idx_h.flat_adj.cpu().numpy()[live_h] >= 0).sum(1)
    print(f"local_index=hnsw on the first {local_n} rows, {local_clusters} "
          f"clusters (C={idx_h.n_real} real, maxc={idx_h.maxc}): build "
          f"{hb_s:.2f} s (one HNSW a cluster, in turn); mean level-0 degree "
          f"{deg_h.mean():.3f}; BFS reaches {reach_h} of "
          f"{int(live_h.sum())} real nodes [{card}]")
    if reach_h != int(live_h.sum()) or reach_h != local_n:
        raise AssertionError("the local HNSW arena does not reach every node")
    reset_counts(cs, ms)
    local = {}
    for nprobe in LOCAL_NPROBE:
        _, ii = idx_h.search(qd, k=10, nprobe=nprobe, l_search=64)
        local[nprobe] = recall(ii.cpu(), gt_s)
        print(f"local_index=hnsw nprobe={nprobe} l_search=64: recall@10="
              f"{local[nprobe]:.4f} [{card}]")
    med, lo, hi = timed_query(
        lambda: idx_h.search(qd, k=10, nprobe=6, l_search=64)[1].cpu(),
        reps=3)
    print(f"local_index=hnsw nprobe=6 l_search=64: median {med * 1e3:.3f} ms "
          f"(min {lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) [{card}]")
    launch_split(ms, "local hnsw search", tally)
    # the card's search against the same index searched on the CPU: one
    # beam algorithm, f32 sums in another order (near-ties may swap)
    if on_card:
        cpu_h = dataclasses.replace(idx_h, **{
            f: getattr(idx_h, f).cpu() for f in ("reps", "data_c", "ids_c",
                                                 "cnorms_c", "flat_adj")})
        qs = qd[:PARITY_Q]
        gd, gi = idx_h.search(qs, k=10, nprobe=6, l_search=64)
        cd, ci = cpu_h.search(qs.cpu(), k=10, nprobe=6, l_search=64)
        same = gi.cpu() == ci
        print(f"local_index=hnsw on the card against the CPU ({PARITY_Q} "
              f"queries): {int((~same).sum())} of {same.numel()} ids differ")
        if same.float().mean() < 0.99 or not torch.allclose(
                gd.cpu()[same], cd[same], rtol=1e-5, atol=1e-3):
            raise AssertionError("local hnsw: the card's search is not the "
                                 "CPU's")
    del idx_h, qd
    if on_card:
        torch.cuda.empty_cache()
    print(f"cnns nsg phase: {time.perf_counter() - t_phase:.1f} s")
    return scan_hnsw


# phase 6c: the small-N graph builders at the top of the hybrid's rp-tree
# range (hybrid.py's 8,192 < N <= 200,000)
SMALL_N = 200_000
DESCENT_N = 100_000
ADD_N = 10_000


def phase_small_n(card, x, queries, tally):
    """Phase 6c on the first SMALL_N rows of the graph phases' data, the
    same queries and a ground truth over those rows: (a) the hybrid's
    default build (rp-trees refined by nn-descent, then NSG) and its
    routed sweep; (b) ``nn_descent`` from random init at the first
    DESCENT_N rows with the reference's defaults; (c) ``graph_add`` of the
    next ADD_N rows into (b)'s graph; (d) ``MultiVectorIndex`` over the
    SMALL_N rows as documents of 8 consecutive rows."""
    from hnsw_nsg_tpu_torch.api import MultiVectorIndex
    from hnsw_nsg_tpu_torch.models.hybrid import HybridHNSWNSG
    from hnsw_nsg_tpu_torch.models.nndescent import graph_add, nn_descent
    from hnsw_nsg_tpu_torch.ops import (brute_force_topk, pairwise_dists,
                                        recall, topk_smallest)
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms
    from hnsw_nsg_tpu_torch.utils.params import NNDescentConfig, NSGBuildConfig

    n, d = SMALL_N, x.shape[1]
    nq, k = queries.shape[0], 10
    xs = x[:n]
    xd = torch.from_numpy(xs).cuda()
    qd = torch.from_numpy(queries).cuda()
    gt = brute_force_topk(qd, xd, k)[1].cpu()

    # (a) the hybrid's default build at N = SMALL_N
    cfg = NSGBuildConfig()
    print(f"small-N builders at N={n}: HybridHNSWNSG (NSG L={cfg.L} "
          f"R={cfg.R} C={cfg.C}), default build_nsg_layer()")
    reset_counts(cs, ms)
    hyb = HybridHNSWNSG(d, n, nsg_cfg=cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyb.add_points(xs)
    torch.cuda.synchronize()
    ins_s = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    hyb.build_nsg_layer(stats=stats)
    torch.cuda.synchronize()
    layer_s = time.perf_counter() - t0
    adj = stats.pop("knn_adj")
    nsg_s = sum(stats[st] for st in ("collect_prune", "interinsert",
                                     "tree_grow"))
    print(f"insert {ins_s:.2f} s, rp-trees {stats['rp_trees']:.2f} s, "
          f"nn-descent {stats['nndescent']:.2f} s (kNN graph k="
          f"{adj.shape[1]} {stats['knn']:.2f} s), NSG build {nsg_s:.2f} s "
          f"(collect+prune {stats['collect_prune']:.2f}, interinsert "
          f"{stats['interinsert']:.2f}, tree_grow {stats['tree_grow']:.2f}); "
          f"build_nsg_layer {layer_s:.2f} s [{card}]")
    print(f"kNN graph recall@{adj.shape[1]} on a 10k-node sample: "
          f"{exact_knn_recall(xd, adj):.4f} [{card}]")
    adj_np = hyb.nsg.adj.cpu().numpy()
    ok, reached_n = bfs_reaches_all(adj_np, hyb.nsg.ep)
    print(f"NSG mean degree {float((adj_np >= 0).sum(1).mean()):.3f} "
          f"(R={cfg.R}); BFS from ep {hyb.nsg.ep} reaches {reached_n}/{n} "
          f"[{card}]")
    if not ok:
        raise AssertionError("the small-N NSG is not connected")
    del adj, adj_np
    sweep, reached = {}, None
    for ls in L_SWEEP:
        labels, dists = hyb.search_knn(queries, k=k, l_search=ls)
        r = recall(labels, gt)
        med, lo, hi = timed_query(
            lambda: hyb.search_knn(queries, k=k, l_search=ls))
        sweep[ls] = r
        print(f"small-N hybrid routed, l_search={ls}: recall@10={r:.4f} "
              f"median {med * 1e3:.3f} ms (min {lo * 1e3:.3f}, max "
              f"{hi * 1e3:.3f} ms) [{card}]")
        if r >= TARGET_RECALL and reached is None:
            reached = ls
    check_answers(labels, dists, xs, queries, n, nq, k, 1e-4, 1e-2)
    part_launches(ms, "small-N hybrid build and search", tally)
    if reached is None:
        raise AssertionError(f"small-N hybrid recall@10 >= {TARGET_RECALL} "
                             f"not reached at l_search <= 256: {sweep}")
    del hyb
    torch.cuda.empty_cache()

    # (b) nn-descent from random init, the reference's defaults
    ncfg = NNDescentConfig()
    reset_counts(cs, ms)
    st_b = {}
    t0 = time.perf_counter()
    adj_b = nn_descent(xs[:DESCENT_N], ncfg, eval_recall_every=1, stats=st_b)
    desc_s = time.perf_counter() - t0
    for i, it in enumerate(st_b["iterations"]):
        print(f"nn-descent N={DESCENT_N} iteration {i + 1}: recall@"
              f"{ncfg.K} on 100 control rows {it['recall']:.4f}, changed "
              f"{it['changed']}, {it['seconds']:.2f} s [{card}]")
    r_b = exact_knn_recall(xd[:DESCENT_N], adj_b)
    print(f"nn-descent (K={ncfg.K} L={ncfg.L} S={ncfg.S} R={ncfg.R}, "
          f"{len(st_b['iterations'])} iterations): {desc_s:.2f} s, recall@"
          f"{ncfg.K} on a 10k-node sample {r_b:.4f} [{card}]")
    launch_split(ms, "nn-descent", tally)
    # the reference's 10 iterations from random ids do not converge at this
    # N (0.86 here; the port's recall per iteration follows the JAX
    # package's, tests/test_torch_nndescent.py): the pools must improve
    # every iteration and reach 0.8
    curve = [it["recall"] for it in st_b["iterations"]]
    if any(b < a for a, b in zip(curve, curve[1:])) or r_b < 0.8:
        raise AssertionError(f"nn-descent did not converge: control recall "
                             f"{curve}, final {r_b}")

    # (c) graph_add of the next ADD_N rows
    n_c = DESCENT_N + ADD_N
    old = np.random.default_rng(0).choice(DESCENT_N, min(10_000, DESCENT_N),
                                          replace=False)
    r_old0 = exact_knn_recall(xd[:DESCENT_N], adj_b, rows=old)
    reset_counts(cs, ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, adj_c = graph_add(xs[:DESCENT_N], adj_b, xs[DESCENT_N:n_c])
    add_s = time.perf_counter() - t0
    r_new = exact_knn_recall(xd[:n_c], adj_c,
                             rows=np.arange(DESCENT_N, n_c))
    r_old1 = exact_knn_recall(xd[:n_c], adj_c, rows=old)
    print(f"graph_add of {ADD_N} rows into the N={DESCENT_N} graph: "
          f"{add_s:.2f} s; the new rows' recall@{ncfg.K} {r_new:.4f} "
          f"against the exact graph over {n_c}; {len(old)} old rows {r_old0:.4f} "
          f"before, {r_old1:.4f} after [{card}]")
    part_launches(ms, "graph_add", tally)
    del adj_b, adj_c

    # (d) multivector documents: 8 consecutive rows a document
    reset_counts(cs, ms)
    docs = np.arange(n) // 8
    mv = MultiVectorIndex("l2", d)
    mv.init_index(n, M=16, ef_construction=200)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mv.add_items(xs, docs)
    torch.cuda.synchronize()
    mv_s = time.perf_counter() - t0
    got, gd = mv.knn_doc_query(queries, k=k, ef=128)
    med, lo, hi = timed_query(lambda: mv.knn_doc_query(queries, k=k, ef=128))
    if any(len(np.unique(r[r >= 0])) != (r >= 0).sum() for r in got):
        raise AssertionError("knn_doc_query returned a document twice")
    want = []
    for s0 in range(0, nq, 1024):
        dq = pairwise_dists(qd[s0 : s0 + 1024], xd).view(-1, n // 8, 8)
        best = dq.min(-1).values
        ids = torch.arange(n // 8, device=best.device).expand_as(best)
        want.append(topk_smallest(best, ids, k)[1].cpu())
    r_doc = recall(got, torch.cat(want))
    print(f"MultiVectorIndex ({n // 8} documents of 8 rows; M=16, "
          f"ef_construction=200): insert {mv_s:.2f} s; knn_doc_query k={k} "
          f"ef=128 median {med * 1e3:.3f} ms (min {lo * 1e3:.3f}, max "
          f"{hi * 1e3:.3f}); doc recall@10 {r_doc:.4f} against the exact "
          f"best-vector-per-document top-10 [{card}]")
    part_launches(ms, "multivector insert and search", tally)
    del mv, xd, qd
    torch.cuda.empty_cache()



# phase 9: the sharded indexes (parallel/mesh.py) on one card: a mesh that
# names the card four times holds four logical shards, so every per-shard
# search and every merge runs on it
SHARDS = 4
SHARD_ROWS = 250_000     # phase 9c: one of four shards of the 1M rows
SHARD_REPS = 1024        # phase 9c's representatives a shard (see there)
U8_N = 100_000           # phase 9f: the uint8 index's rows


def flat_tie_mismatches(dd, ii, ref_d, ref_i, rtol=1e-5):
    """Distances allclose ``rtol``; ids equal except in runs of distances
    equal within ``rtol`` (two f32 products of another blocking). Returns
    the count of differing ids."""
    if not torch.allclose(dd, ref_d, rtol=rtol, atol=0):
        raise AssertionError("the distances are not within rtol of the "
                             "reference's")
    close = torch.isclose(ref_d[:, 1:], ref_d[:, :-1], rtol=rtol, atol=0)
    tied = torch.isclose(ref_d, ref_d[:, -1:], rtol=rtol, atol=0)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    diff = ii.long() != ref_i.long()
    if bool((diff & ~tied).any()):
        raise AssertionError(f"{int((diff & ~tied).sum())} ids differ at "
                             f"distances that are not tied")
    return int(diff.sum())


def phase_sharded(card, x, queries, gt, flat_idx, tally, device="cuda",
                  shard_rows=SHARD_ROWS, u8_n=U8_N):
    """Phase 9 on phase 3's data and index, on a mesh of ``SHARDS``
    logical shards of ``device``: (a) ``ShardedFlatIndex`` at k=10
    against ``brute_force_topk`` (distances allclose 1e-5, ids equal
    outside ties); (b) ``sharded_knn_build_step`` at k=10 over every row,
    its recall on a 10k-row sample against the exact graph (1.0 outside
    exact ties: the sorted distances of each sampled row equal the exact
    ones); (c) ``ShardedGraphIndex`` over four ``shard_rows`` blocks, each
    with its own NSG (``knn_graph_ivf`` k=50 + ``NSGBuildConfig()``, as
    phase 6), searched at nprobe 4 and 2 over l_search 32, 64, 128:
    recall@10 >= 0.95 at nprobe 4 by l_search 128, fewer evaluations at
    nprobe 2 than at 4, merge+select's warp kernel launched; (d)
    ``ShardedCNNSIndex`` over phase 3's index: with every probe kept four
    shards give one shard's distances exactly (ids outside ties); an
    nprobe sweep (2, 4, 8) at the default slots within 0.03 recall of one
    shard; the f32 scan kernels launched; (e) ``MultiSliceCNNSIndex`` on a
    (2, 2) mesh equal, row for row, to a two-shard index; (f) a uint8
    index of ``u8_n`` rows (qshift 128) sharded gives ``CNNSIndex.search``'s
    distances (F-R9); then ``entry()`` and ``dryrun_multichip``. Prints the
    peak device memory of (a)-(e). Returns the scan's launches by kernel
    from (d) on and the tensor-core join's launches of (c)."""
    from hnsw_nsg_tpu_torch import entry as port_entry
    from hnsw_nsg_tpu_torch.models.cnns import build_cnns
    from hnsw_nsg_tpu_torch.models.knn_ivf import knn_graph_ivf
    from hnsw_nsg_tpu_torch.models.nsg import build_nsg
    from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops import merge_select as ms
    from hnsw_nsg_tpu_torch.parallel.mesh import (
        MultiSliceCNNSIndex, ShardedCNNSIndex, ShardedFlatIndex,
        ShardedGraphIndex, make_mesh, make_multislice_mesh,
        sharded_knn_build_step,
    )
    from hnsw_nsg_tpu_torch.utils.metrics import device_memory_stats
    from hnsw_nsg_tpu_torch.utils.params import CNNSConfig, NSGBuildConfig
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n, nq = x.shape[0], queries.shape[0]
    k = 10
    t_phase = time.perf_counter()
    mesh = make_mesh(SHARDS, devices=[device] * SHARDS)
    print(f"phase 9: a mesh of {mesh.shape} on {device} [{card}]")
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    qd = torch.from_numpy(queries).to(device)
    xd = torch.from_numpy(x).to(device)

    # (a) the sharded exact search
    ref_d, ref_i = brute_force_topk(qd, xd, k)
    fidx = ShardedFlatIndex.build(mesh, x)
    sync()
    t0 = time.perf_counter()
    fd, fi = fidx.search(qd, k)
    sync()
    f_s = time.perf_counter() - t0
    n_tie = flat_tie_mismatches(fd, fi, ref_d, ref_i)
    print(f"(a) ShardedFlatIndex: {n}x{x.shape[1]} over {SHARDS} shards, "
          f"{nq} queries at k={k} in {f_s:.3f} s; distances within rtol "
          f"1e-5 of brute_force_topk's, {n_tie} ids differ among ties "
          f"[{card}]")
    del fidx, fd, fi, ref_d, ref_i

    # (b) the distributed kNN-graph build step
    sync()
    t0 = time.perf_counter()
    adj = sharded_knn_build_step(mesh, x, k)
    sync()
    kb_s = time.perf_counter() - t0
    rows = np.random.default_rng(0).choice(n, min(10_000, n), replace=False)
    rec = exact_knn_recall(xd, adj, rows=rows)
    rt = torch.from_numpy(rows).to(device)
    got = ((xd[adj[rt].long()] - xd[rt][:, None]) ** 2).sum(-1)
    want, _ = brute_force_topk(xd[rt], xd, k + 1)
    want = want[:, 1:]              # the row itself first (distance 0)
    same = torch.allclose(torch.sort(got, 1).values, want, rtol=1e-4,
                          atol=1e-3)
    print(f"(b) sharded_knn_build_step k={k} over {n} rows: {kb_s:.2f} s, "
          f"recall on a {len(rows)}-row sample {rec:.6f}, its distances "
          f"{'equal' if same else 'NOT equal'} to the exact ones [{card}]")
    if not same or rec < 0.999:
        raise AssertionError(f"the sharded kNN build is not exact: recall "
                             f"{rec}")
    del adj, got, want

    # (c) graph shards: four row blocks, an NSG each. 1024 representatives
    # a shard, where the JAX package defaults to 32: the data are a mixture
    # of n / 2500 components, and an entry among 32 random rows misses the
    # query's component as NSG's single medoid does (~0.73 at l_search 256
    # at 1M, PERF.md), so most components get a representative
    m_rows = min(shard_rows, n // SHARDS)
    cut = SHARDS * m_rows
    datas, adjs, eps = [], [], []
    reset_counts(cs, ms)
    sync()
    t0 = time.perf_counter()
    for m in range(SHARDS):
        xs = xd[m * m_rows : (m + 1) * m_rows]
        knn = knn_graph_ivf(xs, 50, as_device=True)
        # blocks of 4096 nodes, as build_nsg takes from 2^18 rows: a
        # shard's 1024-node default would quadruple the host-bound block
        # loop, and no result depends on the block size
        nsg = build_nsg(xs, knn, NSGBuildConfig(), block=4096)
        datas.append(x[m * m_rows : (m + 1) * m_rows])
        adjs.append(nsg.adj.cpu().numpy())
        eps.append(nsg.ep)
        del knn, nsg
    sync()
    g_build = time.perf_counter() - t0
    join128 = cs.join_launches_by_kernel["join_mma_kernel"]
    launch_split(ms, "sharded graph build (4 NSGs)", tally)
    gidx = ShardedGraphIndex.build_from_shards(mesh, datas, adjs, eps,
                                               n_reps=SHARD_REPS)
    deg = np.mean([(a >= 0).sum(1).mean() for a in adjs])
    print(f"(c) ShardedGraphIndex: {SHARDS} shards of {m_rows} rows"
          + ("" if cut == n else f" (cut from {n // SHARDS})")
          + f", NSGs built in {g_build:.2f} s (kNN graphs k=50 + "
          f"NSGBuildConfig()), mean degree {deg:.3f}, {SHARD_REPS} "
          f"representatives a shard [{card}]")
    g_gt = gt if cut == n else brute_force_topk(qd, xd[:cut], k)[1].cpu()
    reset_counts(cs, ms)
    g_rec, g_ev = {}, {}
    for nprobe in (4, 2):
        for ls in (32, 64, 128):
            sync()
            t0 = time.perf_counter()
            dd, ii, ev = gidx.search(qd, k, l_search=ls, nprobe=nprobe)
            ii_h = ii.cpu()
            ms_ = (time.perf_counter() - t0) * 1e3
            g_rec[nprobe, ls] = recall(ii_h, g_gt)
            g_ev[nprobe, ls] = ev.cpu().tolist()
            print(f"  nprobe={nprobe} l_search={ls}: recall@10 "
                  f"{g_rec[nprobe, ls]:.4f}, {ms_:.1f} ms, evals by shard "
                  f"{g_ev[nprobe, ls]} [{card}]")
            if not bool(torch.isfinite(dd).all()) or int(ii_h.max()) >= cut:
                raise AssertionError("bad sharded graph result")
    (part_launches if on_card else launch_split)(
        ms, "sharded graph search", tally)
    reset_counts(cs, ms)
    if g_rec[4, 128] < TARGET_RECALL:
        raise AssertionError(f"sharded graph recall@10 {g_rec[4, 128]} < "
                             f"{TARGET_RECALL} at nprobe 4, l_search 128")
    for ls in (32, 64, 128):
        if sum(g_ev[2, ls]) >= sum(g_ev[4, ls]):
            raise AssertionError(f"nprobe 2 did not cost fewer evaluations "
                                 f"at l_search {ls}: {g_ev}")
    del gidx, datas, adjs

    # (d) the sharded CNNS index over phase 3's index
    one = ShardedCNNSIndex.build(make_mesh(1, devices=[device]), flat_idx)
    four = ShardedCNNSIndex.build(mesh, flat_idx)
    d1, i1, e1 = one.search(qd, k, nprobe=4, slots=4)
    d4, i4, e4 = four.search(qd, k, nprobe=4, slots=4)
    n_tie = tie_mismatches(d4, i4, d1, i1, boundary=True)
    print(f"(d) ShardedCNNSIndex over phase 3's index (C={flat_idx.n_real}, "
          f"f32 slabs), nprobe=4 with every probe kept: {SHARDS} shards "
          f"give one shard's distances exactly, {n_tie} ids differ among "
          f"ties; evaluations {int(e4.sum())} = {int(e1.sum())} [{card}]")
    if int(e4.sum()) != int(e1.sum()):
        raise AssertionError("four shards evaluated another count")
    for nprobe in (2, 4, 8):
        r1 = recall(one.search(qd, k, nprobe=nprobe)[1].cpu(), gt)
        sync()
        t0 = time.perf_counter()
        dd, ii, ev = four.search(qd, k, nprobe=nprobe)
        ii_h = ii.cpu()
        ms_ = (time.perf_counter() - t0) * 1e3
        r4 = recall(ii_h, gt)
        slots = min(nprobe, -(-nprobe // SHARDS) + 1)
        print(f"  nprobe={nprobe} (slots {slots}): recall@10 {r4:.4f} (one "
              f"shard {r1:.4f}), {ms_:.1f} ms, evals by shard "
              f"{ev.cpu().tolist()} [{card}]")
        if r4 < r1 - 0.03 or not bool(torch.isfinite(dd).all()):
            raise AssertionError(f"sharded CNNS recall {r4} against {r1}")
    del one

    # (e) the multi-slice layout against a two-shard index
    two = ShardedCNNSIndex.build(make_mesh(2, devices=[device] * 2),
                                 flat_idx)
    msi = MultiSliceCNNSIndex.build(
        make_multislice_mesh(2, devices=[device] * 4), flat_idx)
    dt, it, _ = two.search(qd, k, nprobe=4)
    dm, im, em = msi.search(qd, k, nprobe=4)
    if not (torch.equal(dt, dm) and torch.equal(it, im)):
        raise AssertionError("the multi-slice index differs from two shards")
    print(f"(e) MultiSliceCNNSIndex on a {msi.mesh.shape} mesh, nprobe=4: "
          f"equal to a two-shard index row for row; evals by slice and "
          f"shard {em.cpu().tolist()} [{card}]")
    scans = scan_counts(cs, "sharded CNNS (d) + (e)", device, routed=True)
    if on_card and (scans.get("scan_f32", 0) <= 0
                    or set(scans) - {"scan_f32", "scan_general_f32"}):
        raise AssertionError(f"the sharded CNNS ran other scans: {scans}")
    del two, msi, four, d1, d4, dd
    mem = device_memory_stats(device)
    print(f"(a)-(e) peak device memory {mem['peak_bytes_in_use'] / 1e9:.3f} "
          f"GB of {mem['bytes_limit'] / 1e9:.3f} [{card}]")
    del xd, qd
    if on_card:
        torch.cuda.empty_cache()

    # (f) F-R9: a uint8 index keeps its query transform when sharded
    xu, qu = make_data(u8_n, 128, 100, "l2", seed=0, uint8=True)
    uidx = build_cnns(xu, CNNSConfig(n_clusters=max(u8_n // 1024, 8), m=4,
                                     kmeans_iters=12),
                      slab_dtype=torch.int8, device=device)
    usharded = ShardedCNNSIndex.build(mesh, uidx)
    qud = torch.from_numpy(qu).to(device)
    for nprobe in (2, 4):
        wd, wi = uidx.search(qud, k, nprobe=nprobe)
        sd, si, _ = usharded.search(qud, k, nprobe=nprobe, slots=nprobe)
        n_tie = tie_mismatches(sd, si, wd, wi, boundary=True)
        print(f"(f) uint8 index ({u8_n} rows, qshift {uidx.qshift}, "
              f"qscale {uidx.qscale}) over {SHARDS} shards, nprobe="
              f"{nprobe}: CNNSIndex.search's distances exactly, {n_tie} ids "
              f"differ among ties [{card}]")
    del uidx, usharded, qud

    fn, args = port_entry.entry(device)
    ed, ei = fn(*args)
    if tuple(ed.shape) != (16, 32) or not bool(torch.isfinite(ed).all()):
        raise AssertionError(f"entry() gave {tuple(ed.shape)}")
    port_entry.dryrun_multichip(SHARDS, devices=[device] * SHARDS)
    launch_split(ms, "entry() and dryrun", tally)
    all_scans = scan_counts(cs, "phase 9 (d)-(f), entry() and dryrun", device)
    print(f"entry() and dryrun_multichip({SHARDS}) ran; phase 9: "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return all_scans, join128


# phase 10: the command line and the examples, each a process of its own
CLI_N, CLI_NQ = 200_000, 1000


def run_chains(chains, cwd, env, timeout=600):
    """Run each chain (a list of (name, argv)) in a thread of its own, the
    commands of a chain one after another as processes; every process is
    waited for (killed at ``timeout``). Returns {name: (rc, seconds,
    stdout, stderr)}."""
    import threading

    out, lock = {}, threading.Lock()

    def go(chain):
        for name, argv in chain:
            t0 = time.perf_counter()
            try:
                p = subprocess.run(argv, cwd=cwd, env=env, timeout=timeout,
                                   capture_output=True, text=True)
                rc, so, se = p.returncode, p.stdout, p.stderr
            except subprocess.TimeoutExpired as e:
                rc, so, se = 124, "", f"timed out: {e}"
            with lock:
                out[name] = (rc, time.perf_counter() - t0, so, se)
            if rc != 0:
                return

    threads = [threading.Thread(target=go, args=(c,)) for c in chains]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def phase_cli(card, x, queries, device=None, n=CLI_N, nq=CLI_NQ):
    """Phase 10: the first ``n`` rows, ``nq`` queries and their exact
    top-10 as fvecs/ivecs in a temporary directory, then
    ``python -m hnsw_nsg_tpu_torch.cli`` (the card by default, or
    ``--device``) in five chains run side by side: build-clusters ->
    build-nsg -> search-clusters (nsg locals, then flat locals: the
    artifacts' routing and slabs without the local graphs); build-knn
    --method ivf; build-hnsw ->
    search-hnsw; build-hybrid -> search-hybrid --accel; convert (fvecs ->
    bin -> fvecs, the same bytes) -> calculate-recall. Every rc must be 0;
    each command's seconds and reported recall are printed, and
    search-hnsw must reach recall@10 >= 0.9 at its largest ef. The eight
    examples of ``hnsw_nsg_tpu_torch/examples/`` run beside the chains,
    each with rc 0. Their kernel launches are their own processes' and
    are not in the kernels line."""
    import filecmp
    import os
    import tempfile

    from hnsw_nsg_tpu_torch.ops import brute_force_topk
    from hnsw_nsg_tpu_torch.utils import io

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    dev = [] if device is None else ["--device", device]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        base, qf, gtf = (os.path.join(tmp, f) for f in
                         ("base.fvecs", "query.fvecs", "gt.ivecs"))
        xb, qb = x[:n], queries[:nq]
        io.write_fvecs(base, xb)
        io.write_fvecs(qf, qb)
        tdev = device or "cuda"
        _, g = brute_force_topk(torch.from_numpy(qb).to(tdev),
                                torch.from_numpy(xb).to(tdev), 10)
        io.write_gt(gtf, g.cpu().numpy().astype(np.int32))
        io.write_ivecs(os.path.join(tmp, "res.ivecs"),
                       g.cpu().numpy().astype(np.int32))
        cli = [sys.executable, "-m", "hnsw_nsg_tpu_torch.cli"]
        pre = os.path.join(tmp, "artifacts")
        q_gt = [qf, "--gt", gtf, "--k", "10"]
        chains = [
            [("build-clusters", cli + ["build-clusters", base, "16", "4",
                                       "32", "40", "5", "10", "50", pre,
                                       "--kmeans-iters", "8"] + dev),
             ("build-nsg", cli + ["build-nsg", pre, "40", "32", "200"] + dev),
             ("search-clusters", cli + ["search-clusters", pre] + q_gt
              + ["--nprobe", "4", "--local", "nsg"] + dev),
             ("search-clusters flat", cli + ["search-clusters", pre] + q_gt
              + ["--nprobe", "4", "--local", "flat"] + dev)],
            [("build-knn", cli + ["build-knn", base,
                                  os.path.join(tmp, "knn.graph"), "50",
                                  "--method", "ivf"] + dev)],
            [("build-hnsw", cli + ["build-hnsw", base,
                                   os.path.join(tmp, "h.npz"), "--M", "16",
                                   "--efc", "100"] + dev),
             ("search-hnsw", cli + ["search-hnsw", os.path.join(tmp, "h.npz")]
              + q_gt + ["--efs", "16,32,64,128"] + dev)],
            [("build-hybrid", cli + ["build-hybrid", base,
                                     os.path.join(tmp, "hyb"), "--M", "16",
                                     "--efc", "40", "--L", "40", "--R", "32",
                                     "--C", "200"] + dev),
             ("search-hybrid", cli + ["search-hybrid",
                                      os.path.join(tmp, "hyb")] + q_gt
              + ["--search-ls", "32,64,128", "--accel"] + dev)],
            [("convert", cli + ["convert", base,
                                os.path.join(tmp, "base.bin")] + dev),
             ("convert back", cli + ["convert", os.path.join(tmp, "base.bin"),
                                     os.path.join(tmp, "back.fvecs")] + dev),
             ("calculate-recall", cli + ["calculate-recall",
                                         os.path.join(tmp, "res.ivecs"), gtf,
                                         "--k", "10"] + dev)],
        ]
        # the examples run beside the chains
        ex_dir = os.path.join(root, "hnsw_nsg_tpu_torch", "examples")
        names = sorted(f[:-3] for f in os.listdir(ex_dir)
                       if f.startswith("example_") and f.endswith(".py"))
        examples = [[(nm, [sys.executable, "-m",
                           f"hnsw_nsg_tpu_torch.examples.{nm}"]
                      + ([] if device is None else [device]))]
                    for nm in names]
        t0 = time.perf_counter()
        res = run_chains(chains + examples, root, env)
        wall = time.perf_counter() - t0
        for chain in chains:
            for name, _ in chain:
                rc, sec, so, se = res.get(name, (None, 0.0, "", "not run"))
                tail = so.strip().splitlines()[-1] if so.strip() else ""
                print(f"  cli {name}: rc {rc}, {sec:.1f} s; {tail} [{card}]")
                if rc != 0:
                    print(so[-2000:], se[-3000:])
                    raise AssertionError(f"cli {name} failed: rc {rc}")
        sweep = [l.split("\t") for l in res["search-hnsw"][2].splitlines()
                 if l[:1].isdigit()]
        r_hnsw = float(sweep[-1][1])
        r_hyb = [l.split("\t") for l in res["search-hybrid"][2].splitlines()
                 if l[:1].isdigit()]
        r_clu, r_flat = (json.loads(res[c][2].strip().splitlines()[-1])
                         for c in ("search-clusters", "search-clusters flat"))
        r_calc = json.loads(res["calculate-recall"][2].strip()
                            .splitlines()[-1])
        same = filecmp.cmp(base, os.path.join(tmp, "back.fvecs"),
                           shallow=False)
        print(f"cli on {n} rows, {nq} queries ({len(chains)} chains and "
              f"the examples side by side, {wall:.1f} s): search-clusters "
              f"recall@10 "
              f"{r_clu['recall']:.4f} (nsg locals; flat locals "
              f"{r_flat['recall']:.4f}), search-hnsw {r_hnsw:.4f} at ef "
              f"{sweep[-1][0]}, search-hybrid (records) {r_hyb[-1][1]} at "
              f"l_search {r_hyb[-1][0]}, calculate-recall "
              f"{r_calc['recall']}, convert round trip "
              f"{'byte-identical' if same else 'DIFFERENT'} [{card}]")
        if r_hnsw < 0.9 or not same or r_calc["recall"] != 1.0:
            raise AssertionError("the cli's results are wrong")

    for nm in names:
        rc, sec, so, se = res[nm]
        tail = so.strip().splitlines()[-1] if so.strip() else ""
        print(f"  {nm}: rc {rc}, {sec:.1f} s; {tail} [{card}]")
        if rc != 0:
            print(so[-2000:], se[-3000:])
            raise AssertionError(f"{nm} failed: rc {rc}")
    print(f"examples: {len(names)}, each rc 0; phase 10: "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    if len(names) != 8:
        raise AssertionError(f"{len(names)} examples, not 8")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from hnsw_nsg_tpu_torch.ops import _build
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    _build.load_library()
    print(f"kernel build: {_build.build_seconds:.2f} s "
          f"({_build.library_path().name})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("grouped scan kernels vs plain PyTorch version:")
    scan_err, scan_times = phase_kernels(gen)

    print("the flat router's kernel vs its plain version:")
    route_checks = phase_route(card)
    print("the per-query probe path's kernel vs its plain version:")
    probe_checks = phase_probe(card)

    sift_counts, f32_counts, flat_idx, probe_launches = phase_main_path(card)
    gist_counts, gist_times = phase_gist(card)
    u8_counts, u8_times, spill_in = phase_sift10m_u8(card)
    phase_spill(card, **spill_in)
    del spill_in
    torch.cuda.empty_cache()
    wide_counts, wide_times = phase_wide(card)

    print("merge_select and cluster_join kernels vs plain PyTorch versions:")
    ms_err, ms_times = phase_merge_select()
    join_err = phase_join_small()

    from hnsw_nsg_tpu_torch.ops import brute_force_topk
    from hnsw_nsg_tpu_torch.utils.synth import make_data

    t0 = time.perf_counter()
    x, queries = make_data(GRAPH_N, 128, 8192, "l2", seed=0)
    _, gt = brute_force_topk(torch.from_numpy(queries).cuda(),
                             torch.from_numpy(x).cuda(), 10, "l2")
    gt = gt.cpu()
    torch.cuda.empty_cache()
    print(f"graph phases' data: {GRAPH_N}x128 + 8192 queries and the f32 "
          f"ground truth in {time.perf_counter() - t0:.1f} s")
    # merge+select's launches on the main paths, by kernel (ms_kernel)
    tally = {"warp": 0, "warp, 32 slots": 0, "general": 0}
    hnsw_graph, h_rec, index5, ef5, recall5 = phase_hnsw(card, x, queries,
                                                          gt, tally)
    t0 = time.perf_counter()
    phase_range_churn(card, index5, x, queries, ef5, recall5, tally)
    print(f"phase 5c: {time.perf_counter() - t0:.1f} s")
    del index5
    torch.cuda.empty_cache()
    a_launches = phase_accel_insert(card, x, queries, tally)
    (j_launches, n_slabs, y_rec, j64_launches,
     f32_launches) = phase_hybrid(card, x, queries, gt, hnsw_graph, tally)
    nsg_scan = phase_cnns_nsg(card, x, queries, gt, flat_idx, tally)
    t0 = time.perf_counter()
    phase_small_n(card, x, queries, tally)
    print(f"phase 6c: {time.perf_counter() - t0:.1f} s")
    # phase 9 keeps phase 3's index for its sharded CNNS parts
    sh_scans, sh_join = phase_sharded(card, x, queries, gt, flat_idx, tally)
    j_launches += sh_join
    del flat_idx
    torch.cuda.empty_cache()
    phase_cli(card, x, queries)
    m_launches = sum(tally.values())
    print(f"merge_select launches over the HNSW, range search, churn, hybrid, "
          f"CNNS graph-local, small-N and sharded paths: "
          f"{m_launches}, by kernel "
          + ", ".join(f"{kern} {n} ({n / m_launches:.3%})"
                      for kern, n in tally.items())
          + f"; on the records paths: HNSW search {h_rec}, accel insert "
          f"{a_launches}, hybrid search {y_rec}")
    if min(tally.values()) <= 0:
        raise AssertionError(f"a merge_select kernel did not run on the "
                             f"main paths: {tally}")
    del x, queries
    builds = {(k, dt): phase_join_build(card, n_slabs, k=k, dtype=dt)
              for k, dt in ((52, torch.bfloat16), (102, torch.bfloat16),
                            (202, torch.bfloat16), (10, torch.float32),
                            (52, torch.float32), (102, torch.float32))}
    # (max |vals error|, kernel ms, plain ms, bound) of each
    j128, j64, jf32 = (builds[(102, torch.bfloat16)],
                       builds[(202, torch.bfloat16)],
                       builds[(52, torch.float32)])
    for (k, dt), b in builds.items():
        entry = join_entry(cs, 128, k, dt)
        join_err[entry] = max(join_err[entry], b[0])

    # no single PyTorch call computes any of the functions, so none has a
    # library time. The grouped scan's times: bf16 and f32 at the bench
    # shape at k = 20 and 200, SQ8 at gist1m's own scan call at k = 20 and
    # k = 200, int8 x int8 at sift10m_u8's own scan calls at k = 10 and
    # k = 100 (the search scans at its own k), the wide scans on phase
    # 3e's bf16 scan call at k = 10 and 100;
    # merge+select's at the NSG build's collect pool (L = 500), at L = 1024
    # for its 32-slot build (the ef = 1024 search's shape) and at L = 2048
    # for its general kernel (ef = 2048), the join's at the 1M build shape:
    # bf16 at k = 102 (128 rows a block; the k = 100 kNN graph's call) and
    # k = 202 (64 rows a block; the k = 200 graph's), f32 at k = 52
    def count(kern, *paths):
        return sum(p.get(kern, 0) for p in paths)

    def err(kern, *dtypes):
        return max(scan_err.get((kern, dt), 0.0) for dt in dtypes)

    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32

    def scan_entry(name, kern, launches, timing, err, replaces=REPLACES):
        if launches <= 0:
            raise AssertionError(f"{kern} was not launched on a main path")
        k_ms, p_ms, (b_ms, b_by) = timing
        return {"name": name, "route": "cuda", "source": PIPELINE_SOURCE,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    g20, g200 = gist_times["scan_mma"], gist_times["scan_general_mma"]
    kernels = [
        scan_entry("grouped_cluster_topk_gq (bf16 tensor cores, k <= 32: "
                   "scan_mma_kernel)", "scan_mma",
                   count("scan_mma", sift_counts, nsg_scan, sh_scans),
                   scan_times["main path bf16 l2 k=20"],
                   err("scan_mma", bf)),
        scan_entry("grouped_cluster_topk_gq (SQ8, int8 slab x bf16 query, "
                   "tensor cores, k <= 32: scan_mma_kernel)", "scan_mma",
                   gist_counts["scan_mma"], g20[1:],
                   max(g20[0], err("scan_mma", i8))),
        scan_entry("grouped_cluster_topk_gq (tensor cores, k > 32, bf16 and "
                   "SQ8: scan_general_mma_kernel)", "scan_general_mma",
                   count("scan_general_mma", sift_counts, gist_counts,
                         nsg_scan, sh_scans),
                   scan_times["main path bf16 l2 k=200"],
                   max(g200[0], err("scan_general_mma", bf, i8))),
        scan_entry("grouped_cluster_topk_gq (f32, exact FMAs on the ring "
                   "pipeline, k <= 32: scan_f32_kernel)", "scan_f32",
                   count("scan_f32", f32_counts, sh_scans),
                   scan_times["main path f32 l2 k=20"],
                   err("scan_f32", f32)),
        scan_entry("grouped_cluster_topk_gq (f32, exact FMAs on the ring "
                   "pipeline, k > 32: scan_general_f32_kernel)",
                   "scan_general_f32",
                   count("scan_general_f32", f32_counts, sh_scans),
                   scan_times["main path f32 l2 k=200"],
                   err("scan_general_f32", f32)),
        scan_entry("grouped_cluster_topk_gq (int8 x int8, s8 tensor cores, "
                   "k <= 32: scan_i8_kernel)", "scan_i8",
                   count("scan_i8", u8_counts, sh_scans), u8_times[10][1:],
                   err("scan_i8", i8)),
        scan_entry("grouped_cluster_topk_gq (int8 x int8, s8 tensor cores, "
                   "k > 32: scan_general_i8_kernel)", "scan_general_i8",
                   count("scan_general_i8", u8_counts, sh_scans),
                   u8_times[100][1:],
                   err("scan_general_i8", i8)),
        # past each pair's resident width, the query streamed through the
        # ring (phase 3e's d = 3072 bf16 and f32 indexes), timed on the
        # bf16 index's own scan call
        scan_entry("grouped_cluster_topk_gq_dblk's widths (query streamed "
                   "through the ring, k <= 32: scan_*_kernel<..., kStream>; "
                   "f32 past d = 960, a bf16 query past d = 1920, int8 x "
                   "int8 past d = 3840)", "scan_wide",
                   count("scan_wide", wide_counts, sift_counts, gist_counts,
                         f32_counts, u8_counts, nsg_scan, sh_scans),
                   wide_times["scan_wide"][1:],
                   max(wide_times["scan_wide"][0],
                       err("scan_wide", f32, i8, bf)),
                   replaces=WIDE_REPLACES),
        scan_entry("grouped_cluster_topk_gq_dblk's widths (query streamed "
                   "through the ring, k > 32: scan_general_*_kernel<..., "
                   "kStream>)", "scan_general_wide",
                   count("scan_general_wide", wide_counts, sift_counts,
                         gist_counts, f32_counts, u8_counts, nsg_scan,
                         sh_scans),
                   wide_times["scan_general_wide"][1:],
                   max(wide_times["scan_general_wide"][0],
                       err("scan_general_wide", f32, i8, bf)),
                   replaces=WIDE_REPLACES),
    ]
    print(f"gist1m SQ8 scan at k=200 (scan_general_mma_kernel): "
          f"{g200[1]:.4f} ms, plain {g200[2]:.4f} ms, bound {g200[3][0]:.4f} "
          f"ms ({g200[3][1]}) [{card}]")
    ms_ms, ms_plain, ms_bound, ms_by = ms_times["collect pool"]
    w_ms, w_plain, w_bound, w_by = ms_times["warp kernel L=1024"]
    g_ms, g_plain, g_bound, g_by = ms_times["general L=2048"]
    kernels += [{
        "name": "fused_merge_select (warp kernel: L <= 512, C <= 1024)",
        "route": "cuda",
        "source": "hnsw_nsg_tpu_torch/csrc/merge_select.cu",
        "replaces": "hnsw_nsg_tpu/ops/merge_select.py:92",
        "launches": tally["warp"], "max_abs_err": ms_err["warp"],
        "ms": ms_ms, "plain_ms": ms_plain, "bound_ms": ms_bound,
        "bound_by": ms_by, "library_ms": None,
    }, {
        "name": "fused_merge_select (warp kernel, 32 slots a lane: "
                "512 < L <= 1024)",
        "route": "cuda",
        "source": "hnsw_nsg_tpu_torch/csrc/merge_select.cu",
        "replaces": "hnsw_nsg_tpu/ops/merge_select.py:92",
        "launches": tally["warp, 32 slots"],
        "max_abs_err": ms_err["warp, 32 slots"],
        "ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound,
        "bound_by": w_by, "library_ms": None,
    }, {
        "name": "fused_merge_select (general kernel: L > 1024 or C > 1024)",
        "route": "cuda",
        "source": "hnsw_nsg_tpu_torch/csrc/merge_select.cu",
        "replaces": "hnsw_nsg_tpu/ops/merge_select.py:92",
        "launches": tally["general"], "max_abs_err": ms_err["general"],
        "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
        "bound_by": g_by, "library_ms": None,
    }, {
        "name": "cluster_join_topk (bf16 tensor cores, 128 rows a block: "
                "k <= 110)", "route": "cuda",
        "source": "hnsw_nsg_tpu_torch/csrc/cluster_join.cu",
        "replaces": "hnsw_nsg_tpu/ops/pallas_scan.py:98",
        "launches": j_launches, "max_abs_err": join_err[128],
        "ms": j128[1], "plain_ms": j128[2],
        "bound_ms": j128[3][0], "bound_by": j128[3][1], "library_ms": None,
    }, {
        "name": "cluster_join_topk (bf16 tensor cores, 64 rows a block: "
                "k > 110)", "route": "cuda",
        "source": "hnsw_nsg_tpu_torch/csrc/cluster_join.cu",
        "replaces": "hnsw_nsg_tpu/ops/pallas_scan.py:98",
        "launches": j64_launches, "max_abs_err": join_err[64],
        "ms": j64[1], "plain_ms": j64[2],
        "bound_ms": j64[3][0], "bound_by": j64[3][1], "library_ms": None,
    }, {
        "name": "cluster_join_topk (f32 CUDA cores: join_f32_kernel)",
        "route": "cuda",
        "source": "hnsw_nsg_tpu_torch/csrc/cluster_join.cu",
        "replaces": "hnsw_nsg_tpu/ops/pallas_scan.py:98",
        "launches": f32_launches, "max_abs_err": join_err["f32"],
        "ms": jf32[1], "plain_ms": jf32[2],
        "bound_ms": jf32[3][0], "bound_by": jf32[3][1], "library_ms": None,
    }]
    # the flat router: timed at the sift1m cells' call (nprobe 2), its
    # error the largest over ROUTE_CASES; launches over every main path
    route_tally()
    if min(ROUTE_LAUNCHES["route_topk"], ROUTE_LAUNCHES["route_merge"]) <= 0:
        raise AssertionError(f"a route kernel did not run on the main "
                             f"paths: {dict(ROUTE_LAUNCHES)}")
    rc = route_checks["sift1m nprobe 2"]
    r_err = max(r["err"] for r in route_checks.values())
    kernels += [{
        "name": "route_topk (flat router: bf16 tensor cores, the "
                "top-n_rep in the epilogue: route_topk_kernel)",
        "route": "cuda", "source": ROUTE_SOURCE,
        "replaces": "hnsw_nsg_tpu/models/cnns.py:79",
        "launches": ROUTE_LAUNCHES["route_topk"], "max_abs_err": r_err,
        "ms": rc["topk_ms"], "plain_ms": rc["plain_ms"],
        "bound_ms": rc["bound"][0], "bound_by": rc["bound"][1],
        "library_ms": None,
    }, {
        "name": "route_topk (the column splits' lists merged: "
                "route_merge_kernel)",
        "route": "cuda", "source": ROUTE_SOURCE,
        "replaces": "hnsw_nsg_tpu/models/cnns.py:79",
        "launches": ROUTE_LAUNCHES["route_merge"], "max_abs_err": r_err,
        "ms": rc["merge_ms"], "plain_ms": None,
        "bound_ms": rc["merge_bound"][0], "bound_by": rc["merge_bound"][1],
        "library_ms": None,
    }]
    # the per-query path: timed at the dbpedia batch512 cell's call; its
    # launches those of phase 3's batch512 call
    if min(probe_launches.get("probe_scan", 0),
           probe_launches.get("probe_merge", 0)) <= 0:
        raise AssertionError(f"a probe kernel did not run on the main "
                             f"path: {probe_launches}")
    pc = probe_checks["dbpedia batch512"]
    p_err = max(r["err"] for r in probe_checks.values())
    kernels += [{
        "name": "probe_topk (per-query probe path, bf16 slabs scored in "
                "place: probe_scan_kernel)",
        "route": "cuda", "source": PROBE_SOURCE,
        "replaces": "hnsw_nsg_tpu/models/cnns.py:170",
        "launches": probe_launches["probe_scan"], "max_abs_err": p_err,
        "ms": pc["scan_ms"], "plain_ms": pc["plain_ms"],
        "bound_ms": pc["bound"][0], "bound_by": pc["bound"][1],
        "library_ms": None,
    }, {
        "name": "probe_topk (each query's item lists merged: "
                "probe_merge_kernel)",
        "route": "cuda", "source": PROBE_SOURCE,
        "replaces": "hnsw_nsg_tpu/models/cnns.py:170",
        "launches": probe_launches["probe_merge"], "max_abs_err": p_err,
        "ms": pc["merge_ms"], "plain_ms": None, "bound_ms": None,
        "bound_by": None, "library_ms": None,
    }]
    print(f"route launches on the main paths: {dict(ROUTE_LAUNCHES)}; "
          f"sift1m nprobe 2: the call {rc['ms']:.4f} ms against plain "
          f"{rc['plain_ms']:.4f} ms [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
