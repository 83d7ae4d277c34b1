"""Where the f32 and int8 x int8 scans' product warps spend their cycles,
on one CUDA card.

    python3 scripts/scan_clocks.py [--tree DIR]

Copies the package of ``--tree`` (a checkout of this repository; default:
the one this script is in) into a temporary directory and adds ``clock64``
counters to ``scan_products`` in its ``csrc/scan_pipeline.cuh``: for each
d chunk, the cycles a product warp spends waiting on the ring and the
product warps' barrier, forming its sums, and in the epilogue that hands
a tile's distances on (with its barriers with the top-k warps), summed
over the product warps of one dtype pair's kernels (each pair's file
keeps counters of its own). The copy builds with the tree's own
``_build``; nothing else changes. Then it runs the f32 scan, and the int8
x int8 scan where the tree has it (``csrc/grouped_scan_i8.cu``), at
``chip_smoke.BENCH`` (k = 10, 20 and 200) and at d=960 (C=128,
maxc=1024, k=10) on ``chip_smoke.make_case`` inputs, five launches each,
and prints one JSON line a shape: the cycles of each phase per product
warp and d chunk, each phase's share, and the launch's time with the
counters on (they cost a few percent).
"""

import argparse
import ctypes
import importlib.util
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (anchor, replacement) edits of scan_pipeline.cuh
EDITS = [
    ("namespace {\n\nconstexpr int kRows",
     "namespace {\n\n__device__ unsigned long long g_clk[6];\n\n"
     "constexpr int kRows"),
    ("""  int t = 0, dc = 0, stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRing - 2>();
    product_warps_sync();
    issue();
""", """  int t = 0, dc = 0, stage = 0;
  unsigned long long c_wait = 0, c_prod = 0, c_epi = 0;
  const unsigned long long c_start = clock64();
  for (int s = 0; s < steps; ++s) {
    const unsigned long long c0 = clock64();
    cp_async_wait<kRing - 2>();
    product_warps_sync();
    issue();
    const unsigned long long c1 = clock64();
    c_wait += c1 - c0;
"""),
    ("""    if (dc == n_dc - 1) {
      // Accumulator entry j of tile (mi, ni)""",
     """    const unsigned long long c2 = clock64();
    c_prod += c2 - c1;
    if (dc == n_dc - 1) {
      // Accumulator entry j of tile (mi, ni)"""),
    ("""    if (++dc == n_dc) {""",
     """    c_epi += clock64() - c2;
    if (++dc == n_dc) {"""),
    ("""    stage = stage == kRing - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}""", """    stage = stage == kRing - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  if (lane == 0) {
    atomicAdd(&g_clk[0], c_wait);
    atomicAdd(&g_clk[1], c_prod);
    atomicAdd(&g_clk[2], c_epi);
    atomicAdd(&g_clk[3], clock64() - c_start);
    atomicAdd(&g_clk[4], 1ull);
    atomicAdd(&g_clk[5], static_cast<unsigned long long>(steps));
  }
}"""),
]
# read and clear the counters of one pair's file
ACCESSOR = """
extern "C" int scan_clocks_{pair}(unsigned long long* out) {{
  cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  const unsigned long long zero[6] = {{0, 0, 0, 0, 0, 0}};
  return static_cast<int>(cudaMemcpyToSymbol(g_clk, zero, sizeof(zero)));
}}
"""
# the pairs counted: (name, the file of its instantiations)
PAIRS = (("f32", "grouped_scan_f32.cu"), ("i8", "grouped_scan_i8.cu"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    tmp = Path(tempfile.mkdtemp())
    try:
        pkg = tmp / "hnsw_nsg_tpu_torch"
        shutil.copytree(Path(args.tree) / "hnsw_nsg_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        src = pkg / "csrc" / "scan_pipeline.cuh"
        text = src.read_text()
        for anchor, new in EDITS:
            if text.count(anchor) != 1:
                raise SystemExit(f"anchor not found once: {anchor[:60]!r}")
            text = text.replace(anchor, new)
        src.write_text(text)
        pairs = []
        for pair, name in PAIRS:
            f = pkg / "csrc" / name
            if f.exists():
                f.write_text(f.read_text() + ACCESSOR.format(pair=pair))
                pairs.append(pair)
        run(tmp, pairs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(tree: Path, pairs):
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from hnsw_nsg_tpu_torch.ops import cluster_scan as cs
    from hnsw_nsg_tpu_torch.ops._build import load_library

    lib = load_library()
    clk = (ctypes.c_ulonglong * 6)()
    card = smoke.card_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b = smoke.BENCH
    dtypes = {"f32": torch.float32, "i8": torch.int8}
    for pair, name, (c, maxc, d, cap, qn), ks in (
            (pair, name, shape, ks) for pair in pairs
            for name, shape, ks in (
                ("bench", (b["c"], b["maxc"], b["d"], b["cap"], b["qn"]),
                 (10, 20, 200)),
                ("d=960", (128, 1024, 960, 32, 2048), (10,)))):
        dt = dtypes[pair]
        counters = getattr(lib, f"scan_clocks_{pair}")
        qc, qidx, slabs, bias, scale = smoke.make_case(
            gen, c, maxc, d, cap, qn, dt, dt, "l2")
        for k in ks:
            cs.grouped_cluster_topk_gq(qc, qidx, slabs, bias, k, scale)
            torch.cuda.synchronize()
            counters(clk)   # clear
            ms = smoke.cuda_ms(lambda: cs.grouped_cluster_topk_gq(
                qc, qidx, slabs, bias, k, scale), reps=5, warmup=0)
            counters(clk)
            wait, prod, epi, total, warps, steps = list(clk)
            print(json.dumps(dict(
                shape=name, k=k, kernel=cs.scan_kernel(dt, dt, d, k),
                ms_with_counters=ms, product_warps=warps,
                chunks_per_warp=steps / warps,
                wait_cycles=wait / steps, product_cycles=prod / steps,
                epilogue_cycles=epi / steps, share_wait=wait / total,
                share_products=prod / total, share_epilogue=epi / total,
                card=card)), flush=True)
        del qc, qidx, slabs, bias
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
