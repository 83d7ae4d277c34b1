"""Device times of the general scan kernels against the heap scan
kernels at a k that both take, on one CUDA card.

    python3 scripts/time_general_kernels.py

The wrapper picks a general kernel only above k = 32
(``cluster_scan.scan_kernel``): scan_general_mma beside scan_mma for a
bf16 query with a bf16 or int8 slab, scan_general_i8 beside scan_i8
for int8 x int8, scan_general_f32 beside scan_f32 for f32. This script
calls both entry points of the library on the same inputs at a k the
heap kernels take: the scan at
chip_smoke.py's bench shape (C=1152, maxc=2056, d=128, cap=32) for every
dtype pair at k = 10 and 32. Inputs, seeds and the timer (``cuda_ms``)
are chip_smoke.py's. Each shape prints one JSON line: whether the two
kernels' outputs are equal on the rows that carry a result (each pair
shares its products and rounding, so they should be), both times, and
the card's name and power limit.
"""

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    sys.path.insert(0, str(ROOT))
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
    card = smoke.card_line()
    stream = torch.cuda.current_stream().cuda_stream

    def run(entry, ptrs, shape, out_shape, general):
        vals = torch.empty(out_shape, dtype=torch.float32, device="cuda")
        idx = torch.empty(out_shape, dtype=torch.int32, device="cuda")
        args = (*ptrs, vals.data_ptr(), idx.data_ptr())
        rc = entry(*args, None, *shape) if general else entry(*args, *shape)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return vals, idx

    def compare(kernel, fast, general, fast_args, gen_args, live, **info):
        """live [rows]: the output rows that carry a result."""
        fv, fi = run(fast, *fast_args, False)
        gv, gi = run(general, *gen_args, True)
        torch.cuda.synchronize()
        fv, fi, gv, gi = (t[live] for t in (fv, fi, gv, gi))
        fin = torch.isfinite(fv)
        equal = bool(torch.equal(fv, gv) and torch.equal(fi[fin], gi[fin]))
        f_ms = smoke.cuda_ms(lambda: run(fast, *fast_args, False), reps=5)
        g_ms = smoke.cuda_ms(lambda: run(general, *gen_args, True), reps=5)
        print(json.dumps(dict(kernel=kernel, **info, outputs_equal=equal,
                              fast_ms=f_ms, general_ms=g_ms,
                              general_over_fast=g_ms / f_ms, card=card)))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b = smoke.BENCH
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for qdt, sdt in ((f32, f32), (i8, i8), (bf, i8), (bf, bf)):
        qc, qidx, slabs, bias, scale = smoke.make_case(
            gen, b["c"], b["maxc"], b["d"], b["cap"], b["qn"], qdt, sdt,
            "l2")
        for k in (10, 32):
            codes = (cs._DTYPE_CODE[qdt], cs._DTYPE_CODE[sdt])
            if lib.grouped_scan_general_scratch(b["c"], b["cap"], b["d"], k,
                                                *codes):
                raise AssertionError("the scan's buffers left shared memory")
            ptrs = (qc.data_ptr(), qidx.data_ptr(), slabs.data_ptr(),
                    bias.data_ptr())
            shape = (b["c"], b["cap"], b["qn"], b["d"], b["maxc"], k,
                     float(scale), cs._DTYPE_CODE[qdt], cs._DTYPE_CODE[sdt],
                     stream)
            out = (b["c"], b["cap"], k)
            compare("grouped_scan", lib.grouped_scan, lib.grouped_scan_general,
                    (ptrs, shape, out), (ptrs, shape, out), qidx >= 0,
                    pair=f"{qdt}x{sdt}".replace("torch.", ""), k=k,
                    fast_kernel=cs.scan_kernel(qdt, sdt, b["d"], k),
                    general_kernel=cs.scan_kernel(qdt, sdt, b["d"],
                                                  cs.MAX_K + 1))
        del qc, qidx, slabs, bias
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
