"""Device times of the port's merge+select and bf16 grouped-scan kernels
for one source tree, on one CUDA card.

    python3 scripts/time_port_kernels.py [--tree DIR]

``--tree`` is the root of a checkout of this repository (default: the one
this script is in) whose ``hnsw_nsg_tpu_torch`` is built and timed. The
inputs, their seeds, the repetitions and the timer (``cuda_ms``: CUDA
events around one launch queued behind a device sleep) are those of this
checkout's ``chip_smoke.py``, so two checkouts can be timed one after the
other on one card with the method and the shapes of ``chip_smoke.py``'s
own lines. Prints one JSON line per shape.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
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
    # chip_smoke.phase_merge_select's first four cases, with its seeds
    for i, (q, l, c, expand) in enumerate((
            (8192, 100, 50, 1), (4096, 500, 50, 1), (4096, 40, 50, 1),
            (8192, 64, 120, 4))):
        state = smoke.merge_state(100 + i, q, l, c, expand)
        t = smoke.cuda_ms(lambda: ms.fused_merge_select(*state, expand),
                          reps=50, warmup=5)
        print(json.dumps(dict(kernel="fused_merge_select", tree=args.tree,
                              Q=q, L=l, C=c, expand=expand, ms=t, card=card)))
    # chip_smoke.phase_kernels' first two cases from its generator, then
    # its d=960 shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b = smoke.BENCH
    bf = torch.bfloat16
    for name, c, maxc, d, cap, qn, k in (
            ("bench", b["c"], b["maxc"], b["d"], b["cap"], b["qn"], 10),
            ("main path", b["c"], b["maxc"], b["d"], b["cap"], b["qn"], 20),
            ("d=960", 128, 1024, 960, 32, 2048, 10)):
        qc, qidx, slabs, bias, scale = smoke.make_case(
            gen, c, maxc, d, cap, qn, bf, bf, "l2")
        t = smoke.cuda_ms(lambda: cs.grouped_cluster_topk_gq(
            qc, qidx, slabs, bias, k, scale), reps=10)
        print(json.dumps(dict(kernel="grouped_cluster_topk_gq bf16",
                              tree=args.tree, shape=name, C=c, maxc=maxc,
                              d=d, cap=cap, k=k, ms=t, card=card)))
        del qc, qidx, slabs, bias
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
