"""scan_roofline: the grouped scan kernels' share of their roofline, in
percent: the least time of each call (``annbench/roofline.py``'s
``scan_bound`` of that call's own inputs: its live query rows and the
slabs they probe) summed over the calls, over the kernels' device time.
The note says whether bytes or operations bound the calls."""

import torch

from annbench.roofline import scan_bound

WRAP = [("hnsw_nsg_tpu_torch.models.cnns", "grouped_cluster_topk_gq")]
KERNEL = r"^scan_\w*kernel$"
LABEL = "hnsw_nsg_tpu_torch.models.cnns.grouped_cluster_topk_gq"


def record(args, kwargs):
    # the live rows and probed slabs stay on the card until the window
    # is over: two small reductions, no sync, and the lists themselves
    # are not held (holding them would make the allocator grow)
    qc, qidx, slabs = args[0], args[1], args[2]
    k = args[4] if len(args) > 4 else kwargs["k"]
    live = qidx >= 0
    return {"qn": qc.shape[0], "d": qc.shape[1], "c": qidx.shape[0],
            "cap": qidx.shape[1], "maxc": slabs.shape[1], "k": int(k),
            "q_dtype": str(qc.dtype).replace("torch.", ""),
            "s_dtype": str(slabs.dtype).replace("torch.", ""),
            "counts": torch.stack([live.sum(), live.any(1).sum()])}


def read(r, records):
    times = r.span_device_s(LABEL, KERNEL)
    if not times or len(times) != len(records) or sum(times) <= 0:
        return None
    least, kinds = 0.0, set()
    for t, rec in zip(times, records):
        live_rows, probed = (int(v) for v in rec["counts"].tolist())
        s, kind = scan_bound(rec["qn"], rec["d"], rec["c"], rec["cap"],
                             rec["maxc"], rec["k"], live_rows, probed,
                             rec["q_dtype"], rec["s_dtype"])
        least += s
        kinds.add(kind)
    note = "bound by " + " and ".join(sorted(kinds))
    return 100.0 * least / sum(times), note
