"""spill_pairs: (query, probe) pairs a request that the grouped path
found past their cluster list's capacity, from the program's own count
(``models.cnns.pair_counts["spilled"]``); the note gives the share of
all its pairs (``["pairs"]``). Read from ``record`` copies of the counts
at each call of ``_grouped_probe_search`` (``annbench/stalls.py``)."""

from annbench import stalls

WRAP = [("hnsw_nsg_tpu_torch.models.cnns", "_grouped_probe_search")]


def record(args, kwargs):
    return stalls.pair_snapshot()


def read(r, records):
    spilled = stalls.pairs_per_request(r, records, "spilled")
    if spilled is None:
        return None
    pairs = stalls.pairs_per_request(r, records, "pairs")
    share = 100.0 * spilled / pairs if pairs else 0.0
    return spilled, f"of {pairs:.0f} pairs a request ({share:.4f}%)"
