"""dropped_pairs: spilled pairs a request past the spill path's
``sp_budget``, which the grouped path leaves out of the result (the -1
padding of a short row), from the program's own count
(``models.cnns.pair_counts["dropped"]``), read as ``spill_pairs`` reads
its count (``annbench/stalls.py``)."""

from annbench import stalls

WRAP = [("hnsw_nsg_tpu_torch.models.cnns", "_grouped_probe_search")]


def record(args, kwargs):
    return stalls.pair_snapshot()


def read(r, records):
    return stalls.pairs_per_request(r, records, "dropped")
