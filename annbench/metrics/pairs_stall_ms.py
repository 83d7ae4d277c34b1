"""pairs_stall_ms: device-idle milliseconds a request charged to the
program's ``cnns.pairs`` span (each call of ``_grouped_probe_search``:
the pair inversion, the grouped scan's launch, the route-back, the spill
path with its ``nonzero`` and the merge; ``annbench/stalls.py``)."""

from annbench import stalls


def read(r, records):
    return stalls.stall_ms(r, "cnns.pairs")
