"""probe_stall_ms: device-idle milliseconds a request charged to the
program's ``cnns.probe`` span (``_flat_probe_search``, the per-query
path: a launch train a probe slot; ``annbench/stalls.py``)."""

from annbench import stalls


def read(r, records):
    return stalls.stall_ms(r, "cnns.probe")
