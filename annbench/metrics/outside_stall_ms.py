"""outside_stall_ms: device-idle milliseconds a request while the host is
outside every program span, between two ``CNNSIndex.search`` calls: the
client's copy of the ids, its bookkeeping, the start of the next call
(``annbench/stalls.py``). The note gives the whole split of the idle."""

from annbench import stalls


def read(r, records):
    return stalls.stall_ms(r, stalls.OUTSIDE)
