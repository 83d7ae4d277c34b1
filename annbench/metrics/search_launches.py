"""search_launches: device operations (kernels, copies, sets) a request
launched under the program's ``cnns.search`` span, matched to their
launches by correlation (``annbench/stalls.py``). The note splits them
by the spans inside it."""

from annbench import stalls


def read(r, records):
    n = stalls.launches(r, stalls.SEARCH)
    if not r.device or not n:
        return None
    note = "a request: " + ", ".join(
        f"{lab} {sum(stalls.launches(r, lab)) / r.requests:.1f}"
        for lab in stalls.SPANS[1:])
    return sum(n) / r.requests, note
