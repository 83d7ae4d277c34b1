"""dedup_ms: device milliseconds a request under the program's
``cnns.dedup`` span (``dedup_topk`` in ``CNNSIndex.search``: the
pairwise id compare of the 2k candidates of a replicated index and its
top-k)."""


def read(r, records):
    s = r.span_device_s("cnns.dedup")
    return 1e3 * sum(s) / r.requests if sum(s) > 0 else None
