"""probe_ms: device milliseconds a request under ``models/cnns.py``
``_flat_probe_search``, the per-query path: each query gathers its
probed slabs one probe slot at a time, a batched product and a running
top-k merge."""

WRAP = [("hnsw_nsg_tpu_torch.models.cnns", "_flat_probe_search")]


def read(r, records):
    s = r.span_device_s("hnsw_nsg_tpu_torch.models.cnns._flat_probe_search")
    return 1e3 * sum(s) / r.requests if sum(s) > 0 else None
