"""route_ms: device milliseconds a request spends under the CNNS router,
``models/cnns.py`` ``_route_clusters`` (the GEMM over every
representative, the stable sort of its columns, ``_rank_rep_hits``)."""

WRAP = [("hnsw_nsg_tpu_torch.models.cnns", "_route_clusters")]


def read(r, records):
    s = r.span_device_s("hnsw_nsg_tpu_torch.models.cnns._route_clusters")
    return 1e3 * sum(s) / r.requests if sum(s) > 0 else None
