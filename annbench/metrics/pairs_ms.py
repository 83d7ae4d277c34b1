"""pairs_ms: device milliseconds a request under
``models/cnns.py`` ``_grouped_probe_search`` less its scan kernels: the
pair inversion, the route-back of each list's results, the spill path
and the cross-cluster merge."""

WRAP = [("hnsw_nsg_tpu_torch.models.cnns", "_grouped_probe_search")]
KERNEL = r"^scan_\w*kernel$"
LABEL = "hnsw_nsg_tpu_torch.models.cnns._grouped_probe_search"


def read(r, records):
    whole = r.span_device_s(LABEL)
    if sum(whole) <= 0:
        return None
    scan = r.span_device_s(LABEL, KERNEL)
    return 1e3 * (sum(whole) - sum(scan)) / r.requests
