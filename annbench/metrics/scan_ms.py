"""scan_ms: device milliseconds a request of the grouped scan kernels,
found by name (``scan_*_kernel``: ``csrc/grouped_scan*.cu`` on
``scan_pipeline.cuh``). Nothing to read where the request takes the
per-query path."""

KERNEL = r"^scan_\w*kernel$"


def read(r, records):
    t = r.device_s(KERNEL)
    return 1e3 * t / r.requests if t > 0 else None
