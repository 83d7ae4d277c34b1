"""One run of one cell: set-up, the measured window, the reference's
check of what the window returned, and the result.

Set-up draws the rows and the query pool on the device from the seed,
copies the rows to the host (``build_cnns`` takes a host array), builds
the index and sends the warm-up requests; ``setup_s`` runs from the
start of the process to the start of the window. The window is a closed
loop of one client: each request is one call of the system's ``search``
that ends with its ids copied to the host, and the next is issued then.
After the window the peak device memory is read, the index is freed, and
the reference draws the rows again, finds the exact neighbours of the
pool and judges the answers (``checks.py``).
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

from annbench import checks, datagen, spec, traffic, tracing

# answers whose distances are kept for the distance check: requests, and
# query rows drawn from them in all
KEEP_REQUESTS = 32
SAMPLE_ROWS = 4096


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _percentile(values, p: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), p))


def _read_layers(cell: spec.Cell, mods: dict, wrap: tracing.Wrapping,
                 reading: tracing.Reading) -> dict:
    """The cell's per-layer metrics that found something to read; each
    one left out says why on standard error."""
    out = {}
    for m in cell.per_layer:
        name = m["name"]
        if name in wrap.missing:
            _log(f"{name}: not reported: {wrap.missing[name]}")
            continue
        got = mods[name].read(reading, wrap.records.get(name, []))
        note = None
        if isinstance(got, tuple):
            got, note = got
        if got is None:
            _log(f"{name}: nothing to read in this cell")
            continue
        out[name] = {"value": float(got), "unit": m["unit"]}
        _log(f"{name} = {got!r} {m['unit']}" + (f" ({note})" if note else ""))
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, system=None) -> dict:
    """The result of one run (the contract's keys, ``checks`` last).
    ``system`` (``build``, ``search``, ``counters``) replaces the
    configuration's system: the control puts the reference in its place,
    and the fault tests break the timed path underneath."""
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    if system is None:
        system = spec.load_module("systems", cfg["system"])
    reference = spec.load_module("references", cfg["reference"])
    n, d, pool, metric = (int(cfg["n"]), int(cfg["d"]), int(cfg["pool"]),
                          cfg["metric"])
    k = int(tr["k"])
    search = system.search

    # ---- set-up
    x, q_pool = datagen.mixture(cfg["data"], n, d, pool, seed, device)
    x_host = x.cpu().numpy()
    del x
    batch_rows = traffic.batches(tr, pool, seed, device)
    q_batches = [q_pool[r].contiguous() for r in batch_rows]
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    index, build_info = system.build(x_host, cfg, device)
    del x_host
    for r in range(max(1, int(tr["warmup_requests"]))):
        dd, ii = search(index, q_batches[r % len(q_batches)], k, cfg)
        ii.cpu()
    # the window keeps the distances of up to KEEP_REQUESTS requests: let
    # the allocator hold their blocks before it starts
    spare = [torch.empty_like(dd) for _ in range(KEEP_REQUESTS + 1)]
    del dd, ii, spare
    _sync(device)
    # the set-up's objects out of the collector's way, so that its passes
    # in the window walk only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s: {build_info}")

    # ---- the window
    answers = checks.Answers(seed, KEEP_REQUESTS)
    lat: list[float] = []

    def one(r: int) -> None:
        j = r % len(q_batches)
        t0 = time.perf_counter()
        dd, ii = search(index, q_batches[j], k, cfg)
        ids = ii.cpu()
        lat.append(time.perf_counter() - t0)
        answers.add(j, ids, dd)

    if not trace:
        t0 = time.perf_counter()
        t_end = t0 + seconds
        r = 0
        while r == 0 or time.perf_counter() < t_end:
            one(r)
            r += 1
        window_s = time.perf_counter() - t0
    else:
        mods = {m["name"]: spec.load_module("metrics", m["name"])
                for m in cell.per_layer}
        wrap = tracing.Wrapping(mods)
        wrap.install()

        def traced() -> None:
            for r in range(int(tr["trace_requests"])):
                with torch.profiler.record_function(tracing.REQUEST):
                    one(r)

        try:
            events = tracing.profile(traced)
        finally:
            wrap.remove()
    _sync(device)
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    queries = sum(int(a.shape[0]) for a in answers.ids)
    if trace:
        reading = tracing.Reading(events, len(answers), build_info)
        del events
        per_layer = _read_layers(cell, mods, wrap, reading)
        _log(f"scan launches by kernel in the run: {system.counters()}")

    # ---- the reference, once the program's state is freed
    del index
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    x, q_again = datagen.mixture(cfg["data"], n, d, pool, seed, device)
    if not torch.equal(q_again, q_pool):
        raise RuntimeError("the generator did not repeat its queries")
    del q_again
    gt = reference.topk(x, q_pool, k, metric)
    found, pads = checks.evaluate(
        answers, batch_rows, q_pool, x, gt, k, metric, cfg["checks"],
        SAMPLE_ROWS, seed, reference)
    correct = checks.passed(found)
    _log(f"reference and checks {time.perf_counter() - t_ref:.3f} s over "
         f"{len(answers)} requests, {queries} queries; padding ids "
         f"returned: {pads}")

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": queries, "failed": 0}
    if trace:
        device_info["busy_s"] = reading.busy_s
        device_info["window_s"] = reading.window_s
        result["metrics"] = per_layer
        result["device"] = device_info
        result["breakdown"] = {"device_ops": reading.top_device_ops(),
                               "idle_gaps": reading.idle_gaps()}
    else:
        lat_ms = [t * 1e3 for t in lat]
        values = {"qps": queries / window_s,
                  "p95_ms": _percentile(lat_ms, 95.0),
                  "recall_at_k": found["recall_at_k"]["value"],
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_info
        _log(f"window {window_s:.3f} s, {len(lat)} requests, median "
             f"{statistics.median(lat_ms):.4f} ms, p95 "
             f"{values['p95_ms']:.4f} ms, max {max(lat_ms):.4f} ms")
    result["checks"] = found
    return result
