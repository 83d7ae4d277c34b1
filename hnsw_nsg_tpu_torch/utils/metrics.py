"""Timers, memory probes and profiler hooks (counterpart of
hnsw_nsg_tpu/utils/metrics.py).

The reference's observability is homemade (SURVEY.md §5.1): a microsecond
``StopW`` stopwatch (hnswlib/tests/cpp/sift_1m.cpp:13-30), RSS probes
(hnsw_nsg/tests/test_hnsw_nsg_search.cpp:70-144) and atomic
``metric_hops`` / ``metric_distance_computations`` counters
(hnswalg.h:65-66). Here: ``StopW`` (host wall clock; ``timed`` can wait
for the devices of given tensors), ``device_memory_stats`` (device memory
residency, the RSS analogue, from ``torch.cuda``), ``trace`` around
``torch.profiler`` and ``span``, the program's named stages inside such a
trace. Search counters live on ``BeamResult`` and the indexes'
``metric_*`` fields.
"""

from __future__ import annotations

import contextlib
import time

import torch


class StopW:
    """sift_1m.cpp's StopW: a microsecond stopwatch."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def micros(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def seconds(self) -> float:
        return time.perf_counter() - self._t0


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


@contextlib.contextmanager
def timed(sync=None):
    """Context manager yielding a StopW whose ``elapsed`` is set on exit.
    ``sync``: a tensor, or a list, tuple or dict holding tensors; the
    device of each CUDA tensor is synchronized before the clock stops, so
    queued device work is included."""
    w = StopW()
    yield w
    if sync is not None:
        for dev in {t.device for t in _tensors(sync) if t.is_cuda}:
            torch.cuda.synchronize(dev)
    w.elapsed = w.seconds()


def device_memory_stats(device=None) -> dict:
    """Device memory of a card (default: the current one), the
    getCurrentRSS analogue: bytes held by live tensors, their peak since
    the last ``torch.cuda.reset_peak_memory_stats`` and the card's total.
    -1 for each where there is no card (``device="cpu"`` or none
    visible), as the JAX package reports a device without statistics."""
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or (
            not torch.cuda.is_available()):
        return {"bytes_in_use": -1, "peak_bytes_in_use": -1,
                "bytes_limit": -1}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the block as the stage ``name`` in a
    running ``torch.profiler`` trace (a ``record_function`` range, on the
    clock of the trace's device events). With no profiler running it is
    one shared no-op: the flag is read on every call, and
    ``record_function``, which costs microseconds a call even then, is
    never entered."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` timeline of the block (CPU and, where there is
    a card, CUDA activity), written to ``log_dir`` for TensorBoard; the
    program's ``span`` stages appear in it on the device events' clock."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
