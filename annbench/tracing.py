"""The traced run: spans around named functions of the program, the
profiler's trace of the window, and its reduction to per-layer numbers.

Spans come from the benchmark, not from the program: for the traced run
only, each function that a per-layer metric names in its ``WRAP`` list
(``(module, attribute)`` pairs) is replaced by a wrapper that opens a
``torch.profiler.record_function`` span labelled ``module.attribute``
and, where the metric defines ``record(args, kwargs)``, keeps what that
returns for each call. A name the program no longer has leaves its
metric out, with the reason.

The reduction reads the profiler's Chrome trace: the device time under a
span is that of the kernels, copies and sets whose launches (runtime or
driver calls, matched by correlation id) the host made inside the span;
the device is busy where any of them runs; an idle gap is named after the
innermost host event that was open at its middle.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

WINDOW = "annbench.window"
REQUEST = "annbench.request"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


class Wrapping:
    """Installs the spans that the metrics ``{name: module}`` ask for and
    takes them out again. ``missing[name]`` says why a metric can read
    nothing; ``records[name]`` holds its ``record`` results in call
    order."""

    def __init__(self, metrics: dict):
        self.metrics = metrics
        self.missing: dict[str, str] = {}
        self.records: dict[str, list] = defaultdict(list)
        self._hooks: dict[str, list] = {}
        self._saved: list = []

    def install(self) -> None:
        for name, mod in self.metrics.items():
            for module, attr in getattr(mod, "WRAP", ()):
                try:
                    target = importlib.import_module(module)
                    fn = getattr(target, attr)
                except (ImportError, AttributeError) as e:
                    self.missing[name] = f"{module}.{attr} not found: {e}"
                    continue
                lab = f"{module}.{attr}"
                if lab not in self._hooks:
                    self._hooks[lab] = []
                    self._saved.append((target, attr, fn))
                    setattr(target, attr, self._wrap(fn, lab))
                rec = getattr(mod, "record", None)
                if rec is not None:
                    self._hooks[lab].append((name, rec))

    def _wrap(self, fn, lab: str):
        hooks, records = self._hooks[lab], self.records

        def wrapper(*args, **kwargs):
            for name, rec in hooks:
                records[name].append(rec(args, kwargs))
            with torch.profiler.record_function(lab):
                return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper

    def remove(self) -> None:
        for target, attr, fn in reversed(self._saved):
            setattr(target, attr, fn)
        self._saved.clear()


def profile(fn):
    """Run ``fn()`` under the profiler inside a ``WINDOW`` span and return
    the Chrome trace's events. The trace file goes to a temporary file in
    ``TMPDIR`` and is deleted once read."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="annbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def short_name(name: str) -> str:
    """A device operation's name without its return type, template
    arguments, parameters and namespaces: ``DeviceSegmentedRadixSortKernel``,
    ``gemvx::kernel``, ``DtoH``."""
    m = re.match(r"Memcpy (\w+)", name)
    if m:
        return m.group(1)
    if name.startswith("Memset"):
        return "Memset"
    flat, depth = [], 0
    for ch in name.replace("(anonymous namespace)", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            flat.append(ch)
    words = "".join(flat).split("(", 1)[0].split()
    if not words:
        return name
    parts = words[-1].split("::")
    return "::".join(parts[-2:]) if parts[-1] == "kernel" else parts[-1]


class Reading:
    """The trace of one window, reduced. Times in seconds."""

    def __init__(self, events: list, requests: int, setup: dict):
        self.requests = requests
        self.setup = setup
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError("the trace has no window span")
        w = max(win, key=lambda e: e["dur"])
        self.tid = w["tid"]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (self.w1 - self.w0) * 1e-6

        self.device = []                    # (start, end, name, correlation)
        self._by_corr = defaultdict(list)   # correlation -> [(s, name)]
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                corr = e.get("args", {}).get("correlation")
                name = short_name(e["name"])
                self.device.append((s, t, name, corr))
                if corr is not None:
                    self._by_corr[corr].append((float(e["dur"]) * 1e-6, name))
        self.device.sort()
        main = [e for e in xs if e.get("tid") == self.tid]
        launches = sorted((float(e["ts"]), e.get("args", {})
                           .get("correlation")) for e in main
                          if e.get("cat") in LAUNCH_CATS)
        self._launch_ts = [t for t, _ in launches]
        self._launch_corr = [c for _, c in launches]
        self._spans = defaultdict(list)
        for e in main:
            if e.get("cat") == "user_annotation":
                self._spans[e["name"]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for v in self._spans.values():
            v.sort()
        self._host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in main
             if e.get("cat") in HOST_CATS and e.get("name") != WINDOW),
            key=lambda h: (h[0], -h[1]))
        self._busy = self._merged()
        self.busy_s = sum(t - s for s, t in self._busy) * 1e-6

    def _merged(self) -> list:
        out: list = []
        for s, t, _, _ in self.device:
            s, t = max(s, self.w0), min(t, self.w1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def spans(self, lab: str) -> list:
        return self._spans.get(lab, [])

    def span_device_s(self, lab: str, kernel: str | None = None) -> list:
        """Device seconds of each instance of span ``lab``, in time order:
        of every operation it launched, or of those whose short name
        matches the regular expression ``kernel``."""
        pat = re.compile(kernel) if kernel else None
        out = []
        for s, t in self.spans(lab):
            i = bisect.bisect_left(self._launch_ts, s)
            j = bisect.bisect_right(self._launch_ts, t)
            tot = 0.0
            for corr in self._launch_corr[i:j]:
                for dur, name in self._by_corr.get(corr, ()):
                    if pat is None or pat.search(name):
                        tot += dur
            out.append(tot)
        return out

    def device_s(self, kernel: str | None = None) -> float:
        """Device seconds inside the window of the operations whose short
        name matches ``kernel`` (every operation when None)."""
        pat = re.compile(kernel) if kernel else None
        return sum(min(t, self.w1) - max(s, self.w0)
                   for s, t, name, _ in self.device
                   if t > self.w0 and s < self.w1
                   and (pat is None or pat.search(name))) * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        tot: dict = defaultdict(float)
        for s, t, name, _ in self.device:
            if t > self.w0 and s < self.w1:
                tot[name] += (min(t, self.w1) - max(s, self.w0)) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds of the device in the window, summed by the name of
        the innermost host event open at each gap's middle
        (``host_outside_any_range`` where none is)."""
        gaps, prev = [], self.w0
        for s, t in self._busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.w1 > prev:
            gaps.append((prev, self.w1))
        tot: dict = defaultdict(float)
        stack: list = []
        h = 0
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            while h < len(self._host) and self._host[h][0] <= mid:
                ev = self._host[h]
                while stack and stack[-1][1] < ev[0]:
                    stack.pop()
                stack.append(ev)
                h += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host_outside_any_range"
            tot[name] += (g1 - g0) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]
