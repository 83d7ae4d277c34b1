"""The card's idle time in a traced window, charged to the stage of the
program that the host was in, and what the program counts of its pairs.

The program opens ``record_function`` spans at its stage boundaries
(``hnsw_nsg_tpu_torch/utils/metrics.py`` ``span``): ``cnns.search``
around each search and, inside it, ``cnns.route``, ``cnns.pairs`` (each
call of the grouped path), ``cnns.probe`` (the per-query path) and
``cnns.dedup``. They are profiler events, on the clock of the device
events of the same trace. Every interval of the window in which no
kernel, copy or set runs is split by time among the program spans open
on the window's thread, each part charged to the innermost one, and to
``OUTSIDE`` where none is open: the charges sum to the window's idle time.

The launches under a span are counted by correlation, as
``Reading.span_device_s`` matches them, from ``Reading``'s launch lists
(``_launch_ts``, ``_launch_corr``, ``_by_corr``).

The pair counts are the program's ``models.cnns.pair_counts``: a metric's
``record`` keeps a copy at each call of the grouped path, and the
window's count is the counts at read time less the first copy.

A program without these spans or counts gives nothing to read, and so
does a window in which nothing ran on a card.
"""

from __future__ import annotations

import bisect
import importlib
import math
from collections import defaultdict

SPANS = ("cnns.search", "cnns.route", "cnns.pairs", "cnns.probe",
         "cnns.dedup")
SEARCH = "cnns.search"
OUTSIDE = "outside"
PROGRAM = "hnsw_nsg_tpu_torch.models.cnns"


def idle(r) -> list:
    """The window's intervals (start, end), in trace microseconds, in
    which no device operation runs."""
    out, prev = [], r.w0
    for s, t, _, _ in r.device:         # sorted by start
        s, t = max(s, r.w0), min(t, r.w1)
        if t <= s:
            continue
        if s > prev:
            out.append((prev, s))
        prev = max(prev, t)
    if r.w1 > prev:
        out.append((prev, r.w1))
    return out


def _pieces(r) -> list:
    """The window cut into (start, end, name) pieces, ``name`` the
    innermost program span open in the piece (the last opened of those
    open), ``OUTSIDE`` where none is."""
    spans = sorted(((s, t, name) for name in SPANS
                    for s, t in r.spans(name)),
                   key=lambda e: (e[0], -e[1]))
    out: list = []
    opened: list = []                    # [(end, name)], in opening order
    now, i = r.w0, 0

    def upto(t: float) -> None:
        nonlocal now
        a, b = max(now, r.w0), min(t, r.w1)
        if b > a:
            out.append((a, b, opened[-1][1] if opened else OUTSIDE))
        now = max(now, t)

    while i < len(spans) or opened:
        start = spans[i][0] if i < len(spans) else math.inf
        j = min(range(len(opened)), key=lambda k: opened[k][0],
                default=None)
        if j is not None and opened[j][0] <= start:
            upto(opened[j][0])
            del opened[j]
        else:
            upto(start)
            opened.append((spans[i][1], spans[i][2]))
            i += 1
    upto(r.w1)
    return out


def charges(r) -> dict:
    """Idle seconds of the window by the program span charged for them
    (``OUTSIDE`` for those outside every span)."""
    tot: dict = defaultdict(float)
    pieces, gaps = _pieces(r), idle(r)
    i = j = 0
    while i < len(pieces) and j < len(gaps):
        a, b, name = pieces[i]
        g0, g1 = gaps[j]
        lo, hi = max(a, g0), min(b, g1)
        if hi > lo:
            tot[name] += (hi - lo) * 1e-6
        if b <= g1:
            i += 1
        else:
            j += 1
    return dict(tot)


def stall_ms(r, name: str):
    """Device-idle milliseconds a request charged to span ``name`` (or to
    ``OUTSIDE``, read where the program opens ``cnns.search``), with the
    whole split as a note; None where the span is absent or nothing ran
    on a card."""
    if not r.device or not r.spans(SEARCH if name == OUTSIDE else name):
        return None
    ch = charges(r)
    note = "idle ms a request: " + ", ".join(
        f"{k} {1e3 * ch.get(k, 0.0) / r.requests:.4f}"
        for k in SPANS + (OUTSIDE,))
    return 1e3 * ch.get(name, 0.0) / r.requests, note


def launches(r, lab: str) -> list:
    """The device operations launched under each instance of span
    ``lab``, in time order."""
    out = []
    for s, t in r.spans(lab):
        i = bisect.bisect_left(r._launch_ts, s)
        j = bisect.bisect_right(r._launch_ts, t)
        out.append(sum(len(r._by_corr.get(c, ()))
                       for c in r._launch_corr[i:j]))
    return out


def pair_snapshot():
    """A copy of the program's pair counts, None where it keeps none."""
    counts = getattr(importlib.import_module(PROGRAM), "pair_counts", None)
    return None if counts is None else dict(counts)


def pairs_per_request(r, records: list, key: str):
    """The window's count ``key`` of the program's pair counts a request:
    the counts now less the first record. None where the grouped path did
    not run, the program keeps no counts, or nothing ran on a card."""
    if not r.device or not records or records[0] is None:
        return None
    now = pair_snapshot()
    return (now.get(key, 0) - records[0].get(key, 0)) / r.requests
