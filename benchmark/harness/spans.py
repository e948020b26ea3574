"""The program's phase spans in the traced slices.

The program marks each phase of a step or a request with a host event
named `dl4ss.<phase>` (`dl4ss_tpu_torch/utils/profiling.py::span`), on the
profiler's clock, which the card's activity in the same trace shares.
`reduce` splits each slice's device-idle time among them: at each instant
the innermost open span takes it (the latest-starting one, from any
thread), and idle time under no span goes to `outside`. It also counts the
host's synchronisations with the card that start inside a span, by the
innermost one.
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.harness.trace import Slice, _merged

PREFIX = "dl4ss."
OUTSIDE = "outside"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def idle_intervals(sl: Slice) -> List[tuple]:
    """The slice's intervals with no operation on the device: the
    complement of the merged busy intervals within its bounds, as
    `trace.summarize` takes them."""
    merged = _merged([(s, min(t, sl.end_us)) for _, s, t in sl.device])
    edges = [sl.start_us] + [x for st in merged for x in st] + [sl.end_us]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _innermost(starts, ends, at):
    """For each time in `at`, the index of the innermost span open there
    (start <= t < end; the latest start, then the earliest end), or -1.
    The spans are sorted by (start, -end), so that is the last open one."""
    if not len(starts):
        return np.full(len(at), -1)
    is_open = (starts[None, :] <= at[:, None]) & (at[:, None] < ends[None, :])
    last = is_open.shape[1] - 1 - np.argmax(is_open[:, ::-1], axis=1)
    return np.where(is_open.any(axis=1), last, -1)


def reduce(slices: List[Slice]) -> dict:
    """{"units", "window_s", "idle_s": {phase: s, ..., "outside": s},
    "syncs": {phase: count}}. A phase is listed once its span opened in a
    slice, with 0.0 s and 0 syncs if nothing fell under it; the idle
    seconds sum to the slices' window less their busy time."""
    idle_s = {OUTSIDE: 0.0}
    syncs = {}
    units, window = 0, 0.0
    for sl in slices:
        units += sl.units
        window += (sl.end_us - sl.start_us) / 1e6
        spans = sorted(((s, t, name[len(PREFIX):]) for name, s, t in sl.host
                        if name.startswith(PREFIX)
                        and s < sl.end_us and t > sl.start_us),
                       key=lambda x: (x[0], -x[1]))
        names = [n for _, _, n in spans]
        for n in names:
            idle_s.setdefault(n, 0.0)
            syncs.setdefault(n, 0)
        starts = np.array([s for s, _, _ in spans], dtype=float)
        ends = np.array([t for _, t, _ in spans], dtype=float)
        gaps = idle_intervals(sl)
        if gaps:
            # the gaps cut at every span's edge: each piece lies under one
            # innermost span, or none
            lo = np.array([a for a, _ in gaps])
            hi = np.array([b for _, b in gaps])
            cuts = np.concatenate([starts, ends])
            cuts = cuts[(cuts > sl.start_us) & (cuts < sl.end_us)]
            pts = np.unique(np.concatenate([lo, hi, cuts]))
            mids = 0.5 * (pts[:-1] + pts[1:])
            gap = np.searchsorted(lo, mids, side="right") - 1
            idle = (gap >= 0) & (mids < hi[np.maximum(gap, 0)])
            lengths = (pts[1:] - pts[:-1])[idle] / 1e6
            for i, length in zip(_innermost(starts, ends, mids[idle]),
                                 lengths):
                idle_s[names[i] if i >= 0 else OUTSIDE] += float(length)
        at = np.array([s for name, s, _ in sl.host
                       if name in SYNCS and sl.start_us <= s <= sl.end_us],
                      dtype=float)
        for i in _innermost(starts, ends, at):
            if i >= 0:
                syncs[names[i]] += 1
    return {"units": units, "window_s": window, "idle_s": idle_s,
            "syncs": syncs}
