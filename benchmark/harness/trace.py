"""The traced run: a fixed number of units profiled in a few slices of the
window, and their reduction to device time, idle gaps and launches.

Nothing is written to disk: each slice's events are read from
`torch.profiler` in memory and reduced at once.
"""

from __future__ import annotations

import collections
from typing import Callable, List, NamedTuple

import numpy as np

MARK = "benchmark.traced_slice"
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


class Slice(NamedTuple):
    start_us: float
    end_us: float
    units: int
    device: List[tuple]     # (name, start_us, end_us): kernels and copies
    host: List[tuple]       # (name, start_us, end_us): host ops


class Tracer:
    def __init__(self, torch_mod, device):
        self.torch, self.device = torch_mod, device
        self.slices: List[Slice] = []
        # the profiler's first start initialises CUPTI: do it in set-up
        self.run_slice(lambda: torch_mod.ones(1, device=device).sum(), 1)
        self.slices.clear()

    def run_slice(self, fn: Callable[[], None], units: int) -> None:
        """Profile `units` calls of `fn` (after one unread call)."""
        from torch.profiler import ProfilerActivity, profile, record_function
        torch = self.torch
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        with profile(activities=acts) as prof:
            # the tracer can miss what is launched right after it starts:
            # one unit runs before the marker, outside the reading
            fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            with record_function(MARK):
                for _ in range(units):
                    fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        cpu_t = torch.autograd.DeviceType.CPU
        events = prof.events()
        mark = next(e for e in events
                    if e.name == MARK and e.device_type == cpu_t)
        lo, hi = mark.time_range.start, mark.time_range.end
        dev, host = [], []
        for e in events:
            if e.name == MARK:
                continue
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == cpu_t:
                if s <= hi and t >= lo:
                    host.append((e.name, s, t))
            elif lo <= s <= hi:
                dev.append((e.name, s, t))
        self.slices.append(Slice(lo, hi, units, dev, host))


def is_kernel(name: str) -> bool:
    return not name.startswith(_NOT_KERNELS)


def _merged(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def summarize(slices: List[Slice]) -> dict:
    """busy_s, window_s, units, kernels {name: [launches, seconds]},
    launches, device_ops and idle_gaps (top 10 each, seconds)."""
    busy = window = 0.0
    units = 0
    by_name = collections.defaultdict(lambda: [0, 0.0])
    gap_by_label = collections.defaultdict(float)
    for sl in slices:
        window += (sl.end_us - sl.start_us) / 1e6
        units += sl.units
        for name, s, t in sl.device:
            if is_kernel(name):
                by_name[name][0] += 1
            by_name[name][1] += (t - s) / 1e6
        merged = _merged([(s, min(t, sl.end_us)) for _, s, t in sl.device])
        busy += sum(t - s for s, t in merged) / 1e6
        edges = [sl.start_us] + [x for st in merged for x in st] + [sl.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        if sl.host:
            names = [h[0] for h in sl.host]
            hs = np.array([h[1] for h in sl.host])
            he = np.array([h[2] for h in sl.host])
            dur = he - hs
        for s, t in gaps:
            label = "(no host op open)"
            if sl.host:
                mid = 0.5 * (s + t)
                open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
                if open_.size:
                    label = names[open_[np.argmin(dur[open_])]]
            gap_by_label[label] += (t - s) / 1e6
    kernels = {n: v for n, v in by_name.items() if is_kernel(n)}
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top_gaps = sorted(gap_by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window, "units": units,
            "kernels": kernels,
            "launches": sum(v[0] for v in kernels.values()),
            "device_ops": [[n, v[1]] for n, v in top_ops],
            "idle_gaps": [[n, v] for n, v in top_gaps]}
