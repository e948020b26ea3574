"""What the metric readers share. A reader takes the run's `Reading` and
returns a number, or None where it finds nothing to read; it never stands
a 0 in for a share it could not read."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List, NamedTuple, Optional

from benchmark.harness import peaks
from benchmark.harness.flopcount import Count
from benchmark.harness.window import Window, p95

KERNEL_LISTS = Path(__file__).resolve().parents[1] / "metrics" / "rnn_kernels"


class Reading(NamedTuple):
    kind: str                   # "train" or "serve"
    window: Window
    setup_s: float
    mixtures_per_unit: int
    count: Count                # the products of one unit
    precision: dict             # the configuration's stated precision
    trace: Optional[dict]       # trace.summarize's, in a traced run


def recurrence_patterns() -> List[re.Pattern]:
    """The kernel names that run the recurrences: every list in
    metrics/rnn_kernels/, matched as whole identifiers."""
    names = set()
    for path in sorted(KERNEL_LISTS.glob("*.json")):
        names.update(json.loads(path.read_text())["kernels"])
    return [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])")
            for n in sorted(names)]


def mixtures_per_s(r: Reading, kind: str) -> Optional[float]:
    if r.kind != kind or r.window.seconds <= 0:
        return None
    done = r.window.units - r.window.failed
    return done * r.mixtures_per_unit / r.window.seconds


def latency_p95_ms(r: Reading) -> Optional[float]:
    if r.kind != "serve":
        return None
    v = p95(r.window.latencies_s)
    return None if v is None else v * 1e3


def _traced(r: Reading, kind: str) -> bool:
    return (r.kind == kind and r.trace is not None and r.trace["units"] > 0
            and r.trace["window_s"] > 0 and r.trace["busy_s"] > 0)


def mfu(r: Reading, kind: str) -> Optional[float]:
    """Training: the traced steps' products over their wall time. Serving:
    a request's products over the mean latency of the window's
    requests."""
    if kind == "serve":
        lat = r.window.latencies_s
        if r.kind != kind or not lat:
            return None
        return 100.0 * r.count.model * len(lat) / sum(lat) / peaks.STEP_PEAK
    if not _traced(r, kind):
        return None
    ops = r.count.model * r.trace["units"]
    return 100.0 * ops / r.trace["window_s"] / peaks.STEP_PEAK


def rnn_roofline(r: Reading, kind: str) -> Optional[float]:
    if not _traced(r, kind):
        return None
    pats = recurrence_patterns()
    dev_s = sum(v[1] for name, v in r.trace["kernels"].items()
                if any(p.search(name) for p in pats))
    if dev_s <= 0:
        return None
    peak = peaks.PRODUCT_PEAK[r.precision["recurrence"]]
    least = sum(max(o / peak, n / peaks.HBM_BYTES_PER_S)
                for o, n in r.count.recurrence) * r.trace["units"]
    return 100.0 * least / dev_s


def idle(r: Reading, kind: str) -> Optional[float]:
    if not _traced(r, kind):
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])


def launches(r: Reading, kind: str) -> Optional[float]:
    if not _traced(r, kind) or r.trace["launches"] == 0:
        return None
    return r.trace["launches"] / r.trace["units"]
