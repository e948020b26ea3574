"""The measured window: a closed loop of units (a training step, a
request or a batch) for `seconds` seconds, and the statistics of it.

A unit that raises counts as failed and the loop goes on. The window ends
at the first unit boundary past `seconds`, after the device has finished
all the work queued in it, so a rate covers all the work and all the time
of the window. With a tracer, a few fixed slices of units are profiled at
fixed points of the window.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import List, NamedTuple, Optional

import numpy as np

TRACE_AT = (0.25, 0.5, 0.75)    # where the slices start, as window shares


class Window(NamedTuple):
    seconds: float
    units: int
    failed: int
    latencies_s: List[float]


def run(driver, seconds: float, tracer=None, slice_units: int = 0
        ) -> Window:
    lat: List[float] = []
    state = {"units": 0, "failed": 0, "printed": False}

    def one() -> None:
        state["units"] += 1
        try:
            t = driver.unit()
        except Exception:                 # a failed unit; the loop goes on
            state["failed"] += 1
            if not state["printed"]:
                traceback.print_exc(file=sys.stderr)
                state["printed"] = True
            return
        if t is not None:
            lat.append(t)

    plan = [f * seconds for f in TRACE_AT] if tracer else []
    driver.sync()
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        if plan and now >= plan[0]:
            plan.pop(0)
            tracer.run_slice(one, slice_units)
        else:
            one()
    driver.sync()
    return Window(time.perf_counter() - t0, state["units"], state["failed"],
                  lat)


def p95(values: List[float]) -> Optional[float]:
    return float(np.percentile(values, 95)) if values else None
