"""Where a traced run's device-idle time falls among the program's phases.

    python3 benchmark/phases.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as `benchmark/run.py --trace 1` does and prints what it
prints, then one more line, `phases {json}`: over the traced slices, per
unit, the device-idle ms under each `dl4ss.` span of the program and
outside them, and the host's synchronisations with the card that start
inside each (`harness/spans.py`), with the slices' window and idle ms.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Callable, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402
from benchmark.harness import spans, trace  # noqa: E402


def with_spans(fn: Callable) -> Tuple[object, Optional[dict]]:
    """fn()'s result, and `spans.reduce` of the slices that the run it
    makes hands to `trace.summarize` (None in an untraced run)."""
    found = []
    summarize = trace.summarize

    def summarize_and_reduce(slices):
        found.append(spans.reduce(slices))
        return summarize(slices)

    trace.summarize = summarize_and_reduce
    try:
        return fn(), (found[-1] if found else None)
    finally:
        trace.summarize = summarize


def per_unit(red: dict) -> dict:
    n = red["units"]
    return {"units": n, "window_ms": 1e3 * red["window_s"] / n,
            "idle_ms_total": 1e3 * sum(red["idle_s"].values()) / n,
            "idle_ms": {k: 1e3 * v / n for k, v in red["idle_s"].items()},
            "syncs_total": sum(red["syncs"].values()) / n,
            "syncs": {k: v / n for k, v in red["syncs"].items()}}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rc, red = with_spans(lambda: run.main(argv + ["--trace", "1"]))
    if red is not None:
        print("phases " + json.dumps(per_unit(red)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
