"""The Inception trunk's least time (its convolutions' operations at the
float32 peak, 67 TFLOP/s, or their bytes at 3.35 TB/s where that is
longer, layer by layer, as `flops/grid_video.py` counts them) over the
device time of the kernels that run its convolutions (the names listed in
metrics/trunk_kernels/), in the traced train units."""

import json
import re
from pathlib import Path

from benchmark.harness import peaks, registry
from benchmark.harness.program import reference_config

KERNEL_LISTS = Path(__file__).resolve().parent / "trunk_kernels"


def _patterns():
    names = set()
    for path in sorted(KERNEL_LISTS.glob("*.json")):
        names.update(json.loads(path.read_text())["kernels"])
    return [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])")
            for n in sorted(names)]


def read(r):
    t = r.trace
    if r.kind != "train" or t is None or t["units"] <= 0:
        return None
    pats = _patterns()
    dev_s = sum(v[1] for name, v in t["kernels"].items()
                if any(p.search(name) for p in pats))
    if dev_s <= 0:
        return None
    c = reference_config(registry.load_json("configs", "grid_video"))
    least = registry.load_module("flops", "grid_video").trunk_least_s(
        c, r.mixtures_per_unit, peaks.F32_FLOPS, peaks.HBM_BYTES_PER_S)
    return 100.0 * least * t["units"] / dev_s
