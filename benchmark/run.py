"""The benchmark of `dl4ss_tpu_torch`: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's program state from the seed (its weights, bank
and requests made on the device) and warms up the cell's own shapes; the
window then runs the cell's traffic in closed loop for `--seconds`. With
`--trace 1` a few fixed slices of the window are profiled and the cell's
per-layer metrics are read from them; with `--trace 0` its end-to-end
metrics from the window. After the window the plain reference judges what
the timed path produced. The last line of standard output is the result;
the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key. Needs the CUDA devices the cell
asks for: without them it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CACHE = REPO / ".bench_cache"


def _environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout,
    so that only a checkout's first run builds (the program's own CUDA
    library builds into dl4ss_tpu_torch/_build/, also inside it), and one
    host thread for the CPU's math, so that a run's host work does not
    contend with itself on a machine whose cores it shares."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            man: dict, config_patch=None, traffic_patch=None) -> dict:
    """One run of `cell` on `device`; returns the result's fields. The
    patches (dicts merged into the configuration's `config` and `derived`
    and into the traffic) shrink a cell for the CPU tests."""
    import torch

    from benchmark.harness import device as dev_mod
    from benchmark.harness import readers, registry, trace as trace_mod
    from benchmark.harness import window
    from benchmark.harness.program import Ctx, reference_config

    entry, cell_file, config, traffic = registry.load_cell(man, cell)
    for key, patch in (config_patch or {}).items():
        config[key] = dict(config[key], **patch)
    traffic.update(traffic_patch or {})
    kind = cell_file["driver"]
    driver_mod = registry.load_module("drivers", kind)
    count = driver_mod.count(registry.load_module("flops", entry["config"]),
                             reference_config(config), traffic["batch"])
    ctx = Ctx(cell, seed, seconds, device, config, traffic,
              cell_file["limits"])

    tracer = trace_mod.Tracer(torch, device) if trace else None
    smi_before = dev_mod.smi() if device.type == "cuda" else "cpu"
    driver = driver_mod.Driver(ctx)
    setup_s = dev_mod.process_age_s()
    cpu_before = dev_mod.cpu_s()
    win = window.run(driver, seconds, tracer, traffic["trace_units"])
    cpu_share = (dev_mod.cpu_s() - cpu_before) / win.seconds
    failed = win.failed + driver.nonfinite()
    win = win._replace(failed=failed)
    device_info = dev_mod.describe(device, entry["chips"])
    smi_after = dev_mod.smi() if device.type == "cuda" else "cpu"
    summary = trace_mod.summarize(tracer.slices) if trace else None
    counters = _program_counters()
    driver.after_window()
    driver.free_program()
    checks = driver.checks()

    reading = readers.Reading(driver.kind, win, setup_s,
                              driver.mixtures_per_unit, count,
                              config["precision"], summary)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(man, cell, section):
        value = registry.load_module("metrics", m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(checks) and failed == 0
              and all(c.passed for c in checks),
              "attempted": win.units, "failed": failed, "metrics": metrics,
              "device": device_info}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return {"result": result, "smi": [smi_before, smi_after],
            "cpu_share": cpu_share,
            "kernels": summary["kernels"] if summary else None,
            "counters": counters, "window_s": win.seconds}


def _program_counters() -> dict:
    """The program's own launch counters, as a cross-check of the trace's
    (they count only its hand-written kernels)."""
    from dl4ss_tpu_torch.ops import cuda_lib, rnn_kernels
    return {"launches": dict(cuda_lib.LAUNCHES),
            "bodies": {" ".join(k): v
                       for k, v in rnn_kernels.BODY_LAUNCHES.items()}}


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    sys.path.insert(0, str(REPO))
    from benchmark.harness import device as dev_mod
    from benchmark.harness import registry

    man = registry.manifest()
    entry = next((w for w in man["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"benchmark: no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    dev_mod.require_cards(entry["chips"])
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), man)
    found = dev_mod.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    result = out["result"]
    print("nvidia-smi " + json.dumps(out["smi"]))
    print("window_cpu_share " + repr(out["cpu_share"]))
    print("window_s " + repr(out["window_s"]))
    print("program_counters " + json.dumps(out["counters"]))
    if out["kernels"] is not None:
        print("kernels " + json.dumps(out["kernels"]))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
