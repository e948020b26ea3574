"""The readings that a cell's limits are set from, on the chip at the
cell's own size, in one process:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds 2] [--out control.jsonl]

For each seed it builds the cell's set-up as a run does and reads
- `program`: the numbers that a run compares (the program against the
  reference);
- `control`: the same numbers with the reference itself, computed in TF32
  (the nearest precision below the configuration's float32 with TF32 off),
  put in the program's place;
- for a training cell, `half_batch`: the reference in the program's place
  with half of each batch left out and the mean taken over the rest.
A training cell runs its late step right after set-up, with no window.
A serving cell first runs a short window (`--seconds`) at its own load to
have answers to compare. Each reading is one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, seconds: float, man: dict) -> dict:
    import torch

    from benchmark.harness import registry, window
    from benchmark.harness.program import Ctx

    _, cell_file, config, traffic = registry.load_cell(man, cell)
    ctx = Ctx(cell, seed, seconds, torch.device("cuda", 0), config, traffic,
              cell_file["limits"])
    t0 = time.perf_counter()
    driver = registry.load_module("drivers", cell_file["driver"]).Driver(ctx)
    out = {"cell": cell, "seed": seed}
    if driver.kind == "serve":
        window.run(driver, seconds)
    driver.after_window()
    driver.free_program()
    t1 = time.perf_counter()

    def values(checks):
        return {c.name: c.value for c in checks}

    out["program"] = values(driver.checks())
    t2 = time.perf_counter()
    if driver.kind == "train":
        ref = driver.reference_record()
        ctl = driver.reference_record(tf32_on=True)
        out["control"] = values(driver.compare(ctl, ref))
        both = (("program", driver.program_record()), ("control", ctl))
        out["worst"] = {
            k: {name: sorted(per, key=per.get)[-3:]
                for name, per in driver.readings(rec, ref).items()}
            for k, rec in both}
        out["loss_steps"] = {k: [[abs(g - r) / abs(r) for g, r in zip(gs, rs)]
                                 for gs, rs in zip(rec.losses, ref.losses)]
                             for k, rec in both}
        half = slice(0, driver.mixtures_per_unit // 2)
        out["half_batch"] = values(driver.compare(
            driver.reference_record(rows=half), ref))
    else:
        keys = sorted({(a.row, a.speakers) for a in driver.answers})
        rows = [k[0] for k in keys]
        given = None if driver.select else [k[1] for k in keys]
        ctl, _ = driver.reference_answers(rows, given, tf32_on=True)
        out["control"] = values(driver.compare(ctl))
        out["answers"] = len(driver.answers)
    out["seconds"] = {"setup": t1 - t0, "reference": t2 - t1,
                      "control": time.perf_counter() - t2}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from benchmark.harness import device as dev_mod
    from benchmark.harness import registry
    man = registry.manifest()
    entry = next(w for w in man["workloads"] if w["name"] == args.workload)
    dev_mod.require_cards(entry["chips"])
    print("nvidia-smi " + dev_mod.smi(), flush=True)
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed, args.seconds, man))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
