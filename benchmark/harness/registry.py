"""Find a cell's files by name.

Every part that belongs to one configuration, one cell, one traffic mix,
one traffic driver or one metric sits in a file of its own, named after
it: `configs/<config>.json` with the configuration's layers counted in
`flops/<config>.py`, `workloads/<cell>.json`, `traffic/<traffic>.json`,
`drivers/<driver>.py` with the count of its unit made from those layers,
`metrics/<metric>.py`. A new cell, configuration, driver or metric is new
files, and nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(kind: str, name: str, root: Optional[Path] = None) -> dict:
    """`<root>/<kind>/<name>.json`, root defaulting to the benchmark's
    folder."""
    path = (root or BENCH) / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Optional[Path] = None
                ) -> ModuleType:
    """Import `<root>/<kind>/<name>.py` (a name may hold dots)."""
    path = (root or BENCH) / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"benchmark_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest(repo: Optional[Path] = None) -> dict:
    path = (repo or REPO) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no manifest at {path}")
    return json.loads(path.read_text())


def load_cell(man: dict, cell: str):
    """(manifest entry, cell file, configuration file, traffic file) of
    `cell`."""
    entry = next((w for w in man["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    cell_file = load_json("workloads", cell)
    if (cell_file["config"], cell_file["traffic"]) != (entry["config"],
                                                      entry["traffic"]):
        raise ValueError(f"{cell}: the cell file and BENCHMARK.json differ")
    return (entry, cell_file, load_json("configs", entry["config"]),
            load_json("traffic", entry["traffic"]))


def cell_metrics(man: dict, cell: str, section: str) -> list:
    """The entries of `section` (end_to_end or per_layer) that the cell
    reports: an end-to-end metric without a `workloads` list is every
    cell's; a per-layer metric lists its cells."""
    if section == "end_to_end":
        return [m for m in man["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in man["per_layer"] if cell in m["workloads"]]
