"""The benchmark's tests: `python -m pytest benchmark/tests -q` from the
repository's root. They run on the CPU at small sizes; those marked
`cuda` decide inside the test whether a card is there."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a cell's configuration cut to a size the CPU runs in seconds: every
# kind of layer is kept, the widths are not the published ones
TINY = {"config": {"hidden_units": 16, "embedding_size": 8, "num_speakers": 8,
                   "max_len_seconds": 0.25, "batch_size": 4},
        "derived": {"max_len": 2000, "num_frames": 16}}


def tiny_traffic(cell: str) -> dict:
    patch = {"batch": 4}
    if "serve" in cell:
        patch.update(pool=8, sample=4, warmup_units=2, trace_units=2)
    else:
        patch.update(warmup_units=1, trace_units=1)
    return patch


@pytest.fixture
def manifest():
    from benchmark.harness import registry
    return registry.manifest()


def run_tiny(cell: str, seed: int = 20261017, seconds: float = 1.0,
             trace: bool = False) -> dict:
    from benchmark.harness import registry
    from benchmark.run import execute
    return execute(cell, seed, seconds, trace, torch.device("cpu"),
                   registry.manifest(), TINY, tiny_traffic(cell))["result"]
