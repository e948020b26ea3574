"""The control on the card: the reference computed in TF32, put in the
program's place, fails a number of each cell whose limits it set, while
the program passes them. At the cells' own size on one seed each (about a
minute on an H100); skips without a card."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.harness import registry


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["torch_multi.train_b16",
                                  "torch_multi.serve_b1",
                                  "tdaa.serve_select_b16",
                                  "tdaa.train_adv_b16"])
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32 on the card")
    man = registry.manifest()
    limits = registry.load_json("workloads", cell)["limits"]
    got = control.readings(cell, 4242, 2.0, man)
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(v > limits[k] for k, v in got["control"].items()), got
