"""Determinism helpers (the port of `dl4ss_tpu/utils/determinism.py`).

The reference's reproducibility contract is three global seeds set at the
top of every script (`np.random.seed(1); torch.manual_seed(1);
random.seed(1)`, Torch_multi/main_run.py:21-23). Here the device-side
randomness of the trainers is drawn from explicit `torch.Generator`s;
this helper seeds the global RNGs (python, numpy, torch's default
generators on the CPU and every card) and returns a generator in the
role of JAX's root key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 1) -> torch.Generator:
    """Seed the global RNGs and return a CPU generator seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)          # also seeds every CUDA device
    return torch.Generator().manual_seed(seed)
