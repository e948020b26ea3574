"""Load a JAX parameter pytree into the port's modules.

The JAX package keeps parameters as nested dicts and lists of arrays
(`init_separator`'s pytree); the port's modules name their parameters after
the same leaves (`encoder.rnn.0.fwd.wx`, `encoder.proj.w`, ...) in the same
layouts, so a tree converted to numpy loads leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, leaf) for every leaf of nested dicts / lists."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_tree(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from flatten_tree(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def load_jax_params(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy every leaf of `tree` into the parameter of the same name.

    Raises ValueError on a missing, extra or mis-shaped leaf, before any
    parameter is written. Leaves are cast to each parameter's dtype and
    device. Returns `module`."""
    leaves = {name: np.array(leaf, dtype=np.float32)
              for name, leaf in flatten_tree(tree)}
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"extra {extra}")
    for name, arr in leaves.items():
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: tree leaf has shape {arr.shape}, the "
                             f"module wants {tuple(params[name].shape)}")
    with torch.no_grad():
        for name, arr in leaves.items():
            params[name].copy_(torch.from_numpy(arr))
    return module
