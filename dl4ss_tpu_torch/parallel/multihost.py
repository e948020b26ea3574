"""Input sharding over processes (the port of
`dl4ss_tpu/parallel/multihost.py`).

Each process feeds only its share of the data: these helpers partition
work by the process's rank in the `torch.distributed` group (rank 0 of 1
when no group is up), with the same arithmetic as the JAX package's
`jax.process_index()` split.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from dl4ss_tpu_torch.parallel.mesh import map_arrays, rank_and_world

def host_shard_range(total: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, end) of this process's contiguous share of `total` items."""
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    base, rem = divmod(total, pc)
    start = pi * base + min(pi, rem)
    return start, start + base + (1 if pi < rem else 0)


def host_shard_list(items: Sequence, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> List:
    """This process's slice of a dataset list (entries, paths, ...)."""
    start, end = host_shard_range(len(items), process_index, process_count)
    return list(items[start:end])


def global_batch_from_host_shards(local_batch, mesh):
    """This rank's local batch on the mesh's device.

    PyTorch has no global array: where JAX assembles one jax.Array of
    global shape (global_B, ...) from every host's local rows, each rank
    here keeps its own (local_B, ...) rows, and the collectives of
    `parallel.mesh` stand in for the global view. `local_batch` is a
    tensor, a numpy array, or a dict, NamedTuple, list or tuple of them."""
    return map_arrays(lambda x: torch.as_tensor(x).to(mesh.device),
                      local_batch)
