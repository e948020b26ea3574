"""Rank functions of tests/test_torch_parallel.py: one train step of the
port on a dp=2 (or dp=4) mesh of gloo ranks on the CPU. `parallel.launch.run_ranks`
imports this module in each spawned rank, so it imports no JAX."""

import numpy as np
import torch

from dl4ss_tpu_torch.parallel.mesh import make_mesh, shard_batch
from dl4ss_tpu_torch.weights import load_jax_params
from torch_step_parity import torch_step


def _step_on_mesh(make_step, state, feats, dp=2):
    """make_step(mesh)(state, feats) on this rank's rows of the global
    `feats` (numpy) on a dp-rank mesh: (state, metrics as floats, the
    gradients the optimizer received, after the all-reduce, by parameter
    name)."""
    mesh = make_mesh(dp, 1, devices=["cpu"] * dp)
    feats = shard_batch({k: torch.as_tensor(v) for k, v in feats.items()},
                        mesh)
    (state, metrics), grads = torch_step(lambda: make_step(mesh), state,
                                         feats)
    return state, {k: float(v) for k, v in metrics.items()}, grads


def joint_step(cfg, params, feats, dp=2):
    """The joint train step from the JAX parameter pytree `params`."""
    from dl4ss_tpu_torch.models import Separator
    from dl4ss_tpu_torch.train.state import create_train_state
    from dl4ss_tpu_torch.train.steps import make_train_step
    model = load_jax_params(Separator(cfg, device="cpu"), params)
    state = create_train_state(cfg, device="cpu", model=model)
    return _step_on_mesh(lambda mesh: make_train_step(cfg, mesh=mesh),
                         state, feats, dp)


def memory_step(cfg, params, memory, feats):
    """The memory train step from the JAX parameters and memory (numpy
    vectors and ages)."""
    from dl4ss_tpu_torch.models.memory import MemorySlots
    from dl4ss_tpu_torch.train import memory_trainer as tmt
    state = tmt.create_memory_state(cfg, device="cpu")
    load_jax_params(state.model, params)
    state.memory = MemorySlots(torch.as_tensor(np.array(memory[0])),
                               torch.as_tensor(np.array(memory[1])))
    return _step_on_mesh(
        lambda mesh: tmt.make_memory_train_step(cfg, mesh=mesh), state,
        feats)


def fail_on_rank_1():
    """Raises on rank 1 alone: the run must fail, not hang."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
