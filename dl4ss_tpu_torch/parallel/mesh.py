"""Device mesh and sharding policy (the port of `dl4ss_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a (data, model) `Mesh` and lets XLA
insert the collectives. Here every device is one process, a rank of a
`torch.distributed` group, at coordinates (rank // mp, rank % mp) of the
same (data, model) grid, and the collectives are written out:

  * the batch's leading axis is split over `data` (`shard_batch`): each
    rank keeps its rows of the global batch;
  * every parameter is replicated but the speaker-embedding table, which is
    row-sharded over `model` when mp > 1 divides its rows
    (`param_sharding`); its lookup reads the local rows and sums them over
    the model group (`Mesh.model_sum`);
  * rank 0's state is broadcast once at the start (`shard_state`);
  * the gradients are averaged over the data group as one flat buffer
    before the global-norm clip, whose norm counts the sharded table once
    (`reduce_gradients`); the logged metrics and the eval scores are means
    over the data group (`mean_metrics`, `Mesh.data_mean`);
  * the speaker memory's write sums its one-hot product over the data
    group with an all-reduce whose backward all-reduces the gradient
    (`Mesh.data_sum`), as JAX's `.at[].add` sums the global batch.

The mean of the ranks' means is the global mean only for equal shards,
which is why `mesh_for_cfg` requires dp | batch_size. The Inception
trunk's batch norm is eval-mode and folded (models/inception.py), so no
batch statistics need synchronising across ranks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from dl4ss_tpu_torch.device import resolve_device

# param_sharding's specs, as JAX's PartitionSpecs read: rows over `model`
ROWS = ("model", None)
REPLICATED = ()


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) layout of dp x mp ranks: its
    coordinates, its device and the groups it reduces over (`data_group`:
    the dp ranks of its model index; `model_group`: the mp ranks of its
    data index). Without a process group the groups are None: a layout
    that shards batches and parameters but runs no collective."""
    dp: int
    mp: int
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.mp}

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _group(self, axis: str):
        group = self.data_group if axis == "data" else self.model_group
        if group is None:
            raise RuntimeError(
                f"the mesh {self.shape} has no process group: start its "
                f"ranks with torch.distributed before reducing over {axis}")
        return group

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data group; the backward sums the gradient too
        (each rank's rows reach every rank's loss)."""
        if self.dp == 1:
            return x
        return _SumBothWays.apply(x, self._group("data"))

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the model group; the backward passes the gradient
        through, because every rank of a model group computes the same
        loss from the sum."""
        if self.mp == 1:
            return x
        return _SumForward.apply(x, self._group("model"))

    @torch.no_grad()
    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the data group, out of the graph (metrics)."""
        if self.dp == 1:
            return x
        out = x.detach().float().clone()
        dist.all_reduce(out, group=self._group("data"))
        return out / self.dp

    @torch.no_grad()
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of `x`, from every rank of the data
        group, in rank order."""
        if self.dp == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.dp)]
        dist.all_gather(parts, x.contiguous(), group=self._group("data"))
        return torch.cat(parts)

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()


class _SumBothWays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumBothWays.apply(grad, ctx.group), None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(eq=False)
class RowShard:
    """Rows [start, start + local rows) of a `rows`-row table live on this
    rank; the lookup sums over `mesh`'s model group."""
    start: int
    rows: int
    mesh: Mesh


def rank_and_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def available_devices(device=None) -> int:
    """The devices a layout may take before any group is up: the visible
    cards on CUDA, one per core on the CPU (each rank a process)."""
    if torch.device("cuda" if device is None else device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def rank_device(device=None) -> torch.device:
    """This rank's device: on CUDA the card it selected with
    `torch.cuda.set_device` (card `rank` under `run_ranks`, card
    LOCAL_RANK under torchrun), else the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: Optional[int] = None, mp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The (data, model) layout of dp x mp ranks over `devices` (rank r on
    devices[r]; default: every rank on its `rank_device`). Validates
    nothing, like JAX's `make_mesh`. When a process group is up, every
    rank must call it, in the same order: it creates the data and model
    groups."""
    rank, world = rank_and_world()
    devices = [rank_device()] * world if devices is None else list(devices)
    if dp is None:
        dp = len(devices) // mp
    data_group = model_group = None
    if dist.is_available() and dist.is_initialized():
        for m in range(mp):
            group = dist.new_group([d * mp + m for d in range(dp)])
            if rank % mp == m:
                data_group = group
        for d in range(dp):
            group = dist.new_group([d * mp + m for m in range(mp)])
            if rank // mp == d:
                model_group = group
    return Mesh(dp, mp, rank, torch.device(devices[rank]), data_group,
                model_group)


def validate_layout(cfg, n_dev: int) -> None:
    """Raise ValueError, with JAX's messages, unless the dp x mp layout
    fits `n_dev` devices and dp divides the batch evenly."""
    dp, mp = cfg.dp_size, cfg.mp_size
    if dp * mp > n_dev:
        raise ValueError(
            f"dp_size*mp_size = {dp}*{mp} exceeds the "
            f"{n_dev} available device(s)")
    if cfg.batch_size % dp:
        raise ValueError(
            f"dp_size={dp} must divide batch_size="
            f"{cfg.batch_size} for even batch sharding")


def mesh_for_cfg(cfg, device=None) -> Optional[Mesh]:
    """Validated (data, model) mesh from cfg.dp_size / mp_size, None on a
    1x1 layout: the gate every trainer (joint, dense, adversarial,
    classifier, memory, query) goes through, so `--dp` is never a silently
    inert flag. Needs a process group of dp x mp ranks (`run.train` starts
    them, or torchrun). The devices counted are the group's, one a rank on
    every node, as JAX counts every process's devices; before a group is
    up, this machine's."""
    dp, mp = cfg.dp_size, cfg.mp_size
    if dp * mp <= 1:
        return None
    _, world = rank_and_world()
    validate_layout(cfg, world if world > 1 else available_devices(device))
    if world != dp * mp:
        raise ValueError(
            f"dp_size*mp_size = {dp}*{mp} needs {dp * mp} ranks in a "
            f"torch.distributed group, found {world}: start them with "
            f"run.train --dp/--mp or torchrun")
    return make_mesh(dp, mp, [rank_device(device)] * world)


def map_arrays(fn, tree):
    """`fn` on every array (anything with a shape) of a dict, NamedTuple,
    list or tuple of them; other leaves (None, ints) pass through."""
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_arrays(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    return fn(tree) if hasattr(tree, "shape") else tree


def batch_sharding(mesh: Mesh) -> tuple:
    """The spec `shard_batch` applies: the leading axis over `data`,
    everything else whole."""
    return ("data",)


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows of a global batch: every array's leading axis split
    over `data` (a dict, NamedTuple, list or tuple of them). No mesh, or
    dp = 1, leaves it as it is."""
    if mesh is None or mesh.dp == 1:
        return batch

    def take(x):
        if x.shape[0] % mesh.dp:
            raise ValueError(f"a leading axis of {x.shape[0]} does not "
                             f"split evenly over dp={mesh.dp}")
        n = x.shape[0] // mesh.dp
        return x[mesh.data_index * n:(mesh.data_index + 1) * n]

    return map_arrays(take, batch)


def mean_metrics(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """A step's metrics as means over the data group (each rank's are
    means over its equal share of the batch), in one all-reduce; the grad
    norm is global already (`reduce_gradients`)."""
    if mesh is None or mesh.dp == 1:
        return metrics
    names = [k for k, v in metrics.items()
             if k != "grad_norm" and torch.is_tensor(v)]
    if not names:
        return metrics
    means = mesh.data_mean(torch.stack([metrics[k].detach().float()
                                        for k in names]))
    return {**metrics, **dict(zip(names, means.unbind()))}


def reduce_gradients(params: List[torch.Tensor], grads: List[torch.Tensor],
                     mesh: Mesh) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The gradients averaged over the data group (one flat all-reduce),
    and their global norm, `optax.global_norm` of the single-device run:
    the replicated parameters counted once, a row-sharded table's local
    rows summed over the model group."""
    if mesh.dp > 1:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh._group("data"))
        flat /= mesh.dp
        grads = [part.view_as(g) for g, part in
                 zip(grads, flat.split([g.numel() for g in grads]))]
    sharded = [getattr(p, "row_sharded", False) for p in params]
    rep = [g for g, s in zip(grads, sharded) if not s]
    rows = [g for g, s in zip(grads, sharded) if s]
    sq = torch.stack(torch._foreach_norm(rep)).square().sum()
    if rows:                      # only under mp > 1 (`_shard_rows`)
        sq_rows = torch.stack(torch._foreach_norm(rows)).square().sum()
        dist.all_reduce(sq_rows, group=mesh._group("model"))
        sq = sq + sq_rows
    return grads, sq.sqrt()


def param_sharding(mesh: Mesh, model: nn.Module) -> Dict[str, tuple]:
    """Spec by parameter name: the embedding table row-sharded over `model`
    (ROWS) when the mesh has a model axis that divides its rows, every
    other parameter REPLICATED."""
    def rule(name, p):
        keys = name.split(".")
        if "embedding" in keys and "table" in keys and mesh.mp > 1 \
                and p.shape[0] % mesh.mp == 0:
            return ROWS
        return REPLICATED

    return {n: rule(n, p) for n, p in model.named_parameters()}


@torch.no_grad()
def replicated(tensors: Sequence[torch.Tensor]) -> None:
    """Broadcast `tensors` from rank 0 to every rank of the group, in
    place: what JAX's replicated sharding puts on every device."""
    if not dist.is_initialized():
        return
    for t in tensors:
        dist.broadcast(t, src=0)


def _moment_index(state, param) -> int:
    from dl4ss_tpu_torch.train.state import generator_params
    return next(i for i, p in enumerate(generator_params(state.model))
                if p is param)


def shard_state(state, mesh: Mesh):
    """Rank 0's train state (a TrainState or MemoryTrainState) on every
    rank: its parameters and buffers, optimizer moments and counts, step,
    batch generator and speaker memory broadcast once; then the tables
    `param_sharding` names keep only this rank's rows, with their Adam
    moments. In place; returns the state."""
    tensors = list(state.model.state_dict().values())
    opts = [s for s in (state.opt_state, getattr(state, "d_opt_state", None))
            if s is not None]
    for opt in opts:
        tensors += list(opt.mu) + list(opt.nu)
    memory = getattr(state, "memory", None)
    if memory is not None:
        tensors += [memory.vectors, memory.age]
    gen = state.generator.get_state().to(mesh.device)
    counts = torch.tensor([state.step] + [o.count for o in opts],
                          device=mesh.device)
    replicated(tensors + [gen, counts])
    state.generator.set_state(gen.cpu())
    state.step = int(counts[0])
    for opt, count in zip(opts, counts[1:].tolist()):
        opt.count = int(count)
    _shard_rows(state, mesh)
    return state


def _shard_rows(state, mesh: Mesh) -> None:
    for name, spec in param_sharding(mesh, state.model).items():
        if spec != ROWS:
            continue
        path, attr = name.rsplit(".", 1)
        module = state.model.get_submodule(path)
        full = getattr(module, attr)
        i = _moment_index(state, full)
        n = full.shape[0] // mesh.mp
        lo = mesh.model_index * n
        local = nn.Parameter(full.detach()[lo:lo + n].clone())
        local.row_sharded = True
        setattr(module, attr, local)
        module.shard = RowShard(lo, full.shape[0], mesh)
        for moments in (state.opt_state.mu, state.opt_state.nu):
            moments[i] = moments[i][lo:lo + n].clone()


def _gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.mp)]
    dist.all_gather(parts, x.detach().contiguous(),
                    group=mesh._group("model"))
    return torch.cat(parts)


@torch.no_grad()
def unshard_state(state, mesh: Optional[Mesh]):
    """The inverse of `shard_state`'s row split: every row-sharded table,
    and its moments, gathered whole on every rank (a collective: every rank
    calls it), so that the state is the one a single-device run holds. In
    place; returns the state."""
    if mesh is None or mesh.mp == 1:
        return state
    for name, p in list(state.model.named_parameters()):
        if not getattr(p, "row_sharded", False):
            continue
        path, attr = name.rsplit(".", 1)
        module = state.model.get_submodule(path)
        i = _moment_index(state, p)
        setattr(module, attr, nn.Parameter(_gather_rows(p, mesh)))
        module.shard = None
        for moments in (state.opt_state.mu, state.opt_state.nu):
            moments[i] = _gather_rows(moments[i], mesh)
    return state


def save_on_main(mesh: Optional[Mesh], state, save) -> None:
    """`save(state)` on rank 0 with the state whole (the file a
    single-device run writes); the other ranks wait at a barrier."""
    if mesh is None:
        save(state)
        return
    unshard_state(state, mesh)
    if mesh.is_main:
        save(state)
    _shard_rows(state, mesh)
    mesh.barrier()


def describe_layout(mesh: Mesh, model: nn.Module) -> str:
    """One line: the mesh, the backend and any row-sharded parameter's
    rows on this rank."""
    line = (f"mesh: data {mesh.dp} x model {mesh.mp} over "
            f"{dist.get_backend()}, rank {mesh.rank} on {mesh.device}")
    for name, module in model.named_modules():
        shard = getattr(module, "shard", None)
        if shard is not None:
            n = module.table.shape[0]
            line += (f"; {name}.table rows {shard.start}:{shard.start + n}"
                     f" of {shard.rows}")
    return line
