"""Target-speaker extraction through the life-long speaker memory in
closed loop, as `run.train --preset cocktail --mode memory` runs it: the
state of `create_memory_state(cfg, seed, "speech")`, and each unit one
step of `make_memory_train_step(cfg, "speech")` on a batch of
`memory_batch`, drawn by the program from the device-resident bank (the
first speaker the target, its clean magnitudes the voiceprint's input).

Compared as `harness/training.py` compares (the first step's losses,
each of the three steps', the first gradient, the parameters' change, the
late step's loss), the reference (`reference/memory.py`) following the
same weights, batches and memory, and one more reading, `memory_gap`: the
memory after the three steps, row by row, the norm of the difference
from the reference's row over that row's norm (a row the reference never
wrote is zero there, and the program's row's norm is read), with the
count of write counts (ages) that differ from the reference's added.
The late step starts from the memory the window left, on both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch

from benchmark.harness import flopcount as fc
from benchmark.harness.checks import (leaf_diffs, leaf_gaps, moved_leaves,
                                      norms, tf32)
from benchmark.harness.program import Ctx, port_config
from benchmark.harness.training import STEPS, TrainDriver
from benchmark.reference import memory as ref_memory
from benchmark.traffic.bank import make_bank
from benchmark.traffic.mixing import replay_batch


def count(layers, c: dict, b: int) -> fc.Count:
    """A step of `b` mixtures: the STFT of the mixtures and their K
    sources; the memory model's forward and backward (twice the
    forward); the write outside the gradient."""
    model = layers.memory_model(c, b)
    return fc.Count(fc.stft(c, b * (1 + c["max_mix"])) + 3 * model.model
                    + layers.write(c, b),
                    model.recurrence + fc.backward(model.recurrence))


class MemoryRecord(NamedTuple):
    losses: List[List[float]]
    grads: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]
    late: List[float]
    memory: ref_memory.Memory           # after STEPS steps


class Driver(TrainDriver):
    loss_keys = ("loss",)
    late_keys = ("loss",)

    def __init__(self, ctx: Ctx):
        from dl4ss_tpu_torch.train.memory_trainer import (
            create_memory_state, make_memory_train_step)
        self.ctx = ctx
        self.cfg = cfg = port_config(ctx.config)
        if ctx.traffic["batch"] != cfg.batch_size:
            raise ValueError("the traffic's batch differs from the "
                             "configuration's")
        self.mixtures_per_unit = cfg.batch_size
        self.state = create_memory_state(cfg, 0, "speech", cfg.epoch_size,
                                         device=ctx.device)
        model = self.state.model
        model.load_state_dict(self.initial_params(), strict=True)
        self.state.generator = torch.Generator().manual_seed(
            ctx.sub_seed("batches"))
        self.bank = make_bank(ctx.sub_seed("bank"), cfg.num_speakers,
                              ctx.traffic["bank"]["utterances"], cfg.max_len,
                              cfg.frame_rate, ctx.device)
        self.step = make_memory_train_step(cfg, "speech", cfg.epoch_size)
        # the first step's gradient of each leaf, as autograd hands it over
        grads: Dict[str, torch.Tensor] = {}
        hooks = [p.register_hook(
            lambda g, n=n: grads.setdefault(n, g.detach().clone()))
            for n, p in model.named_parameters()]
        losses = []
        for i in range(STEPS):
            m = self.step_once()
            losses.append([float(m[k]) for k in self.loss_keys])
            if i == 0:
                for h in hooks:
                    h.remove()
        self.record = MemoryRecord(
            losses, grads,
            {n: p.detach().clone() for n, p in model.named_parameters()}, [],
            self.memory_now())
        self.late = None
        self.late_memory = None
        self.window_losses: List[torch.Tensor] = []
        for _ in range(ctx.traffic["warmup_units"]):
            self.unit()
        self.sync()
        self.window_losses.clear()

    def initial_params(self) -> Dict[str, torch.Tensor]:
        return ref_memory.make_params(self.ctx.ref,
                                      self.ctx.sub_seed("weights"),
                                      self.ctx.device)

    def memory_now(self) -> ref_memory.Memory:
        mem = self.state.memory
        return ref_memory.Memory(mem.vectors.detach().clone(),
                                 mem.age.clone())

    def step_once(self):
        from dl4ss_tpu_torch.train.memory_trainer import memory_batch
        feats = memory_batch(self.state.generator, self.bank, self.cfg)
        self.state, metrics = self.step(self.state, feats)
        return metrics

    def after_window(self) -> None:
        """The late step as `TrainDriver`'s, from the memory the window
        left too."""
        self.late_memory = self.memory_now()
        super().after_window()

    def reference_record(self, tf32_on: bool = False,
                         rows: slice = slice(None)) -> MemoryRecord:
        """The reference's first STEPS steps from the seed's weights and an
        empty memory on the replayed batches, and the late step's loss at
        the parameters and memory it started from, in float32 (TF32 off)
        or, for the control, in TF32; `rows` keeps part of each batch (a
        planted fault)."""
        c = self.ctx.ref
        params = self.initial_params()
        opt = ref_memory.optimizer(params, c)
        memory = ref_memory.empty_memory(c, self.ctx.device)
        gen = torch.Generator().manual_seed(self.ctx.sub_seed("batches"))

        def batch_from(g):
            batch = replay_batch(g, self.bank, c)
            return type(batch)(*(x[rows] for x in batch))

        losses, grads = [], None
        with tf32(tf32_on):
            for i in range(STEPS):
                loss, step_grads, memory = ref_memory.memory_step(
                    params, opt, memory, batch_from(gen), c)
                losses.append([loss])
                if i == 0:
                    grads = step_grads
            late = []
            if self.late is not None:
                gen.set_state(self.late.generator)
                late = list(ref_memory.memory_late(
                    self.late.params, self.late_memory, batch_from(gen), c))
        return MemoryRecord(losses, grads, params, late, memory)

    def readings(self, got: MemoryRecord, ref: MemoryRecord
                 ) -> Dict[str, dict]:
        """`TrainDriver.readings` from this model's weights, and
        `memory_gap`."""
        p0 = self.initial_params()
        gaps = {f"step{i + 1}.{j}": abs(g - r) / abs(r)
                for i, (gs, rs) in enumerate(zip(got.losses, ref.losses))
                for j, (g, r) in enumerate(zip(gs, rs))}
        ref_g = norms(ref.grads)
        moved = moved_leaves(ref_g)
        got_g = {n: got.grads.get(n, torch.zeros_like(ref.grads[n]))
                 for n in moved}
        late = ({f"late.{j}": abs(g - r) / abs(r)
                 for j, (g, r) in enumerate(zip(got.late, ref.late))}
                if ref.late else {"late": math.nan})
        return {
            "loss1_gap": {k: v for k, v in gaps.items()
                          if k.startswith("step1.")},
            "loss_gap": gaps,
            "grad_gap": leaf_gaps(norms(got_g), ref_g, moved),
            "grad_diff": leaf_diffs(got_g, ref.grads, moved),
            "change_gap": leaf_gaps(
                norms({n: got.params[n] - p0[n] for n in moved}),
                norms({n: ref.params[n] - p0[n] for n in moved}), moved),
            "window_loss_gap": late,
            "memory_gap": memory_gaps(got.memory, ref.memory)}


def memory_gaps(got: ref_memory.Memory, ref: ref_memory.Memory
                ) -> Dict[str, float]:
    """Per memory row and slot, ||got - ref|| / ||ref||, or ||got|| where
    the reference's row is zero; and `age`, the count of write counts
    that differ."""
    diff = torch.linalg.vector_norm((got.vectors - ref.vectors).double(),
                                    dim=-1)
    ref_n = torch.linalg.vector_norm(ref.vectors.double(), dim=-1)
    got_n = torch.linalg.vector_norm(got.vectors.double(), dim=-1)
    gap = torch.where(ref_n > 0, diff / ref_n.clamp(min=1e-300), got_n)
    # a row that is not a number reads infinitely far
    gap = torch.nan_to_num(gap, nan=math.inf).cpu()
    out = {f"row{r}.{s}": float(gap[r, s])
           for r in range(gap.shape[0]) for s in range(gap.shape[1])}
    out["age"] = float((got.age.cpu() != ref.age.cpu()).sum())
    return out
