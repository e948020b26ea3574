"""DPRNN-TasNet training in closed loop, as `run.train --mode tasnet`
runs it: the state of `create_tasnet_state`, and each unit one step of
`make_tasnet_train_step` on a batch the program draws from the
device-resident bank (`sample_mixtures`, with the configuration's shift
and dB augment).

Compared as `harness/training.py` compares (the first step's loss, each
of the three steps', the first gradient, the parameters' change, the late
step's loss; a loss's gap relative to at least 1 dB), the reference
(`reference/dprnn.py`, at the configuration file's `model` widths)
following the same weights and batches, the whole batch at once: its step
loops' saved activations fit the card once the program's memory is
freed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import flopcount as fc
from benchmark.harness.checks import (leaf_diffs, leaf_gaps, moved_leaves,
                                      norms, tf32)
from benchmark.harness.program import Ctx, port_config
from benchmark.harness.first_steps import first_steps
from benchmark.harness.training import STEPS, Record, TrainDriver
from benchmark.reference import dprnn as ref_dprnn
from benchmark.traffic.bank import make_bank
from benchmark.traffic.mixing import replay_batch


# The loss is negative SI-SNR in dB, which crosses 0 dB as training goes
# (the late step's loss sits near it): a gap relative to a loss near zero
# measures nothing but that loss's nearness to zero, so below 1 dB a
# loss's gap is read in dB.
LOSS_FLOOR = 1.0


def loss_gap(got: float, ref: float) -> float:
    return abs(got - ref) / max(abs(ref), LOSS_FLOOR)


def count(layers, c: dict, b: int) -> fc.Count:
    """A step of `b` mixtures: the model's forward and backward (twice
    the forward)."""
    model = layers.dprnn(c, b)
    return fc.Count(3 * model.model,
                    model.recurrence + fc.backward(model.recurrence))


class Driver(TrainDriver):
    loss_keys = ("loss",)
    late_keys = ("loss",)

    def __init__(self, ctx: Ctx):
        from dl4ss_tpu_torch.models.dprnn import DPRNNConfig
        from dl4ss_tpu_torch.train.tasnet_trainer import (
            create_tasnet_state, make_tasnet_train_step)
        self.ctx = ctx
        self.cfg = cfg = port_config(ctx.config)
        if ctx.traffic["batch"] != cfg.batch_size:
            raise ValueError("the traffic's batch differs from the "
                             "configuration's")
        self.mixtures_per_unit = cfg.batch_size
        self.state = create_tasnet_state(
            cfg, DPRNNConfig(**ctx.config["model"]), 0, cfg.epoch_size,
            ctx.device)
        model = self.state.model
        model.load_state_dict(self.initial_params(), strict=True)
        self.state.generator = torch.Generator().manual_seed(
            ctx.sub_seed("batches"))
        self.bank = make_bank(ctx.sub_seed("bank"), cfg.num_speakers,
                              ctx.traffic["bank"]["utterances"], cfg.max_len,
                              cfg.frame_rate, ctx.device)
        self.step = make_tasnet_train_step(cfg, cfg.epoch_size)
        first_steps(self, model)

    def initial_params(self) -> Dict[str, torch.Tensor]:
        return ref_dprnn.make_params(self.ctx.config["model"],
                                     self.ctx.sub_seed("weights"),
                                     self.ctx.device)

    def step_once(self):
        self.state, metrics = self.step(self.state, self.bank)
        return metrics

    def reference_record(self, tf32_on: bool = False,
                         rows: slice = slice(None)) -> Record:
        """The reference's first STEPS steps from the seed's weights on the
        replayed batches, and the late step's loss at the parameters it
        started from, in float32 (TF32 off) or, for the control, in TF32;
        `rows` keeps part of each batch (a planted fault)."""
        c, m = self.ctx.ref, self.ctx.config["model"]
        params = self.initial_params()
        opt = ref_dprnn.optimizer(params, c)
        gen = torch.Generator().manual_seed(self.ctx.sub_seed("batches"))

        def batch_from(g):
            batch = replay_batch(g, self.bank, c)
            return type(batch)(*(x[rows] for x in batch))

        losses, grads = [], None
        with tf32(tf32_on):
            for i in range(STEPS):
                loss, step_grads = ref_dprnn.tasnet_step(
                    params, opt, batch_from(gen), m)
                losses.append([loss])
                if i == 0:
                    grads = step_grads
            late = []
            if self.late is not None:
                gen.set_state(self.late.generator)
                late = list(ref_dprnn.tasnet_late(
                    self.late.params, batch_from(gen), m))
        return Record(losses, grads, params, late)

    def readings(self, got: Record, ref: Record) -> Dict[str, dict]:
        """`TrainDriver.readings` from this model's weights, each loss's gap
        relative to the larger of the reference's loss and LOSS_FLOOR."""
        p0 = self.initial_params()
        gaps = {f"step{i + 1}.{j}": loss_gap(g, r)
                for i, (gs, rs) in enumerate(zip(got.losses, ref.losses))
                for j, (g, r) in enumerate(zip(gs, rs))}
        ref_g = norms(ref.grads)
        moved = moved_leaves(ref_g)
        got_g = {n: got.grads.get(n, torch.zeros_like(ref.grads[n]))
                 for n in moved}
        late = ({f"late.{j}": loss_gap(g, r)
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
            "window_loss_gap": late}
