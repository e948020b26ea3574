"""The training cells' common part: set-up builds one training state,
drives it from the seed through its first three steps by the window's own
call, records what the comparison needs, and hands the same state to the
window; after the window one more step runs by the same call, from the
state the window left. The reference follows the first three steps from
the seed, and computes the late step's losses at the parameters that
step started from.

Compared, after the window: the first step's losses and each of the
three steps' (relative gaps); the first gradient as the optimizer got it
(read by hooks on the parameters as autograd hands it over), by the
worst leaf's gap of norms and by the worst leaf's norm of the
difference; the parameters' change over the three steps (read before
step 4), by the worst leaf's gap of norms; and the late step's losses
that depend on its starting parameters alone (relative gaps). Leaves are
those that the reference's gradient moves.
"""

from __future__ import annotations

import math
import sys
import traceback
from typing import Dict, List, NamedTuple

import torch

from benchmark.harness.checks import (Check, leaf_diffs, leaf_gaps,
                                      moved_leaves, norms, tf32)
from benchmark.harness.program import Ctx, build_model, port_config
from benchmark.reference.params import make_params
from benchmark.traffic.bank import make_bank
from benchmark.traffic.mixing import replay_batch

STEPS = 3


class Record(NamedTuple):
    losses: List[List[float]]           # per step, per loss
    grads: Dict[str, torch.Tensor]      # first step's gradient, by leaf
    params: Dict[str, torch.Tensor]     # after STEPS steps, by leaf
    late: List[float]                   # the late step's `late_keys` losses


class Late(NamedTuple):
    """The step after the window: what it started from, and its losses."""
    params: Dict[str, torch.Tensor]     # the parameters the window left
    generator: torch.Tensor             # the batch generator's state then
    losses: List[float]                 # the program's `late_keys` losses


class TrainDriver:
    kind = "train"
    loss_keys: tuple = ()
    late_keys: tuple = ()    # the losses a step computes before it updates

    def make_step(self, cfg, steps_per_epoch):
        raise NotImplementedError

    def step_once(self):
        """One step through the window's own call; returns its metrics."""
        raise NotImplementedError

    def __init__(self, ctx: Ctx):
        from dl4ss_tpu_torch.train.state import create_train_state
        self.ctx = ctx
        self.cfg = cfg = port_config(ctx.config)
        if ctx.traffic["batch"] != cfg.batch_size:
            raise ValueError("the traffic's batch differs from the "
                             "configuration's")
        self.mixtures_per_unit = cfg.batch_size
        model = build_model(ctx, cfg)
        self.state = create_train_state(cfg, 0, cfg.epoch_size, ctx.device,
                                        model=model)
        self.state.generator = torch.Generator().manual_seed(
            ctx.sub_seed("batches"))
        bank = ctx.traffic["bank"]
        self.bank = make_bank(ctx.sub_seed("bank"), cfg.num_speakers,
                              bank["utterances"], cfg.max_len, cfg.frame_rate,
                              ctx.device)
        self.step = self.make_step(cfg, cfg.epoch_size)
        # the first step's gradient of each leaf, the first that autograd
        # hands over (a discriminator's comes in phase 1)
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
        self.record = Record(losses, grads, {
            n: p.detach().clone() for n, p in model.named_parameters()}, [])
        self.late = None
        self.window_losses: List[torch.Tensor] = []
        for _ in range(ctx.traffic["warmup_units"]):
            self.unit()
        self.sync()
        self.window_losses.clear()

    def unit(self):
        m = self.step_once()
        self.window_losses.extend(m[k] for k in self.loss_keys)
        return None

    def sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def nonfinite(self) -> int:
        if not self.window_losses:
            return 0
        k = len(self.loss_keys)
        ok = torch.isfinite(torch.stack(self.window_losses).float())
        return int((~ok.reshape(-1, k).all(dim=1)).sum())

    def after_window(self) -> None:
        """One more step by the window's own call, from the state the
        window left; a step that raises reads as not-a-number."""
        params = {n: p.detach().clone()
                  for n, p in self.state.model.named_parameters()}
        gen = self.state.generator.get_state()
        try:
            m = self.step_once()
            losses = [float(m[k]) for k in self.late_keys]
        except Exception:
            traceback.print_exc(file=sys.stderr)
            losses = [math.nan] * len(self.late_keys)
        self.late = Late(params, gen, losses)

    def free_program(self) -> None:
        self.state = self.step = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def ref_step(self, params, opts, batch, c):
        raise NotImplementedError

    def ref_late(self, params, batch, c):
        """The reference's `late_keys` losses at `params` on `batch`."""
        raise NotImplementedError

    def ref_optimizers(self, params, c):
        raise NotImplementedError

    def reference_record(self, tf32_on: bool = False,
                         rows: slice = slice(None)) -> Record:
        """The reference's first STEPS steps on the same weights and
        batches, and the late step's losses at the parameters it started
        from, in float32 (TF32 off) or, for the control, in TF32; `rows`
        keeps part of each batch (a planted fault)."""
        c = self.ctx.ref
        params = make_params(c, self.ctx.sub_seed("weights"), self.ctx.device)
        opts = self.ref_optimizers(params, c)
        gen = torch.Generator().manual_seed(self.ctx.sub_seed("batches"))

        def batch_from(g):
            batch = replay_batch(g, self.bank, c)
            return type(batch)(*(x[rows] for x in batch))

        losses, grads = [], None
        with tf32(tf32_on):
            for i in range(STEPS):
                step_losses, step_grads = self.ref_step(
                    params, opts, batch_from(gen), c)
                losses.append(list(step_losses))
                if i == 0:
                    grads = step_grads
            late = []
            if self.late is not None:
                gen.set_state(self.late.generator)
                late = list(self.ref_late(self.late.params, batch_from(gen),
                                          c))
        return Record(losses, grads, params, late)

    def compare(self, got: Record, ref: Record) -> List[Check]:
        return [Check(name, max(per.values()), self.ctx.limits[name])
                for name, per in self.readings(got, ref).items()]

    def readings(self, got: Record, ref: Record) -> Dict[str, dict]:
        """Each compared number's parts: per step and loss, or per leaf."""
        p0 = make_params(self.ctx.ref, self.ctx.sub_seed("weights"),
                         self.ctx.device)
        gaps = {f"step{i + 1}.{j}": abs(g - r) / abs(r)
                for i, (gs, rs) in enumerate(zip(got.losses, ref.losses))
                for j, (g, r) in enumerate(zip(gs, rs))}
        ref_g = norms(ref.grads)
        moved = moved_leaves(ref_g)
        # a leaf that the program's autograd never reached has no gradient
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
            "window_loss_gap": late}

    def program_record(self) -> Record:
        """What the program did: set-up's record with the late losses."""
        return self.record._replace(
            late=self.late.losses if self.late else [])

    def checks(self) -> List[Check]:
        return self.compare(self.program_record(), self.reference_record())
