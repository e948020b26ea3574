"""TDAA's adversarial trainer fed from the wsj0-2mix lists, as `run.train
--preset tdaa --mode adversarial --dis-sp --list-dir ... --wav-root ...`
runs it: set-up writes the rehearsal corpus once per checkout
(`traffic/lists.py::corpus`), then `Wsj0MixSampler` decodes every
utterance the train list names (`native/loader.cc`) into one bank on the
card, and the speaker vocabulary is the lists' (the configuration's
`num_speakers` set from it, as `run.train` sets it). Each unit is the
next `Wsj0MixSampler.batches` batch of `train_loop`'s walk (epoch e
shuffled from seed + 7919 (e + 1), shifts on), `featurize`, the dis-sp
real pool by `list_same_speaker_real_specs` from the epoch's own
generator, and `make_adversarial_step`; an exhausted epoch starts the
next.

Compared as `harness/training.py` compares, the reference
(`reference/lists.py`) fed the same list batches (replayed by
`traffic/lists.py::ListReplay` and mixed from wavs decoded there).
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.harness.checks import tf32
from benchmark.harness.program import Ctx, build_model, port_config
from benchmark.harness.first_steps import first_steps
from benchmark.harness.training import Record
from benchmark.drivers.train_adversarial import Driver as Adversarial
from benchmark.drivers.train_adversarial import count  # noqa: F401
from benchmark.reference import lists as ref_lists
from benchmark.reference.params import make_params
from benchmark.traffic import lists


class Driver(Adversarial):

    def __init__(self, ctx: Ctx):
        from dl4ss_tpu_torch.data.listsampler import Wsj0MixSampler
        from dl4ss_tpu_torch.train.state import create_train_state
        cfg = port_config(ctx.config)
        self.corpus = lists.corpus(ctx.traffic["corpus"], cfg.frame_rate)
        self.sampler = Wsj0MixSampler(self.corpus / "lists", self.corpus,
                                      cfg, "train", device=ctx.device)
        config = dict(ctx.config, config=dict(
            ctx.config["config"], num_speakers=self.sampler.num_speakers))
        self.ctx = ctx = ctx._replace(config=config)
        self.cfg = cfg = port_config(config)
        if ctx.traffic["batch"] != cfg.batch_size:
            raise ValueError("the traffic's batch differs from the "
                             "configuration's")
        self.mixtures_per_unit = cfg.batch_size
        self.seed = ctx.sub_seed("lists")
        self.epoch, self.index, self.walk = 0, 0, None
        self.tables = self.sampler.spk_tables()
        self.sampler.device_bank()
        model = build_model(ctx, cfg)
        self.state = create_train_state(cfg, 0, cfg.epoch_size, ctx.device,
                                        model=model)
        self.step = self.make_step(cfg, cfg.epoch_size)
        self.first_at = []
        self.late_at = None
        first_steps(self, model,
                    before=lambda: self.first_at.append(self.position()))

    def next_batch(self):
        """The walk's next batch and its real pool."""
        from dl4ss_tpu_torch.data.listsampler import \
            list_same_speaker_real_specs
        while True:
            if self.walk is None:
                self.draws = torch.Generator().manual_seed(
                    lists.draw_seed(self.seed, self.epoch))
                self.walk = self.sampler.batches(
                    self.cfg.batch_size, shuffle=True,
                    seed=lists.epoch_seed(self.seed, self.epoch),
                    augment=self.cfg.augment_data)
            batch = next(self.walk, None)
            if batch is not None:
                break
            self.epoch, self.index, self.walk = self.epoch + 1, 0, None
        self.index += 1
        real = list_same_speaker_real_specs(
            self.draws, batch, self.sampler.device_bank(), *self.tables,
            self.cfg)
        return batch, real

    def step_once(self):
        from dl4ss_tpu_torch.data.synth import featurize
        batch, real = self.next_batch()
        feats = featurize(batch, self.cfg)
        feats["real_specs"] = real
        self.state, metrics = self.step(self.state, feats)
        return metrics

    def position(self) -> Tuple[int, int]:
        """(epoch, batch) of the walk's next batch; an epoch's end reads as
        the next epoch's first batch."""
        if self.index == self.sampler.num_batches(self.cfg.batch_size):
            return self.epoch + 1, 0
        return self.epoch, self.index

    def after_window(self) -> None:
        """The late step as `TrainDriver`'s, at the walk's next batch."""
        self.late_at = self.position()
        super().after_window()

    def free_program(self) -> None:
        self.sampler = self.walk = self.tables = None
        super().free_program()

    def replayed(self, at: Tuple[int, int], c: dict, rows: slice):
        """The reference's batch and real pool at walk position `at`."""
        if not hasattr(self, "replay"):
            self.replay = lists.ListReplay(
                self.corpus / "lists" / lists.LIST_NAME, c["max_len"])
            self.decoded = lists.Decoded(self.corpus, c["max_len"],
                                         self.ctx.device)
        got = self.replay.batch(self.seed, at[0], at[1], c["batch_size"])
        batch, real = ref_lists.make_batch(self.replay, got, self.decoded, c)
        return type(batch)(*(x[rows] for x in batch)), real[rows]

    def reference_record(self, tf32_on: bool = False,
                         rows: slice = slice(None)) -> Record:
        """The reference's first STEPS steps from the seed's weights on the
        replayed list batches, and the late step's phase-1 loss at the
        parameters it started from, in float32 (TF32 off) or, for the
        control, in TF32; `rows` keeps part of each batch (a planted
        fault)."""
        c = self.ctx.ref
        params = make_params(c, self.ctx.sub_seed("weights"), self.ctx.device)
        opts = self.ref_optimizers(params, c)
        losses, grads = [], None
        with tf32(tf32_on):
            for i, at in enumerate(self.first_at):
                batch, real = self.replayed(at, c, rows)
                step_losses, step_grads = ref_lists.adversarial_step(
                    params, opts[0], opts[1], batch, real, c)
                losses.append(list(step_losses))
                if i == 0:
                    grads = step_grads
            late = []
            if self.late is not None:
                batch, real = self.replayed(self.late_at, c, rows)
                late = list(ref_lists.adversarial_late(self.late.params,
                                                       batch, real, c))
        return Record(losses, grads, params, late)
