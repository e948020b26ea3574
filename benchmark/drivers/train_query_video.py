"""The audio-visual GRID trainer in closed loop, as `run.train --preset
grid_video --mode video --video-trunk inception` runs it: the state of
`create_query_state(cfg, seed, "video", video_trunk="inception",
frame_hw=...)`, and each unit one step of `make_query_train_step(cfg,
"video")` on a batch of `query_batch`: mixtures drawn by the program from
the device-resident audio bank, and for each channel one of its speaker's
lip clips gathered from the uint8 frame bank on the card.

Compared as `harness/training.py` compares, over the leaves the
reference's gradient moves; the frozen trunk's leaves take no gradient on
either side and are held to no change (`change_gap`).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from benchmark.harness import flopcount as fc
from benchmark.harness.checks import (leaf_diffs, leaf_gaps, moved_leaves,
                                      norms, tf32)
from benchmark.harness.program import Ctx, port_config
from benchmark.harness.training import STEPS, Record, TrainDriver
from benchmark.reference import train as ref_train
from benchmark.reference import video as ref_video
from benchmark.traffic.bank import make_bank
from benchmark.traffic.frames import make_frames
from benchmark.traffic.mixing import replay_batch


def count(layers, c: dict, b: int) -> fc.Count:
    """A step of `b` mixtures: the STFT of the mixtures and their K
    sources; the separator's and the video query's forward and backward
    (twice the forward); the frozen trunk's forward alone."""
    k, frames = c["max_mix"], layers.video()["frames"]
    sep, query = layers.separator(c, b), layers.video_query(c, b * k, frames)
    trunk_ops, _ = layers.trunk(c, b)
    rec = sep.recurrence + query.recurrence
    return fc.Count(fc.stft(c, b * (1 + k)) + 3 * (sep.model + query.model)
                    + trunk_ops, rec + fc.backward(rec))


class Driver(TrainDriver):
    loss_keys = ("loss",)
    late_keys = ("loss",)

    def __init__(self, ctx: Ctx):
        from dl4ss_tpu_torch.models import query
        from dl4ss_tpu_torch.train.query_trainer import (
            create_query_state, make_query_train_step)
        if not hasattr(query, "normalize_frames"):
            raise RuntimeError("this program reads no uint8 lip frames "
                               "(models.query.normalize_frames)")
        self.ctx = ctx
        self.cfg = cfg = port_config(ctx.config)
        video = ctx.config["video"]
        if ctx.traffic["batch"] != cfg.batch_size:
            raise ValueError("the traffic's batch differs from the "
                             "configuration's")
        if video["bank_dtype"] != "uint8":
            raise ValueError("the frame bank is held as uint8")
        self.mixtures_per_unit = cfg.batch_size
        self.state = create_query_state(
            cfg, 0, "video", cfg.epoch_size, video_trunk=video["trunk"],
            frame_hw=tuple(video["frame_hw"]), device=ctx.device)
        model = self.state.model
        model.load_state_dict(self.initial_params(), strict=True)
        self.state.generator = torch.Generator().manual_seed(
            ctx.sub_seed("batches"))
        self.bank = make_bank(ctx.sub_seed("bank"), cfg.num_speakers,
                              ctx.traffic["bank"]["utterances"], cfg.max_len,
                              cfg.frame_rate, ctx.device)
        self.frames = make_frames(ctx.sub_seed("frames"), cfg.num_speakers,
                                  video["clips_per_speaker"],
                                  video["frames"], video["frame_hw"],
                                  ctx.device)
        self.step = make_query_train_step(cfg, "video", cfg.epoch_size)
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
        self.record = Record(losses, grads, {
            n: p.detach().clone() for n, p in model.named_parameters()}, [])
        self.late = None
        self.window_losses: List[torch.Tensor] = []
        for _ in range(ctx.traffic["warmup_units"]):
            self.unit()
        self.sync()
        self.window_losses.clear()

    def initial_params(self) -> Dict[str, torch.Tensor]:
        return ref_video.make_params(self.ctx.ref, self.ctx.sub_seed(
            "weights"), self.ctx.device)

    def step_once(self):
        from dl4ss_tpu_torch.train.query_trainer import query_batch
        feats = query_batch(self.state.generator, self.bank, self.cfg,
                            "query_video", self.frames)
        self.state, metrics = self.step(self.state, feats)
        return metrics

    def _batch(self, g: torch.Generator, c: dict, rows: slice
               ) -> ref_video.VideoBatch:
        """The next batch of `g` as `query_batch` draws it: the mixtures,
        then a clip of each channel's speaker."""
        batch = replay_batch(g, self.bank, c)
        clip = torch.randint(0, self.frames.shape[1], batch.spk_idx.shape,
                             generator=g).to(self.bank.device)
        full = ref_video.VideoBatch(*batch,
                                    self.frames[batch.spk_idx, clip])
        return ref_video.VideoBatch(*(x[rows] for x in full))

    def reference_record(self, tf32_on: bool = False,
                         rows: slice = slice(None)) -> Record:
        c = self.ctx.ref
        params = self.initial_params()
        opt = ref_train.Adam(params, ref_train.generator_names(params), c)
        gen = torch.Generator().manual_seed(self.ctx.sub_seed("batches"))
        losses, grads = [], None
        with tf32(tf32_on):
            for i in range(STEPS):
                loss, step_grads = ref_video.query_step(
                    params, opt, self._batch(gen, c, rows), c)
                losses.append([loss])
                if i == 0:
                    grads = step_grads
            late = []
            if self.late is not None:
                gen.set_state(self.late.generator)
                late = list(ref_video.query_late(
                    self.late.params, self._batch(gen, c, rows), c))
        return Record(losses, grads, params, late)

    def readings(self, got: Record, ref: Record) -> Dict[str, dict]:
        """As `TrainDriver.readings`, over the leaves outside the frozen
        trunk; the trunk's leaves join `change_gap` by the norm of their
        change over the median moved leaf's reference change."""
        p0 = self.initial_params()
        trunk = set(ref_video.trunk_names(p0))
        gaps = {f"step{i + 1}.{j}": abs(g - r) / abs(r)
                for i, (gs, rs) in enumerate(zip(got.losses, ref.losses))
                for j, (g, r) in enumerate(zip(gs, rs))}
        ref_g = norms({n: g for n, g in ref.grads.items() if n not in trunk})
        moved = moved_leaves(ref_g)
        got_g = {n: got.grads.get(n, torch.zeros_like(ref.grads[n]))
                 for n in moved}
        late = ({f"late.{j}": abs(g - r) / abs(r)
                 for j, (g, r) in enumerate(zip(got.late, ref.late))}
                if ref.late else {"late": math.nan})
        ref_change = norms({n: ref.params[n] - p0[n] for n in moved})
        change = leaf_gaps(norms({n: got.params[n] - p0[n] for n in moved}),
                           ref_change, moved)
        med = statistics.median(ref_change.values())
        change.update({n: v / med for n, v in norms(
            {n: got.params[n] - p0[n] for n in trunk}).items()})
        return {
            "loss1_gap": {k: v for k, v in gaps.items()
                          if k.startswith("step1.")},
            "loss_gap": gaps,
            "grad_gap": leaf_gaps(norms(got_g), ref_g, moved),
            "grad_diff": leaf_diffs(got_g, ref.grads, moved),
            "change_gap": change,
            "window_loss_gap": late}
