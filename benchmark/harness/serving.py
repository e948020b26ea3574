"""The serving cells' common part: one client in closed loop sends
requests of `batch` mixtures from a pool, in turn, each when the last
has returned, and times each from the host holding the mixtures to the
host holding the waveforms (and, with selection, the speakers picked).

Compared, after the window, on a sample of the requests drawn from the
seed: every returned waveform against the reference's for the same
mixture and speakers (the worst row's relative L2 error); with selection
a row whose picks are not the reference's top-k up to ties reads 1.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from benchmark.harness.checks import Check, rel_err, tf32
from benchmark.harness.program import Ctx, build_model, port_config
from benchmark.reference import model as ref_model
from benchmark.reference.dsp import stft
from benchmark.reference.params import make_params
from benchmark.traffic.bank import make_bank
from benchmark.traffic.mixing import request_pool

REF_BLOCK = 16      # rows the reference takes at once
# Two speakers whose reference probabilities lie within TIE are a tie:
# either pick is right. It lies above the few 1e-6 by which the TF32
# control's probabilities move (its flips of near-ties read gaps of
# 2e-6 to 1.4e-5 on the cell's seeds) and far below the 1e-2 that
# separates a classifier's typical neighbours among 103 speakers.
TIE = 1e-4


class Answer(NamedTuple):
    row: int                    # the mixture's row in the pool
    speakers: Tuple[int, ...]   # given, or picked (most probable first)
    waves: torch.Tensor         # (K, N) on the host


class ServeDriver:
    kind = "serve"
    select = False

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.cfg = cfg = port_config(ctx.config)
        tr = ctx.traffic
        self.batch, pool = tr["batch"], tr["pool"]
        if pool % self.batch:
            raise ValueError("the pool must hold whole batches")
        self.mixtures_per_unit = self.batch
        self.model = build_model(ctx, cfg)
        bank = make_bank(ctx.sub_seed("bank"), cfg.num_speakers,
                         tr["bank"]["utterances"], cfg.max_len,
                         cfg.frame_rate, ctx.device)
        reqs = request_pool(ctx.sub_seed("pool"), bank, pool, cfg.max_mix,
                            tr["db_range"])
        self.mix = reqs.mix.cpu()
        self.spk = reqs.spk_idx.cpu()
        del bank, reqs
        self.n = self.bad = 0
        self.answers: List[Answer] = []
        self.sample_p = 0.0
        t0 = time.perf_counter()
        for _ in range(tr["warmup_units"]):
            self.unit()
        per_unit = (time.perf_counter() - t0) / tr["warmup_units"]
        # sample the window's first request and about `sample` more
        self.sample_p = min(1.0, tr["sample"] * per_unit / ctx.seconds)
        self.rng = np.random.default_rng(ctx.sub_seed("sample"))
        self.n = self.bad = 0
        self.answers.clear()

    def unit(self) -> float:
        """One request; returns its latency in seconds."""
        from dl4ss_tpu_torch.serve import (select_and_separate,
                                           separate_waveforms)
        b = self.batch
        i = self.n % (self.mix.shape[0] // b)
        self.n += 1
        rows = slice(i * b, (i + 1) * b)
        start = time.perf_counter()
        x = self.mix[rows].to(self.ctx.device)
        if self.select:
            y, idx = select_and_separate(self.model, x, self.cfg)
            y, picks = y.cpu(), idx.cpu()
        else:
            spk = self.spk[rows].to(self.ctx.device)
            y = separate_waveforms(self.model, x, self.cfg, spk_idx=spk).cpu()
            picks = self.spk[rows]
        done = time.perf_counter()
        if not np.isfinite(np.add.reduce(y.numpy(), axis=None)):
            self.bad += 1
        if self.sample_p and (not self.answers
                              or self.rng.random() < self.sample_p):
            self.answers += [Answer(i * b + j, tuple(picks[j].tolist()), y[j])
                             for j in range(b)]
        return done - start

    def sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def nonfinite(self) -> int:
        return self.bad

    def after_window(self) -> None:
        """Nothing: every request of the window is an answer to sample."""

    def free_program(self) -> None:
        self.model = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_answers(self, rows: List[int], speakers=None,
                          tf32_on: bool = False):
        """The reference's waveforms for pool rows `rows`, for the given
        speakers (a list of tuples) or, where None, for its own top-k;
        returns (answers, probabilities by row or None)."""
        c = self.ctx.ref
        dev = self.ctx.device
        params = make_params(c, self.ctx.sub_seed("weights"), dev)
        out, probs = [], {}
        with tf32(tf32_on), torch.no_grad():
            for s in range(0, len(rows), REF_BLOCK):
                blk = rows[s:s + REF_BLOCK]
                x = self.mix[blk].to(dev)
                spec = stft(x, c["frame_length"], c["frame_shift"])
                mag = spec.abs()
                p = None
                if self.select:
                    p = ref_model.classifier_probs(params, mag, c)
                    probs.update({r: p[j].cpu() for j, r in enumerate(blk)})
                if speakers is None:
                    spk = ref_model.top_k(p, c["top_k"])
                else:
                    spk = torch.tensor(speakers[s:s + REF_BLOCK], device=dev)
                masks = ref_model.separate(params, mag, spk, c).masks
                waves = ref_model.resynthesise(masks, spec, c).cpu()
                out += [Answer(r, tuple(spk[j].tolist()), waves[j])
                        for j, r in enumerate(blk)]
        return out, (probs if self.select else None)

    def acceptable(self, probs: torch.Tensor, picks) -> bool:
        """Whether `picks` are the reference's top-k up to ties: no pick's
        probability lies more than TIE below the reference's pick of that
        rank."""
        best = torch.sort(probs, descending=True).values
        return all(float(best[k] - probs[s]) <= TIE
                   for k, s in enumerate(picks))

    def compare(self, got: List[Answer]) -> List[Check]:
        """The worst row's relative L2 error of the returned waveforms
        against the reference's for the same speakers; with selection, a
        row whose picks are not the reference's top-k up to ties names
        the wrong speakers and reads 1."""
        keys = sorted({(a.row, a.speakers) for a in got})
        ref, probs = self.reference_answers([k[0] for k in keys],
                                            [k[1] for k in keys])
        by_key: Dict[tuple, torch.Tensor] = {
            (a.row, a.speakers): a.waves for a in ref}
        errs = [rel_err(a.waves, by_key[(a.row, a.speakers)])
                if not self.select
                or self.acceptable(probs[a.row], a.speakers) else 1.0
                for a in got]
        return [Check("wave_err", max(errs), self.ctx.limits["wave_err"])]

    def checks(self) -> List[Check]:
        if not self.answers:
            return [Check("answers_sampled", 0.0, -1.0)]
        return self.compare(self.answers)
