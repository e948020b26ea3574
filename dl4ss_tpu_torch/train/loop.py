"""The epoch/batch training loop (the port of `dl4ss_tpu/train/loop.py`),
joint and classifier modes from an utterance bank.

Mirrors the reference main loop (MAX_EPOCH x EPOCH_SIZE with a per-epoch
SDR, Torch_multi/main_run.py:453-527): each step samples and featurizes a
batch from the device-resident bank and trains on it; each `eval_every`
epochs a held-out batch (no augmentation) is scored by SI-SDR.
Checkpoints, resume and warm starts wait for the port's checkpoints
(ROADMAP P7); the dense and adversarial modes for TDAA (P9); the
list-driven sampler and the street-noise bank for the data sources (P10).
"""

from __future__ import annotations

from typing import Optional

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.synth import (featurize, make_synthetic_bank,
                                        sample_mixtures)
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.train.metrics import MetricsWriter
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.train.steps import (make_classifier_step,
                                         make_eval_step, make_fused_step)


def train_loop(cfg: Config, bank: Optional[torch.Tensor] = None,
               max_epochs: Optional[int] = None,
               epoch_size: Optional[int] = None,
               seed: int = 1,
               mode: str = "joint",
               metrics_path: Optional[str] = None,
               checkpoint_dir: Optional[str] = None,
               resume: bool = False,
               eval_every: int = 1,
               init_from: Optional[str] = None,
               device=None):
    """Train on `device` (default `cuda`; raises without a GPU unless
    device='cpu'). mode: joint (the separator) | classifier (the speaker
    classifier alone). `bank` (S, U, N) defaults to the synthetic bank of 4
    utterances per speaker from `seed`. One seed drives the bank, the init
    and the sampling (main_run.py:21-23).

    Returns (final state, list of per-epoch mean SI-SDR)."""
    if checkpoint_dir or resume or init_from:
        raise NotImplementedError("checkpoints, --resume and --init-from "
                                  "are not ported yet (ROADMAP P7)")
    if mode not in ("joint", "classifier"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet: joint "
                                  f"and classifier only (ROADMAP P9)")
    if cfg.out_sep_result:
        raise NotImplementedError("the per-epoch wav export "
                                  "(out_sep_result) is not ported yet "
                                  "(ROADMAP P11)")
    device = resolve_device(device)
    epochs = max_epochs if max_epochs is not None else cfg.max_epoch
    # horizon-aware schedules (cosine) see the real epoch budget
    cfg = cfg.replace(max_epoch=epochs)
    epoch_size = epoch_size if epoch_size is not None else cfg.epoch_size
    if bank is None:
        bank = torch.as_tensor(make_synthetic_bank(
            seed, cfg.num_speakers, 4, cfg.max_len), device=device)
    state = create_train_state(cfg, seed, epoch_size, device)
    if mode == "joint":
        run_one = make_fused_step(cfg, epoch_size)
    else:
        step_fn = make_classifier_step(cfg, epoch_size)

        def run_one(state, bank):
            batch = sample_mixtures(state.generator, bank, cfg)
            return step_fn(state, featurize(batch, cfg))
    eval_step = make_eval_step(cfg)
    writer = MetricsWriter(metrics_path)
    sdr_history = []
    try:
        for epoch in range(epochs):
            last = {}
            for _ in range(epoch_size):
                state, last = run_one(state, bank)
            record = dict(epoch=epoch, **last)
            if eval_every and (epoch + 1) % eval_every == 0:
                batch = sample_mixtures(state.generator, bank, cfg,
                                        train=False)
                ev = eval_step(state.model, featurize(batch, cfg))
                sdr = float(ev["si_sdr"].mean())
                sdr_history.append(sdr)
                record["si_sdr"] = sdr
            writer.write("epoch", state.step, **record)
    finally:
        writer.close()
    return state, sdr_history
