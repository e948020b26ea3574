"""DPRNN-TasNet training (`models/dprnn.py`), bank-driven as the memory
mode is: each step draws its mixtures from the device-resident utterance
bank (`sample_mixtures`, with the configuration's shift and dB augment),
separates the waveforms, scores them by negative SI-SNR under
utterance-level PIT (`eval.sisdr.si_sdr_pit`: zero-mean signals, the best
permutation's mean over the speakers, averaged over the batch), and takes
one Adam step behind the global-norm clip (`train/state.py`).

The data and optimizer fields come from the run's `Config` (`max_len`,
`batch_size`, `max_mix`, `learning_rate`, `lr_schedule`,
`grad_clip_norm`, `augment_data`, `db_range`, `use_pallas_rnn`); the
model's widths from a `DPRNNConfig`, whose C must equal `max_mix`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.synth import MixtureBatch, sample_mixtures
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.eval.sisdr import si_sdr_pit
from dl4ss_tpu_torch.models.dprnn import DPRNN, DPRNNConfig
from dl4ss_tpu_torch.train.metrics import MetricsWriter
from dl4ss_tpu_torch.train.state import AdamState, make_optimizer
from dl4ss_tpu_torch.train.steps import _backward_and_update
from dl4ss_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TasNetTrainState:
    step: int
    model: DPRNN
    opt_state: AdamState
    generator: torch.Generator      # draws the batches


def create_tasnet_state(cfg: Config, m: DPRNNConfig, seed: int = 1,
                        steps_per_epoch: int = 1, device=None
                        ) -> TasNetTrainState:
    """A fresh state: the model from `seed`, zero moments, step 0 and the
    batch generator seeded from seed + 1."""
    if m.speakers != cfg.max_mix:
        raise ValueError(f"the model separates {m.speakers} speakers, the "
                         f"mixtures hold {cfg.max_mix}")
    model = DPRNN(m, torch.Generator().manual_seed(seed),
                  resolve_device(device))
    opt = make_optimizer(cfg, steps_per_epoch)
    return TasNetTrainState(0, model, opt.init(list(model.parameters())),
                            torch.Generator().manual_seed(seed + 1))


def tasnet_loss(model: DPRNN, batch: MixtureBatch, cfg: Config
                ) -> torch.Tensor:
    """Negative SI-SNR of the separated waveforms under uPIT, averaged over
    the batch."""
    with span("forward"):
        est = model(batch.mix_wav, cfg.use_pallas_rnn)
        best, _ = si_sdr_pit(est, batch.source_wavs)
        return -best.mean()


def make_tasnet_train_step(cfg: Config, steps_per_epoch: int = 1
                           ) -> Callable:
    """step(state, bank) -> (state, {loss, grad_norm}): one batch drawn
    from `bank` (S, U, N) by the state's generator, the forward, the
    backward and the clipped Adam update, in place."""
    opt = make_optimizer(cfg, steps_per_epoch)

    def step(state: TasNetTrainState, bank: torch.Tensor):
        batch = sample_mixtures(state.generator, bank, cfg)
        loss = tasnet_loss(state.model, batch, cfg)
        grad_norm = _backward_and_update(list(state.model.parameters()),
                                         state.opt_state, opt, loss)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def tasnet_train_loop(cfg: Config, m: DPRNNConfig, bank: torch.Tensor,
                      seed: int = 1, max_epochs: Optional[int] = None,
                      epoch_size: Optional[int] = None,
                      metrics_path: Optional[str] = None, device=None):
    """Epochs of `epoch_size` steps; after each, one JSON line with the
    last step's loss and grad norm and the SI-SNR of a held-out batch
    (drawn without augment). Returns (state, the held-out SI-SNRs)."""
    epochs = max_epochs if max_epochs is not None else cfg.max_epoch
    esize = epoch_size if epoch_size is not None else cfg.epoch_size
    state = create_tasnet_state(cfg, m, seed, esize, device)
    step = make_tasnet_train_step(cfg, esize)
    writer = MetricsWriter(metrics_path)
    history = []
    try:
        for epoch in range(epochs):
            last = {}
            for _ in range(esize):
                state, last = step(state, bank)
            held = sample_mixtures(state.generator, bank, cfg, train=False)
            with torch.no_grad():
                sdr = -float(tasnet_loss(state.model, held, cfg))
            history.append(sdr)
            writer.write("epoch", state.step, epoch=epoch, si_sdr=sdr,
                         **last)
    finally:
        writer.close()
    return state, history
