"""TDAA's adversarial step on batches of the wsj0-2mix lists, with the
dis-sp real pool (other utterances of the mixed speakers): the batch made
from the list entries the program drew (`traffic/lists.py`, whose
`Decoded` reads each utterance from its PCM16 wav with the standard
library), then the adversarial step of `reference/train.py` with that
pool as the discriminator's real side.

Mixing (the list recipe): each utterance cut to `max_len`,
mean-subtracted and peak-normalised, zero-padded, rolled right by its
shift, scaled by 10^(gain_dB / 20); the mixture is the sum. The real
pool's spectra are the |STFT| of the drawn utterances, not rolled.
"""

from __future__ import annotations

import torch

from benchmark.reference import model
from benchmark.reference.dsp import stft
from benchmark.reference.train import Adam, _grads, features, pit_mse
from benchmark.traffic.lists import Decoded, ListReplay, Replayed
from benchmark.traffic.mixing import Batch


def make_batch(replay: ListReplay, got: Replayed, decoded: Decoded,
               c: dict):
    """(Batch, the real pool's |STFT| (B, K, T, F)) of a replayed list
    batch."""
    srcs, reals, spk = [], [], []
    for b, e in enumerate(got.entries):
        paths, gains = replay.entries[e]
        row_src, row_real, row_spk = [], [], []
        for k, (p, g) in enumerate(zip(paths, gains)):
            s = replay.spk2idx[replay.speaker(p)]
            wav = torch.roll(decoded(p), int(got.shifts[b, k]))
            row_src.append(wav * 10.0 ** (float(g) / 20.0))
            other = replay.same_speaker_row(s, replay.row[p],
                                            int(got.draws[b, k]))
            row_real.append(decoded(replay.paths[other]))
            row_spk.append(s)
        srcs.append(torch.stack(row_src))
        reals.append(torch.stack(row_real))
        spk.append(row_spk)
    sources = torch.stack(srcs)
    real = stft(torch.stack(reals), c["frame_length"],
                c["frame_shift"]).abs()
    return (Batch(sources.sum(dim=1), sources,
                  torch.tensor(spk, device=sources.device)), real)


def d_loss_of(params, mix, real, spk_idx, c: dict) -> torch.Tensor:
    """The discriminator's MSE-GAN loss: the real pool against the
    separator's detached output."""
    with torch.no_grad():
        fake = model.separate(params, mix, spk_idx, c).pred
    return (((model.discriminator(params, real) - 1.0) ** 2).mean()
            + (model.discriminator(params, fake) ** 2).mean())


def adversarial_step(params, g_opt: Adam, d_opt: Adam, batch,
                     real: torch.Tensor, c: dict):
    """`reference/train.py`'s adversarial step with `real` as the
    discriminator's real side. Returns ((d_loss, g_loss), the gradients of
    both optimizers as they get them, before their clip)."""
    mix, src = features(batch, c)
    with torch.enable_grad():
        d_leaves = {n: params[n].detach().requires_grad_()
                    for n in d_opt.names}
        d_loss = d_loss_of(dict(params, **d_leaves), mix, real,
                           batch.spk_idx, c)
        grads = _grads(d_loss, d_leaves, d_opt.names)
    d_opt.update(params, grads)
    with torch.enable_grad():
        g_leaves = {n: params[n].detach().requires_grad_()
                    for n in g_opt.names}
        p = dict(params, **g_leaves)
        out = model.separate(p, mix, batch.spk_idx, c)
        mask_l = pit_mse(out.pred, src)
        sum_l = ((out.masks.sum(dim=1) - 1.0) ** 2).mean()
        fool = ((model.discriminator(p, out.pred) - 1.0) ** 2).mean()
        g_loss = mask_l + 0.5 * sum_l + fool
        g_grads = _grads(g_loss, g_leaves, g_opt.names)
    g_opt.update(params, g_grads)
    grads.update(g_grads)
    return (float(d_loss.detach()), float(g_loss.detach())), grads


def adversarial_late(params, batch, real: torch.Tensor, c: dict):
    """The step's phase-1 loss at `params` on `batch`."""
    mix, _ = features(batch, c)
    with torch.no_grad():
        return (float(d_loss_of(params, mix, real, batch.spk_idx, c)),)
