"""Mixtures: the training batches the program draws, replayed, and the
request pool of the serving cells.

`replay_batch` is a frozen copy of the program's `sample_mixtures` for
k speakers with all k live (min_mix == max_mix): the same draws from the
same CPU generator, in the same order, so the reference sees the batch the
program trained on. `request_pool` makes the serving cells' mixtures.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Batch(NamedTuple):
    mix: torch.Tensor       # (B, N)
    sources: torch.Tensor   # (B, K, N), gain-scaled, summing to mix
    spk_idx: torch.Tensor   # (B, K)


def normalize(wav: torch.Tensor) -> torch.Tensor:
    wav = wav - wav.mean(dim=-1, keepdim=True)
    return wav / torch.clamp(wav.abs().amax(dim=-1, keepdim=True), min=1e-8)


def _roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device) - shifts[..., None]) % n
    return torch.gather(x, -1, idx)


def replay_batch(generator: torch.Generator, bank: torch.Tensor, c: dict
                 ) -> Batch:
    """The next training batch of `generator`, as the program draws it
    (with the configuration's circular-shift and dB-gain augment)."""
    b, k = c["batch_size"], c["max_mix"]
    if c["min_mix"] != k or k > 2:
        raise ValueError("replay_batch copies the k <= 2, all-live draw only")
    s, u, n = bank.shape
    dev, g = bank.device, generator

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    spk_idx = torch.rand((b, s), generator=g).argsort(dim=1)[:, :k].to(dev)
    utt_idx = ints(0, u, (b, k))
    wavs = normalize(bank[spk_idx, utt_idx])
    augment = c["augment_data"]
    if augment:
        wavs = _roll_rows(wavs, ints(0, n, (b, k)))
    gains = torch.ones((b, k), device=dev)
    if c["db_range"] > 0 and augment:
        r_db = torch.rand((b, 3), generator=g).to(dev)
        chan = ints(0, min(k, 2), (b,))
        gains[torch.arange(b, device=dev), chan] = 10.0 ** (
            c["db_range"] / 20.0 * r_db[:, 0])
    sources = wavs * gains[..., None]
    return Batch(sources.sum(dim=1), sources, spk_idx)


def request_pool(seed: int, bank: torch.Tensor, size: int, speakers: int,
                 db_range: float) -> Batch:
    """`size` mixtures of `speakers` distinct speakers, one utterance each,
    peak-normalised, one of them scaled by a random gain of up to
    `db_range` dB, on the bank's device."""
    s, u, _ = bank.shape
    dev = bank.device
    g = torch.Generator(device=dev).manual_seed(seed)
    spk = torch.rand((size, s), generator=g, device=dev).argsort(
        dim=1)[:, :speakers]
    utt = torch.randint(0, u, (size, speakers), generator=g, device=dev)
    gains = torch.ones((size, speakers), device=dev)
    gains[:, 0] = 10.0 ** (db_range / 20.0 * torch.rand(
        size, generator=g, device=dev))
    sources = normalize(bank[spk, utt]) * gains[..., None]
    return Batch(sources.sum(dim=1), sources, spk)
