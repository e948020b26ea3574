"""The synthetic utterance bank, made on the device from a seed.

The recipe of the program's `make_synthetic_bank` (a speech-like harmonic
signal per utterance: a per-speaker f0 in [80, 280] Hz with a +/-4%
per-utterance jitter, 8 harmonics of random amplitude and phase, vibrato,
an AM envelope and a little noise, peak-normalised), drawn in a few large
calls of one generator on the device instead of a host loop. It is not
bit-equal to the numpy bank, and need not be: both sides of the
comparison get this one.
"""

from __future__ import annotations

import math

import torch


def make_bank(seed: int, speakers: int, utts: int, samples: int,
              rate: int, device, chunk: int = 1024) -> torch.Tensor:
    """(speakers, utts, samples) float32 on `device`: the utterances'
    parameters in a few calls, their samples `chunk` rows at a time, so
    that the temporaries stay a small part of the bank."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = speakers * utts

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    t = torch.arange(samples, device=device, dtype=torch.float32) / rate
    f0 = uni(80.0, 280.0, speakers, 1).repeat_interleave(utts, dim=0)
    f0 = f0 * (1.0 + 0.04 * torch.randn((n, 1), generator=g, device=device))
    amp = uni(0.2, 1.0, n, 8)
    vib_rate = uni(2.0, 6.0, n, 8)
    phase = uni(0.0, 2 * math.pi, n, 8)
    am_rate, am_phase = uni(1.0, 3.0, n, 1), uni(0.0, 6.28, n, 1)
    bank = torch.empty((n, samples), device=device)
    for lo in range(0, n, chunk):
        r = slice(lo, min(lo + chunk, n))
        sig = torch.zeros((r.stop - lo, samples), device=device)
        for h in range(8):
            vib = 1.0 + 0.01 * torch.sin(2 * math.pi * vib_rate[r, h:h + 1]
                                         * t)
            sig += (amp[r, h:h + 1] / (h + 1)) * torch.sin(
                2 * math.pi * (h + 1) * f0[r] * vib * t + phase[r, h:h + 1])
        env = 0.55 + 0.45 * torch.sin(2 * math.pi * am_rate[r] * t
                                      + am_phase[r])
        sig = sig * env + 0.01 * torch.randn(sig.shape, generator=g,
                                             device=device)
        bank[r] = sig / sig.abs().amax(dim=-1, keepdim=True)
    return bank.reshape(speakers, utts, samples)
