"""Separation with the speakers given: each unit is one request through
`serve.separate_waveforms` (K1, the encoder, the mask head, K4)."""

from __future__ import annotations

from benchmark.harness import flopcount as fc
from benchmark.harness.serving import ServeDriver


def count(layers, c: dict, b: int) -> fc.Count:
    """A request of `b` mixtures: their STFT, the separator, and the
    masked iSTFT of the K sources of each."""
    sep = layers.separator(c, b)
    return fc.Count(fc.stft(c, b * (1 + c["max_mix"])) + sep.model,
                    sep.recurrence)


class Driver(ServeDriver):
    select = False
