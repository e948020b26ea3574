"""Separation of unknown speakers: each unit is one request through
`serve.select_and_separate`, whose classifier picks the top-k speakers
before the separator extracts them."""

from __future__ import annotations

from benchmark.harness import flopcount as fc
from benchmark.harness.serving import ServeDriver


def count(layers, c: dict, b: int) -> fc.Count:
    """A request of `b` mixtures: their STFT, the classifier, the
    separator on its picks, and the masked iSTFT of the K sources of
    each."""
    sep, cls = layers.separator(c, b), layers.classifier(c, b)
    return fc.Count(fc.stft(c, b * (1 + c["max_mix"])) + cls.model
                    + sep.model, sep.recurrence + cls.recurrence)


class Driver(ServeDriver):
    select = True
