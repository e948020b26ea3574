"""Mixtures trained in the window (steps that did not fail, times the
batch) over the window's time."""

from benchmark.harness import readers


def read(r):
    return readers.mixtures_per_s(r, "train")
