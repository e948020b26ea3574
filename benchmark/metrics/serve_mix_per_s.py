"""Mixtures separated in the window (requests that did not fail, times
their batch) over the window's time."""

from benchmark.harness import readers


def read(r):
    return readers.mixtures_per_s(r, "serve")
