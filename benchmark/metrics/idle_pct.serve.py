"""The share of the traced serve slices in which no operation runs on the
device."""

from benchmark.harness import readers


def read(r):
    return readers.idle(r, "serve")
