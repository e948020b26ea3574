"""A request's products over the mean latency of the window's requests
(host clock), as a share of the chip's peak (989 TFLOP/s)."""

from benchmark.harness import readers


def read(r):
    return readers.mfu(r, "serve")
