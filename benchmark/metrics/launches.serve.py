"""Every CUDA kernel in the traced serve slices, per unit."""

from benchmark.harness import readers


def read(r):
    return readers.launches(r, "serve")
