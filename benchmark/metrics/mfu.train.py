"""The model's products in the traced train units over their wall time, as
a share of the chip's peak (989 TFLOP/s)."""

from benchmark.harness import readers


def read(r):
    return readers.mfu(r, "train")
