"""The recurrences' least time (their U.h products at the peak of the
configuration's operand precision, or their bytes at 3.35 TB/s where that
is longer) over the device time of the kernels that run them (the names
listed in metrics/rnn_kernels/), in the traced serve units."""

from benchmark.harness import readers


def read(r):
    return readers.rnn_roofline(r, "serve")
