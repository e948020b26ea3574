"""The 95th percentile of the latency of every request of the window,
host to host, in ms."""

from benchmark.harness import readers


def read(r):
    return readers.latency_p95_ms(r)
