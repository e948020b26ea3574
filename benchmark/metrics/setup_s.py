"""Seconds from the process's start to the window's: the imports, the
kernels' load (their build in a checkout's first run), the weights, the
bank, the requests and the warm-up."""


def read(r):
    return r.setup_s
