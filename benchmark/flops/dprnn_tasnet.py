"""dprnn_tasnet's layers, counted from shapes, at the widths of the
configuration file's `model` block: the encoder's filters over the
samples, the bottleneck, each block's intra-chunk BiLSTM (B*S rows of K
steps) and inter-chunk BiLSTM (B*K rows of S steps) with their Linears
back to D, the mask's 1x1 convolution and the decoder's filters. A
traffic driver combines them into its unit (`count` in
`drivers/<driver>.py`)."""

from __future__ import annotations

from benchmark.harness import flopcount as fc
from benchmark.harness import registry
from benchmark.reference.dprnn import padding


def model_block() -> dict:
    return registry.load_json("configs", "dprnn_tasnet")["model"]


def dprnn(c: dict, b: int) -> fc.Count:
    """The forward of a step of `b` mixtures of `max_len` samples: all its
    products, and the recurrence of each of the 2R BiLSTM layers."""
    m = model_block()
    n, length, d, h = m["filters"], m["kernel"], m["bottleneck"], m["hidden"]
    k, p, spk = m["chunk"], m["hop"], m["speakers"]
    frames = (c["max_len"] - length) // (length // 2) + 1
    front, back = padding(frames, m)
    s = (frames + front + back - k) // p + 1
    nbytes = fc.operand_bytes(c)
    ops = 2.0 * b * frames * length * n + fc.linear(b * frames, n, d)
    rec = []
    for _ in range(m["blocks"]):
        for rows, steps in ((b * s, k), (b * k, s)):
            stack, layer = fc.rnn_stack("lstm", rows, steps, d, h, 1, nbytes)
            ops += stack + fc.linear(rows * steps, 2 * h, d)
            rec += layer
    ops += fc.linear(b * s * k, d, spk * n) + 2.0 * b * spk * frames * n \
        * length
    return fc.Count(ops, rec)
