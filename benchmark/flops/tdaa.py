"""tdaa's layers, counted from shapes: the separator (a BiLSTM encoder,
the projection and the dot mask head behind the self-tune (ADDJUST)
queries), the classifier (a BiLSTM-600 and its linear layer over the
speakers) and the discriminator on one (T, F) image. Each gives one
forward; a traffic driver combines them into its unit (`count` in
`drivers/<driver>.py`)."""

from __future__ import annotations

from benchmark.harness import flopcount as fc


def separator(c: dict, b: int) -> fc.Count:
    t, f, h, e = c["num_frames"], c["freq_bins"], c["hidden_units"], \
        c["embedding_size"]
    k = c["max_mix"]
    enc, rec = fc.rnn_stack(c["encoder_rnn"], b, t, f, h, c["encoder_layers"],
                            fc.operand_bytes(c))
    ops = (enc + fc.linear(b * t, 2 * h, f * e) + 2.0 * b * k * t * f * e
           + fc.linear(b * k, 2 * h + e, e))
    return fc.Count(ops, rec)


def classifier(c: dict, b: int) -> fc.Count:
    return fc.classifier(c, b)


def discriminator(c: dict) -> float:
    """Three 3x3 stride-2 VALID convolutions of 64 channels and a linear
    layer to one output, on one (T, F) image."""
    t, f = c["num_frames"], c["freq_bins"]
    ops, cin = 0.0, 1
    for _ in range(3):
        t, f = (t - 3) // 2 + 1, (f - 3) // 2 + 1
        ops += 2.0 * t * f * 64 * 9 * cin
        cin = 64
    return ops + 2.0 * t * f * 64
