"""torch_multi's layers, counted from shapes: the separator (a BiGRU
encoder, the projection to the F x E embedding grid and the dot mask
head) and the classifier (a BiLSTM and its linear layer over the
speakers). Each gives one forward at batch `b`; a traffic driver combines
them into its unit (`count` in `drivers/<driver>.py`)."""

from __future__ import annotations

from benchmark.harness import flopcount as fc


def separator(c: dict, b: int) -> fc.Count:
    t, f, h, e = c["num_frames"], c["freq_bins"], c["hidden_units"], \
        c["embedding_size"]
    enc, rec = fc.rnn_stack(c["encoder_rnn"], b, t, f, h, c["encoder_layers"],
                            fc.operand_bytes(c))
    head = fc.linear(b * t, 2 * h, f * e) + 2.0 * b * c["max_mix"] * t * f * e
    return fc.Count(enc + head, rec)


def classifier(c: dict, b: int) -> fc.Count:
    return fc.classifier(c, b)
