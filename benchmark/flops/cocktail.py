"""cocktail's layers, counted from shapes: the memory model's forward (a
BiLSTM encoder and its projection to the F x E grid, the BiLSTM(E/2)
voiceprint stack, the in-graph memory write and the additive align head)
and the write alone, which the step repeats outside the gradient. A
traffic driver combines them into its unit (`count` in
`drivers/<driver>.py`)."""

from __future__ import annotations

from benchmark.harness import flopcount as fc
from benchmark.reference.memory import rows, voice_width


def write(c: dict, b: int) -> float:
    """One write of `b` voiceprints: the (rows x B) one-hot by (B x D)
    product that sums them into their rows."""
    return fc.linear(rows(c), b, voice_width(c))


def memory_model(c: dict, b: int) -> fc.Count:
    """The forward of a step of `b` mixtures: both recurrent stacks (the
    encoder's layers, then the voiceprint's, in `recurrence`), the
    projection, the in-graph write and the align head (W1 on the grid, W2
    on the query, v on the tanh grid; the attention width A = E)."""
    t, f, h, e = c["num_frames"], c["freq_bins"], c["hidden_units"], \
        c["embedding_size"]
    nbytes = fc.operand_bytes(c)
    enc, rec = fc.rnn_stack("lstm", b, t, f, h, c["encoder_layers"], nbytes)
    voice, vrec = fc.rnn_stack("lstm", b, t, f, voice_width(c) // 2,
                               c["num_layers"], nbytes)
    head = (fc.linear(b * t, 2 * h, f * e) + fc.linear(b * t * f, e, e)
            + fc.linear(b, e, e) + fc.linear(b * t * f, e, 1))
    return fc.Count(enc + voice + head + write(c, b), rec + vrec)
