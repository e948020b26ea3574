"""The products each layer needs, counted from shapes, whatever implements
them: 2 operations a multiply-add. A real (inverse) FFT of L points counts
2.5 L log2 L. Elementwise work (gates, activations, losses, the optimizer)
is not counted. `recurrence` lists, per launch of a recurrent layer, the
operations of its U.h products and the least bytes it moves (U, the
projected inputs and the hidden states read or written once each)."""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

GATES = {"gru": 3, "lstm": 4}


class Count(NamedTuple):
    model: float                            # operations of one unit
    recurrence: List[Tuple[float, float]]   # (operations, bytes) per launch


def rfft(frames: int, length: int) -> float:
    return frames * 2.5 * length * math.log2(length)


def stft(c: dict, signals: int) -> float:
    """The (inverse) STFT of `signals` whole signals of the configuration."""
    return rfft(signals * c["num_frames"], c["frame_length"])


def operand_bytes(c: dict) -> int:
    """Bytes of one operand of the recurrence, in the stated precision."""
    return 4 if c["precision"]["recurrence"] == "float32" else 2


def rnn_stack(cell: str, b: int, t: int, d_in: int, h: int, layers: int,
              operand_bytes: int) -> Tuple[float, List[Tuple[float, float]]]:
    """A bidirectional stack's forward: (all products, per-layer
    recurrence (operations, bytes))."""
    g = GATES[cell] * h
    total, rec, d = 0.0, [], d_in
    for _ in range(layers):
        u_ops = 2 * 2.0 * b * t * h * g
        total += 2 * 2.0 * b * t * d * g + u_ops
        nbytes = operand_bytes * 2 * (h * g + b * t * g) + 4 * 2 * b * t * h
        rec.append((u_ops, nbytes))
        d = 2 * h
    return total, rec


def backward(rec: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """A recurrence's backward: twice the forward's products (dh U^T and
    h^T dG) and twice its bytes."""
    return [(2 * o, 2 * n) for o, n in rec]


def linear(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def classifier(c: dict, b: int) -> Count:
    """The speaker classifier's forward: a bidirectional stack of
    `classifier_hidden_mult` x `hidden_units` over the magnitudes, and a
    linear layer from its mean over the frames to the speakers."""
    h = c["hidden_units"] * c["classifier_hidden_mult"]
    ops, rec = rnn_stack(c["classifier_rnn"], b, c["num_frames"],
                         c["freq_bins"], h, c["classifier_layers"],
                         operand_bytes(c))
    return Count(ops + linear(b, 2 * h, c["num_speakers"]), rec)
