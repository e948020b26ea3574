"""MNIST digits as image queries, the Multi_modal variant (a copy of
`dl4ss_tpu/data/mnist.py`, numpy only, so one seed gives the same glyphs).

The reference bundles Yann LeCun's IDX files and a reader
(Multi_modal/.../input_data.py) and maps digit = speaker_idx - 1
(prepare_data.py:184-188). This module reads standard IDX files when a local
copy exists, and otherwise synthesizes recognizable per-digit glyph images —
enough to exercise the full image-query pipeline deterministically with no
network access (the image encoder only needs a consistent digit <-> class
mapping, not real handwriting).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_GLYPHS = [
    "01110100011000110001100011000101110",  # 0 (5x7)
    "00100011000010000100001000010001110",
    "01110100010000100110010001000111111",
    "01110100010000101110000011000101110",
    "00010001100101010010111110001000010",
    "11111100001111000001000011000101110",
    "01110100001111010001100011000101110",
    "11111000010001000100010001000010000",
    "01110100010111010001100011000101110",
    "01110100011000101111000010000101110",
]


def _read_idx(path) -> np.ndarray:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def synthetic_digits(num_per_digit: int = 16, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 28, 28) float32 in [0,1], labels (N,): glyph templates + noise,
    jitter, and scaling so each 'digit' is a recognizable class."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for digit, glyph in enumerate(_GLYPHS):
        base = np.array([float(c) for c in glyph], np.float32).reshape(7, 5)
        big = np.kron(base, np.ones((3, 4), np.float32))  # 21x20
        for _ in range(num_per_digit):
            img = np.zeros((28, 28), np.float32)
            dy, dx = rng.integers(0, 7), rng.integers(0, 8)
            img[dy:dy + 21, dx:dx + 20] = big * rng.uniform(0.7, 1.0)
            img += 0.08 * rng.random((28, 28))
            images.append(np.clip(img, 0, 1))
            labels.append(digit)
    order = rng.permutation(len(images))
    return (np.stack(images)[order], np.array(labels, np.int64)[order])


def load_mnist(data_dir: Optional[str] = None, split: str = "train",
               fallback_per_digit: int = 64, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,28,28) float32 in [0,1], labels (N,) int64).
    Reads IDX files from data_dir when present; synthetic glyphs otherwise."""
    if data_dir:
        prefix = "train" if split == "train" else "t10k"
        for suffix in ("", ".gz"):
            ip = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{suffix}")
            lp = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{suffix}")
            if os.path.exists(ip) and os.path.exists(lp):
                return (_read_idx(ip).astype(np.float32) / 255.0,
                        _read_idx(lp).astype(np.int64))
    return synthetic_digits(fallback_per_digit, seed)


def digit_query_bank(images: np.ndarray, labels: np.ndarray,
                     num_speakers: int) -> np.ndarray:
    """(S, n_variants, 28, 28, 1): image pool per speaker with the
    reference's digit = (speaker idx) mod 10 mapping (prepare_data.py:184-188
    uses spk_idx - 1; modulo generalizes past 10 speakers)."""
    per_digit = [images[labels == d] for d in range(10)]
    n_var = min(len(p) for p in per_digit)
    bank = np.stack([per_digit[s % 10][:n_var] for s in range(num_speakers)])
    return bank[..., None].astype(np.float32)
