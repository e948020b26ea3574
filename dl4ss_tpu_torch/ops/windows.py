"""Analysis/synthesis windows.

The reference defines a sine window `sin(i*pi/N)` (Torch_multi/config.py:240)
but its feature STFTs actually use librosa's default periodic Hann
(predata_multiAims.py:200-206); sqrt-Hann appears in the hand-rolled
STFT validation script (Cocktail/.../test_stft_istft.py:13-63). All three are
supported; windows are returned as float32 numpy for embedding as constants.
(The port's copy of `dl4ss_tpu/ops/windows.py`.)
"""

from __future__ import annotations

import numpy as np


def sine_window(length: int) -> np.ndarray:
    """sin(i*pi/N), i in [0, N) — the reference's WINDOWS (config.py:240)."""
    i = np.arange(length)
    return np.sin(i * np.pi / length).astype(np.float32)


def hann_window(length: int) -> np.ndarray:
    """Periodic Hann, matching librosa/scipy `get_window('hann', N)`."""
    i = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / length)).astype(np.float32)


def sqrt_hann_window(length: int) -> np.ndarray:
    return np.sqrt(hann_window(length)).astype(np.float32)


_WINDOWS = {
    "sine": sine_window,
    "hann": hann_window,
    "sqrt_hann": sqrt_hann_window,
    "rect": lambda n: np.ones(n, np.float32),
}


def get_window(name: str, length: int) -> np.ndarray:
    try:
        return _WINDOWS[name](length)
    except KeyError:
        raise KeyError(f"unknown window {name!r}; available: {sorted(_WINDOWS)}") from None
