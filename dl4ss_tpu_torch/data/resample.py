"""Host-side resampling to the pipeline rate.

The reference resamples every utterance to 8 kHz with resampy's Kaiser-window
polyphase filter (Torch_multi/predata_multiAims.py:141-143). Here the host
does a scipy polyphase resample with a Kaiser window once at decode time (or
datasets are pre-resampled and this is a no-op); everything after the
resample runs on device. (The port's copy of `dl4ss_tpu/data/resample.py`.)
"""

from __future__ import annotations

from math import gcd

import numpy as np


def resample_poly_kaiser(x: np.ndarray, orig_rate: int, target_rate: int,
                         beta: float = 14.769656459379492) -> np.ndarray:
    """Polyphase Kaiser resample (beta matches resampy's kaiser_best)."""
    # imported here: scipy.signal takes seconds to import, which every
    # rank a parallel run spawns would pay for nothing
    import scipy.signal
    if orig_rate == target_rate:
        return np.asarray(x, np.float32)
    g = gcd(int(orig_rate), int(target_rate))
    up, down = target_rate // g, orig_rate // g
    y = scipy.signal.resample_poly(np.asarray(x, np.float64), up, down,
                                   window=("kaiser", beta))
    return y.astype(np.float32)
