"""dl4ss_tpu_torch — the PyTorch + CUDA port of dl4ss_tpu for one NVIDIA H100.

A second package beside the JAX one (`dl4ss_tpu/`, the reference it is held
against). It imports torch, numpy and scipy, never jax and nothing of
`dl4ss_tpu`; what it needs from there it keeps as its own copy.

Layout mirrors the JAX package so each counterpart is found by name:
  ops/     DSP (STFT / iSTFT), recurrences, and the hand-written CUDA kernel
           wrappers (`*_kernels.py`; sources in csrc/)
  models/  encoder, embedding, mask heads, classifier parameters, separator
  data/    wav I/O and resampling (numpy / scipy)
  run/     CLI entry points
  serve.py the serving program: wav -> STFT features -> separate -> iSTFT
  weights.py  load a JAX parameter pytree into the port's modules

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a GPU they raise rather than carry on on the CPU (see `resolve_device`).
"""

__version__ = "0.1.0"

from dl4ss_tpu_torch.config import Config, preset, preset_names  # noqa: F401
from dl4ss_tpu_torch.device import resolve_device  # noqa: F401
