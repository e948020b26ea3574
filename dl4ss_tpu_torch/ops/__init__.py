"""DSP and recurrence primitives in PyTorch (`stft`, `rnn`), and the
wrappers of the hand-written CUDA kernels (`stft_kernels`, `rnn_kernels`,
`maskhead_kernels`; sources in ../csrc, built by `cuda_lib`). The kernel
wrappers are exported here by name, as the JAX package exports its
`pallas_*` functions; the plain DSP stays under `ops.stft`."""

from dl4ss_tpu_torch.ops.stft_kernels import (  # noqa: F401
    istft_kernel, istft_ri, masked_istft, stft_features, stft_kernel, stft_ri)
from dl4ss_tpu_torch.ops.rnn_kernels import gru_scan, lstm_scan  # noqa: F401
