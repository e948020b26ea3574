"""DSP and recurrence primitives in PyTorch (`stft`, `crm`, `rnn`, `xcorr`,
`windows`), and the wrappers of the hand-written CUDA kernels
(`stft_kernels`, `rnn_kernels`, `maskhead_kernels`; sources in ../csrc,
built by `cuda_lib` at first launch).

The names are the JAX package's (`dl4ss_tpu.ops`), so that `stft`, `istft`
and `xcorr` here are the functions, not their modules (import those as
`importlib.import_module("dl4ss_tpu_torch.ops.stft")`). The kernel wrappers
keep their own names in place of the `pallas_*` ones: `stft_kernel`,
`stft_ri`, `istft_kernel`, `istft_ri`, `spectral_feature_kernel`,
`stft_features`, `masked_istft`, `gru_scan`, `lstm_scan`.
"""

from dl4ss_tpu_torch.ops.windows import (  # noqa: F401
    get_window, sine_window, sqrt_hann_window, hann_window)
from dl4ss_tpu_torch.ops.stft import (  # noqa: F401
    stft, istft, frame_signal, overlap_add, magnitude_and_phase,
    masked_resynthesis)
from dl4ss_tpu_torch.ops.crm import (  # noqa: F401
    crm_compress, crm_uncompress, complex_mask_apply, pack_ri, unpack_ri)
from dl4ss_tpu_torch.ops.rnn import (  # noqa: F401
    lstm_init, gru_init, bidirectional_rnn, rnn_init)
from dl4ss_tpu_torch.ops.xcorr import xcorr, ola_conv  # noqa: F401
from dl4ss_tpu_torch.ops.stft_kernels import (  # noqa: F401
    istft_kernel, istft_ri, masked_istft, spectral_feature_kernel,
    stft_features, stft_kernel, stft_ri)
from dl4ss_tpu_torch.ops.rnn_kernels import gru_scan, lstm_scan  # noqa: F401
