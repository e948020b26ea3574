"""DSP and recurrence primitives in PyTorch (`stft`, `rnn`), and the
wrappers of the hand-written CUDA kernels (`stft_kernels`, `rnn_kernels`,
`maskhead_kernels`; sources in ../csrc, built by `cuda_lib`)."""
