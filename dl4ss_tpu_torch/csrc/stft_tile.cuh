// The framing + window + real DFT tile shared by K1 (stft_features.cu) and
// K9 (stft_ri.cu). Both read the reflect-padded signal directly at frame
// offsets t*hop and differ only in what they write per (frame, bin): the
// caller passes that as an epilogue functor `emit(b, t, f, re, im)`.
//
// One block covers (utterance b, a tile of STFT_FRAMES frames). It stages
// its windowed frames in shared memory once; each thread owns one frequency
// bin f and keeps STFT_FRAMES Re/Im accumulators in registers, so each
// cos/-sin table value read from global memory (coalesced across f,
// L1/L2-resident: 264 KB) feeds 2*STFT_FRAMES FMAs, and each shared-memory
// sample read is a broadcast. A block reads the whole table once, so
// STFT_FRAMES also sets the table traffic: 16 frames keep it at ~85 MB of
// L2 reads for a B=16 batch of 5 s utterances with 320 blocks to fill the
// card. The DFT stays on the CUDA cores in f32 (no TF32 tensor cores): the
// parity bar is 1e-4 against the reference's Precision.HIGHEST matmuls.
#pragma once

#include "dl4ss_common.cuh"

namespace dl4ss {

constexpr int STFT_FRAMES = 16;

template <typename Emit>
__device__ __forceinline__ void stft_tile(
    const float* __restrict__ x,      // (B, Np) reflect-padded signal
    const float* __restrict__ win,    // (L,)
    const float* __restrict__ cos_t,  // (L, F) cos
    const float* __restrict__ sin_t,  // (L, F) -sin
    int Np, int T, int L, int hop, int F, const Emit& emit) {
  extern __shared__ float frames[];  // (STFT_FRAMES, L) windowed frames
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * STFT_FRAMES;
  const int nf = min(STFT_FRAMES, T - t0);
  const float* xb = x + (size_t)b * Np;
  for (int i = threadIdx.x; i < STFT_FRAMES * L; i += blockDim.x) {
    const int fr = i / L, n = i - fr * L;
    frames[i] = fr < nf ? xb[(size_t)(t0 + fr) * hop + n] * win[n] : 0.0f;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc_re[STFT_FRAMES], acc_im[STFT_FRAMES];
#pragma unroll
    for (int j = 0; j < STFT_FRAMES; ++j) acc_re[j] = acc_im[j] = 0.0f;
    for (int n = 0; n < L; ++n) {
      const float c = cos_t[(size_t)n * F + f];
      const float s = sin_t[(size_t)n * F + f];
#pragma unroll
      for (int j = 0; j < STFT_FRAMES; ++j) {
        const float v = frames[j * L + n];
        acc_re[j] = fmaf(v, c, acc_re[j]);
        acc_im[j] = fmaf(v, s, acc_im[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < STFT_FRAMES; ++j)
      if (j < nf) emit(b, t0 + j, f, acc_re[j], acc_im[j]);
  }
}

// Launch geometry of a kernel built on stft_tile.
inline dim3 stft_grid(int B, int T) {
  return dim3((T + STFT_FRAMES - 1) / STFT_FRAMES, B);
}
inline int stft_threads(int F) { return std::min(256, (F + 31) / 32 * 32); }
inline size_t stft_smem(int L) {
  return (size_t)STFT_FRAMES * L * sizeof(float);
}

}  // namespace dl4ss
