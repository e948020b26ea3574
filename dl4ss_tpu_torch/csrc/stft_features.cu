// K1 — STFT features: framing + window + real DFT, emitting |X|, Re X, Im X.
//
// Replaces dl4ss_tpu/ops/pallas_stft.py::_stft_feat_kernel (the Pallas body
// of pallas_stft_features). The reflect pad stays a torch op outside, as in
// the JAX wrapper; this kernel reads the padded signal directly at frame
// offsets t*hop, so it needs no hop-row reshape and takes any hop.
//
// Bound on the H100: bytes. At the serving shape (B=16, T=313, F=129,
// L=256) the function moves ~10 MB (~3 us at 3.35 TB/s), while an FFT
// would need only ~30 MFLOP (~0.5 us of f32). This direct DFT does
// 0.66 GFLOP of f32 FMA, ~10 us at the f32 CUDA-core rate (67 TFLOP/s),
// so its own work, not the bytes, limits it; an FFT-style kernel is later
// work.
//
// Design: the DFT tile of stft_tile.cuh (shared with K9), one block per
// (utterance, 16 frames), one thread per frequency bin; this file adds the
// epilogue that writes the magnitude beside Re and Im.
#include "stft_tile.cuh"

namespace {

template <typename MagT>
struct EmitFeatures {
  MagT* __restrict__ mag;
  float* __restrict__ re;
  float* __restrict__ im;
  int T, F;
  __device__ __forceinline__ void operator()(int b, int t, int f, float r,
                                             float i) const {
    const size_t o = ((size_t)b * T + t) * F + f;
    re[o] = r;
    im[o] = i;
    dl4ss::store(mag + o, sqrtf(r * r + i * i));
  }
};

template <typename MagT>
__global__ void stft_features_kernel(
    const float* __restrict__ x,      // (B, Np) reflect-padded signal
    const float* __restrict__ win,    // (L,)
    const float* __restrict__ cos_t,  // (L, F) cos
    const float* __restrict__ sin_t,  // (L, F) -sin
    MagT* __restrict__ mag, float* __restrict__ re, float* __restrict__ im,
    int Np, int T, int L, int hop, int F) {
  dl4ss::stft_tile(x, win, cos_t, sin_t, Np, T, L, hop, F,
                   EmitFeatures<MagT>{mag, re, im, T, F});
}

template <typename MagT>
cudaError_t run(const void* x, const void* win, const void* cos_t,
                const void* sin_t, void* mag, void* re, void* im, int B,
                int Np, int T, int L, int hop, int F, cudaStream_t stream) {
  const size_t smem = dl4ss::stft_smem(L);
  cudaError_t err = dl4ss::allow_smem(stft_features_kernel<MagT>, smem);
  if (err != cudaSuccess) return err;
  stft_features_kernel<MagT>
      <<<dl4ss::stft_grid(B, T), dl4ss::stft_threads(F), smem, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(win),
          static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
          static_cast<MagT*>(mag), static_cast<float*>(re),
          static_cast<float*>(im), Np, T, L, hop, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dl4ss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, Np) f32 reflect-padded; win (L,); cos_t, sin_t (L, F) f32;
// mag (B, T, F) f32 or bf16 (mag_bf16); re, im (B, T, F) f32.
extern "C" int dl4ss_stft_features(const void* x, const void* win,
                                   const void* cos_t, const void* sin_t,
                                   void* mag, void* re, void* im, int B,
                                   int Np, int T, int L, int hop, int F,
                                   int mag_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return mag_bf16 ? run<__nv_bfloat16>(x, win, cos_t, sin_t, mag, re, im, B,
                                       Np, T, L, hop, F, s)
                  : run<float>(x, win, cos_t, sin_t, mag, re, im, B, Np, T,
                               L, hop, F, s);
}
