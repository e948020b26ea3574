// K4 — masked iSTFT: mask apply + inverse real DFT + window + overlap-add.
//
// Replaces dl4ss_tpu/ops/pallas_stft.py::_masked_istft_kernel (the Pallas
// body of pallas_masked_istft). For each channel (b, k) it writes the raw
// overlap-add
//   ola[b,k,n] = sum_{t covers n} win[j] * sum_f (m.Re)[f] iDFT_re[f,j]
//                                         + (m.Im)[f] iDFT_im[f,j],
// j = n - t*hop, with m = masks[b,k,t,:] and (Re, Im) the mixture spectrum.
// The window-square normalisation, center trim and length pad stay plain
// torch outside, as in the JAX wrapper (pallas_stft.py:288-308).
//
// Bound on the H100: bytes. At B=16, K=2, T=313, F=129, L=256 the function
// moves ~16 MB (~5 us at 3.35 TB/s), while an inverse FFT would need only
// ~60 MFLOP (~1 us of f32). This direct iDFT does ~1.3 GFLOP of f32 FMA,
// ~20 us at the f32 CUDA-core rate, so its own work limits it; an
// FFT-style kernel is later work.
//
// Design: the gather tile of istft_tile.cuh (shared with K10): one block
// per 128 output samples of 8 channels (b, k), no atomics. This file adds
// the loader that applies the mask while the spectra are staged.
#include "istft_tile.cuh"

namespace {

template <typename MaskT>
struct LoadMasked {
  const float* re;      // (B, T, F)
  const float* im;      // (B, T, F)
  const MaskT* masks;   // (B, K, T, F)
  int K, T, F;
  __device__ __forceinline__ void operator()(int bk, int t, int f, float* mr,
                                             float* mi) const {
    const float m = dl4ss::to_f32(masks[((size_t)bk * T + t) * F + f]);
    const size_t s = ((size_t)(bk / K) * T + t) * F + f;
    *mr = m * re[s];
    *mi = m * im[s];
  }
};

template <typename MaskT>
__global__ void __launch_bounds__(dl4ss::OLA_THREADS) masked_istft_kernel(
    const float* __restrict__ re,     // (B, T, F)
    const float* __restrict__ im,     // (B, T, F)
    const MaskT* __restrict__ masks,  // (B, K, T, F)
    const float* __restrict__ mre, const float* __restrict__ mim,
    const float* __restrict__ win, float* __restrict__ out, int BK, int K,
    int T, int F, int L, int hop, int out_len) {
  dl4ss::ola_tile(LoadMasked<MaskT>{re, im, masks, K, T, F}, mre, mim, win,
                  out, BK, T, F, L, hop, out_len);
}

template <typename MaskT>
cudaError_t run(const void* re, const void* im, const void* masks,
                const void* mre, const void* mim, const void* win, void* out,
                int B, int K, int T, int F, int L, int hop, int out_len,
                cudaStream_t stream) {
  const size_t smem = dl4ss::ola_smem(F, L, hop);
  cudaError_t err = dl4ss::allow_smem(masked_istft_kernel<MaskT>, smem);
  if (err != cudaSuccess) return err;
  masked_istft_kernel<MaskT><<<dl4ss::ola_grid(B * K, out_len),
                               dl4ss::OLA_THREADS, smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const MaskT*>(masks), static_cast<const float*>(mre),
      static_cast<const float*>(mim), static_cast<const float*>(win),
      static_cast<float*>(out), B * K, K, T, F, L, hop, out_len);
  return cudaGetLastError();
}

}  // namespace

// re, im (B, T, F) f32; masks (B, K, T, F) f32, or bf16 when mask_bf16;
// mre, mim (F, L) f32; win (L,) f32; out (B, K, (T-1)*hop + L) f32.
extern "C" int dl4ss_masked_istft(const void* re, const void* im,
                                  const void* masks, const void* mre,
                                  const void* mim, const void* win, void* out,
                                  int B, int K, int T, int F, int L, int hop,
                                  int out_len, int mask_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return mask_bf16
             ? run<__nv_bfloat16>(re, im, masks, mre, mim, win, out, B, K, T,
                                  F, L, hop, out_len, s)
             : run<float>(re, im, masks, mre, mim, win, out, B, K, T, F, L,
                          hop, out_len, s);
}
