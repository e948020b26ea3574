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
// FFT-style kernel is later work. f32 on the CUDA cores, as for K1: the
// bar is 1e-4.
//
// Design: a gather, with no atomics. One block covers 128 consecutive
// output samples of K4_CG channels. It first stages the masked spectra
// m.Re, m.Im of the few frames covering those samples (ceil(L/hop)+1 at
// most: 3 at 256/128) for its channels in shared memory; then each thread
// sums, for its own sample, the frames covering it. Each iDFT table value
// a thread reads (coalesced across the threads' consecutive j) feeds all
// K4_CG channels, so the 264 KB table is read from L2 once per block of
// K4_CG channels instead of once per channel; the staged spectra are
// broadcast reads.
#include "dl4ss_common.cuh"

namespace {

constexpr int K4_THREADS = 128;  // output samples per block
constexpr int K4_CG = 8;         // channels (b, k) per block

template <typename MaskT>
__global__ void __launch_bounds__(K4_THREADS) masked_istft_kernel(
    const float* __restrict__ re,     // (B, T, F)
    const float* __restrict__ im,     // (B, T, F)
    const MaskT* __restrict__ masks,  // (B, K, T, F)
    const float* __restrict__ mre,    // (F, L) iDFT rows for Re
    const float* __restrict__ mim,    // (F, L) iDFT rows for Im
    const float* __restrict__ win,    // (L,)
    float* __restrict__ out,          // (B, K, out_len)
    int BK, int K, int T, int F, int L, int hop, int out_len) {
  extern __shared__ float spec[];  // (K4_CG, frames, 2, F): m.Re, m.Im
  const int c0 = blockIdx.y * K4_CG;
  const int nch = min(K4_CG, BK - c0);
  const int n0 = blockIdx.x * K4_THREADS;
  const int n_last = min(n0 + K4_THREADS, out_len) - 1;
  // frames t with t*hop <= n <= t*hop + L - 1 for some n in [n0, n_last]
  const int t_lo = n0 - L + 1 <= 0 ? 0 : (n0 - L + hop) / hop;
  const int t_hi = min(T - 1, n_last / hop);
  const int nfr = t_hi - t_lo + 1;
  for (int i = threadIdx.x; i < K4_CG * nfr * F; i += K4_THREADS) {
    const int ch = i / (nfr * F), rem = i % (nfr * F);
    const int fr = rem / F, f = rem % F;
    float mr = 0.0f, mi = 0.0f;
    if (ch < nch) {
      const int bk = c0 + ch, t = t_lo + fr;
      const float m = dl4ss::to_f32(masks[((size_t)bk * T + t) * F + f]);
      const size_t s = ((size_t)(bk / K) * T + t) * F + f;
      mr = m * re[s];
      mi = m * im[s];
    }
    spec[(ch * nfr + fr) * 2 * F + f] = mr;
    spec[(ch * nfr + fr) * 2 * F + F + f] = mi;
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= out_len) return;
  const int ta = max(t_lo, n - L + 1 <= 0 ? 0 : (n - L + hop) / hop);
  const int tb = min(t_hi, n / hop);
  float acc[K4_CG];
#pragma unroll
  for (int c = 0; c < K4_CG; ++c) acc[c] = 0.0f;
  for (int t = ta; t <= tb; ++t) {
    const int j = n - t * hop;
    float v[K4_CG];
#pragma unroll
    for (int c = 0; c < K4_CG; ++c) v[c] = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float cr = mre[(size_t)f * L + j];
      const float ci = mim[(size_t)f * L + j];
#pragma unroll
      for (int c = 0; c < K4_CG; ++c) {
        const float* sr = spec + (c * nfr + t - t_lo) * 2 * F;
        v[c] = fmaf(sr[f], cr, fmaf(sr[F + f], ci, v[c]));
      }
    }
#pragma unroll
    for (int c = 0; c < K4_CG; ++c) acc[c] = fmaf(win[j], v[c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < K4_CG; ++c)
    if (c < nch) out[(size_t)(c0 + c) * out_len + n] = acc[c];
}

template <typename MaskT>
cudaError_t run(const void* re, const void* im, const void* masks,
                const void* mre, const void* mim, const void* win, void* out,
                int B, int K, int T, int F, int L, int hop, int out_len,
                cudaStream_t stream) {
  const dim3 grid((out_len + K4_THREADS - 1) / K4_THREADS,
                  (B * K + K4_CG - 1) / K4_CG);
  const int max_frames = (K4_THREADS - 1 + L - 1) / hop + 1;
  const size_t smem = (size_t)K4_CG * max_frames * 2 * F * sizeof(float);
  cudaError_t err = dl4ss::allow_smem(masked_istft_kernel<MaskT>, smem);
  if (err != cudaSuccess) return err;
  masked_istft_kernel<MaskT><<<grid, K4_THREADS, smem, stream>>>(
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
