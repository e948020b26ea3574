// The inverse real DFT + window + overlap-add tile shared by K4
// (masked_istft.cu) and K10 (istft_ri.cu). Both write the raw overlap-add
//   ola[c, n] = sum_{t covers n} win[j] * sum_f Re[c,t,f] iDFT_re[f,j]
//                                             + Im[c,t,f] iDFT_im[f,j],
// j = n - t*hop, per channel c, and differ only in where a channel's
// spectrum comes from: the caller passes that as a functor
// `load(c, t, f, &re, &im)`.
//
// A gather, with no atomics. One block covers OLA_THREADS consecutive output
// samples of OLA_CG channels. It first stages the spectra of the few frames
// covering those samples (ceil(L/hop)+1 at most: 3 at 256/128) for its
// channels in shared memory; then each thread sums, for its own sample, the
// frames covering it. Each iDFT table value a thread reads (coalesced
// across the threads' consecutive j) feeds all OLA_CG channels, so the
// 264 KB table is read from L2 once per block of OLA_CG channels instead of
// once per channel; the staged spectra are broadcast reads. f32 on the CUDA
// cores: the bar is 1e-4.
#pragma once

#include "dl4ss_common.cuh"

namespace dl4ss {

constexpr int OLA_THREADS = 128;  // output samples per block
constexpr int OLA_CG = 8;         // channels per block

template <typename Load>
__device__ __forceinline__ void ola_tile(
    const Load& load,
    const float* __restrict__ mre,    // (F, L) iDFT rows for Re
    const float* __restrict__ mim,    // (F, L) iDFT rows for Im
    const float* __restrict__ win,    // (L,)
    float* __restrict__ out,          // (C, out_len)
    int C, int T, int F, int L, int hop, int out_len) {
  extern __shared__ float spec[];  // (OLA_CG, frames, 2, F): Re, Im
  const int c0 = blockIdx.y * OLA_CG;
  const int nch = min(OLA_CG, C - c0);
  const int n0 = blockIdx.x * OLA_THREADS;
  const int n_last = min(n0 + OLA_THREADS, out_len) - 1;
  // frames t with t*hop <= n <= t*hop + L - 1 for some n in [n0, n_last]
  const int t_lo = n0 - L + 1 <= 0 ? 0 : (n0 - L + hop) / hop;
  const int t_hi = min(T - 1, n_last / hop);
  const int nfr = t_hi - t_lo + 1;
  for (int i = threadIdx.x; i < OLA_CG * nfr * F; i += OLA_THREADS) {
    const int ch = i / (nfr * F), rem = i % (nfr * F);
    const int fr = rem / F, f = rem % F;
    float mr = 0.0f, mi = 0.0f;
    if (ch < nch) load(c0 + ch, t_lo + fr, f, &mr, &mi);
    spec[(ch * nfr + fr) * 2 * F + f] = mr;
    spec[(ch * nfr + fr) * 2 * F + F + f] = mi;
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= out_len) return;
  const int ta = max(t_lo, n - L + 1 <= 0 ? 0 : (n - L + hop) / hop);
  const int tb = min(t_hi, n / hop);
  float acc[OLA_CG];
#pragma unroll
  for (int c = 0; c < OLA_CG; ++c) acc[c] = 0.0f;
  for (int t = ta; t <= tb; ++t) {
    const int j = n - t * hop;
    float v[OLA_CG];
#pragma unroll
    for (int c = 0; c < OLA_CG; ++c) v[c] = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float cr = mre[(size_t)f * L + j];
      const float ci = mim[(size_t)f * L + j];
#pragma unroll
      for (int c = 0; c < OLA_CG; ++c) {
        const float* sr = spec + (c * nfr + t - t_lo) * 2 * F;
        v[c] = fmaf(sr[f], cr, fmaf(sr[F + f], ci, v[c]));
      }
    }
#pragma unroll
    for (int c = 0; c < OLA_CG; ++c) acc[c] = fmaf(win[j], v[c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < OLA_CG; ++c)
    if (c < nch) out[(size_t)(c0 + c) * out_len + n] = acc[c];
}

// Launch geometry of a kernel built on ola_tile, for C channels.
inline dim3 ola_grid(int C, int out_len) {
  return dim3((out_len + OLA_THREADS - 1) / OLA_THREADS,
              (C + OLA_CG - 1) / OLA_CG);
}
inline size_t ola_smem(int F, int L, int hop) {
  const int max_frames = (OLA_THREADS - 1 + L - 1) / hop + 1;
  return (size_t)OLA_CG * max_frames * 2 * F * sizeof(float);
}

}  // namespace dl4ss
