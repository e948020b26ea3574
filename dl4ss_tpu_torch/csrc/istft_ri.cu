// K10 — iSTFT of a packed spectrum: inverse real DFT + window +
// overlap-add.
//
// Replaces dl4ss_tpu/ops/pallas_stft.py::_istft_kernel (the Pallas body of
// pallas_istft_ri / pallas_istft). From spec (B, T, 2F) f32 with Re in
// [..., :F] and Im in [..., F:] it writes the raw overlap-add
// (B, (T-1)*hop + L). The window-square normalisation (a constant table
// built once on the host), the center trim and the `length` contract stay
// plain torch outside, as in the JAX wrapper (pallas_stft.py:370-391).
//
// Bound on the H100: bytes. At B=16, T=313, F=129, L=256 the function reads
// 5.2 MB and writes 2.6 MB (~2.3 us at 3.35 TB/s); an inverse FFT's ~30
// MFLOP are below that. This direct iDFT does ~0.66 GFLOP of f32 FMA (~10
// us at the f32 CUDA-core rate), so its own work limits it.
//
// Design: K4's body without the mask and the K axis. The gather tile is the
// one of istft_tile.cuh, shared with K4 (one block per 128 output samples
// of 8 utterances, each sample summing the <= ceil(L/hop) frames that cover
// it, no atomics); this file adds only the packed loader.
#include "istft_tile.cuh"

namespace {

struct LoadPacked {
  const float* spec;   // (B, T, 2F)
  int T, F;
  __device__ __forceinline__ void operator()(int b, int t, int f, float* re,
                                             float* im) const {
    const float* row = spec + ((size_t)b * T + t) * 2 * F;
    *re = row[f];
    *im = row[F + f];
  }
};

__global__ void __launch_bounds__(dl4ss::OLA_THREADS) istft_ri_kernel(
    const float* __restrict__ spec, const float* __restrict__ mre,
    const float* __restrict__ mim, const float* __restrict__ win,
    float* __restrict__ out, int B, int T, int F, int L, int hop,
    int out_len) {
  dl4ss::ola_tile(LoadPacked{spec, T, F}, mre, mim, win, out, B, T, F, L, hop,
                  out_len);
}

}  // namespace

// spec (B, T, 2F) f32; mre, mim (F, L) f32; win (L,) f32;
// out (B, (T-1)*hop + L) f32.
extern "C" int dl4ss_istft_ri(const void* spec, const void* mre,
                              const void* mim, const void* win, void* out,
                              int B, int T, int F, int L, int hop,
                              int out_len, void* stream) {
  const size_t smem = dl4ss::ola_smem(F, L, hop);
  cudaError_t err = dl4ss::allow_smem(istft_ri_kernel, smem);
  if (err != cudaSuccess) return err;
  istft_ri_kernel<<<dl4ss::ola_grid(B, out_len), dl4ss::OLA_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spec), static_cast<const float*>(mre),
      static_cast<const float*>(mim), static_cast<const float*>(win),
      static_cast<float*>(out), B, T, F, L, hop, out_len);
  return cudaGetLastError();
}
