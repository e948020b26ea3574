// K9 — STFT: framing + window + real DFT, emitting the packed spectrum
// [Re X | Im X].
//
// Replaces dl4ss_tpu/ops/pallas_stft.py::_stft_kernel (the Pallas body of
// pallas_stft_ri / pallas_stft). The reflect pad of center=True stays a
// torch op outside, as in the JAX wrapper; with center=False the kernel
// frames the signal as it is. Output (B, T, 2F) f32 with Re in [..., :F]
// and Im in [..., F:].
//
// Bound on the H100: bytes. At B=16, N=40000 (T=313, F=129, L=256) the
// function reads 2.6 MB and writes 5.2 MB (~2.3 us at 3.35 TB/s); an FFT's
// ~30 MFLOP are below that. As K1, this direct DFT does 0.66 GFLOP of f32
// FMA (~10 us at the f32 CUDA-core rate), so its own work limits it.
//
// Design: K1's body without the magnitude. The DFT tile is the one of
// stft_tile.cuh, shared with K1 (one block per (utterance, 16 frames), one
// thread per frequency bin, f32 FMA against the L2-resident table); this
// file adds only the packed epilogue.
#include "stft_tile.cuh"

namespace {

struct EmitPacked {
  float* __restrict__ out;   // (B, T, 2F)
  int T, F;
  __device__ __forceinline__ void operator()(int b, int t, int f, float r,
                                             float i) const {
    float* row = out + ((size_t)b * T + t) * 2 * F;
    row[f] = r;
    row[F + f] = i;
  }
};

__global__ void stft_ri_kernel(
    const float* __restrict__ x, const float* __restrict__ win,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    float* __restrict__ out, int Np, int T, int L, int hop, int F) {
  dl4ss::stft_tile(x, win, cos_t, sin_t, Np, T, L, hop, F,
                   EmitPacked{out, T, F});
}

}  // namespace

// x (B, Np) f32, reflect-padded by the caller when centered; win (L,);
// cos_t, sin_t (L, F) f32; out (B, T, 2F) f32.
extern "C" int dl4ss_stft_ri(const void* x, const void* win,
                             const void* cos_t, const void* sin_t, void* out,
                             int B, int Np, int T, int L, int hop, int F,
                             void* stream) {
  const size_t smem = dl4ss::stft_smem(L);
  cudaError_t err = dl4ss::allow_smem(stft_ri_kernel, smem);
  if (err != cudaSuccess) return err;
  stft_ri_kernel<<<dl4ss::stft_grid(B, T), dl4ss::stft_threads(F), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<float*>(out), Np, T, L, hop, F);
  return cudaGetLastError();
}
