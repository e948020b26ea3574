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
// function reads 2.6 MB and writes 5.2 MB (~2.3 us at 3.35 TB/s); a real
// FFT of every frame is ~26 MFLOP, below that. The kernel is K1's body
// without the magnitude: the shared-memory real-FFT tile of stft_tile.cuh
// (samples staged once per tile, one warp per frame, twiddles from a
// table; the direct tile for a frame length that is no power of two). This
// file adds only the packed epilogue, two coalesced stores per frame.
#include "stft_tile.cuh"

namespace dl4ss {

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

}  // namespace dl4ss

// x (B, Np) f32, reflect-padded by the caller when centered; win (L,);
// tw (L/2+1, 2) f32 for the FFT tile, cos_t, sin_t (L, F) f32 for the
// direct tile (the tables of the body that does not run may be null);
// out (B, T, 2F) f32. body: 1 the FFT tile, 2 the direct tile.
extern "C" int dl4ss_stft_ri(const void* x, const void* win, const void* tw,
                             const void* cos_t, const void* sin_t, void* out,
                             int B, int Np, int T, int L, int hop, int F,
                             int body, void* stream) {
  const dl4ss::StftArgs args{
      static_cast<const float*>(x),     static_cast<const float*>(win),
      static_cast<const float*>(tw),    static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), B, Np, T, L, hop, F, body};
  return dl4ss::stft_launch(
      args, dl4ss::EmitPacked{static_cast<float*>(out), T, F},
      static_cast<cudaStream_t>(stream));
}
