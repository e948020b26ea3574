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
// 5.2 MB and writes 2.6 MB (~2.3 us at 3.35 TB/s); the inverse real FFTs
// of its frames are ~26 MFLOP, below that. The kernel is K4's body without
// the mask and the K axis: the shared-memory inverse real-FFT tile of
// istft_tile.cuh (one block per utterance and 8 output hops, one warp per
// frame, the overlap-add summed in shared memory; the direct iDFT gather for
// a frame length that is no power of two). This file adds only the packed
// loader.
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

}  // namespace

// spec (B, T, 2F) f32; win (L,) f32; tw (L/2+1, 2) f32 for the FFT tile,
// mre, mim (F, L) f32 for the direct tile (the tables of the body that does
// not run may be null); out (B, (T-1)*hop + L) f32. body: 1 the FFT tile,
// 2 the direct tile.
extern "C" int dl4ss_istft_ri(const void* spec, const void* win,
                              const void* tw, const void* mre,
                              const void* mim, void* out, int B, int T, int F,
                              int L, int hop, int out_len, int body,
                              void* stream) {
  const dl4ss::IstftArgs args{
      static_cast<const float*>(win), static_cast<const float*>(tw),
      static_cast<const float*>(mre), static_cast<const float*>(mim),
      static_cast<float*>(out),       B, T, F, L, hop, out_len, body};
  return dl4ss::istft_launch(
      args, LoadPacked{static_cast<const float*>(spec), T, F},
      static_cast<cudaStream_t>(stream));
}
