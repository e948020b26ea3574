// K1 — STFT features: framing + window + real DFT, emitting |X|, Re X, Im X.
//
// Replaces dl4ss_tpu/ops/pallas_stft.py::_stft_feat_kernel (the Pallas body
// of pallas_stft_features). The reflect pad stays a torch op outside, as in
// the JAX wrapper; this kernel reads the padded signal directly at frame
// offsets t*hop, so it needs no hop-row reshape and takes any hop.
//
// Bound on the H100: bytes. At the serving shape (B=16, T=313, F=129,
// L=256) the function reads 2.6 MB and writes 7.8 MB (~3.1 us at
// 3.35 TB/s), while a real FFT of every frame is ~26 MFLOP (< 0.5 us of
// f32). So the kernel does an FFT's work and no more: the shared-memory
// real-FFT tile of stft_tile.cuh (shared with K9) stages each tile's
// samples once, runs one warp per frame and reads its twiddles from a
// table, which leaves the stores below as the larger part of the traffic.
// A frame length that is no power of two takes that header's direct tile.
//
// This file adds the epilogue: lanes hold neighbouring bins, so the three
// stores of a frame are coalesced; the magnitude is rounded to bf16 here
// when the caller asks for bf16 features.
#include "stft_tile.cuh"

namespace dl4ss {

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
    store(mag + o, sqrtf(r * r + i * i));
  }
};

}  // namespace dl4ss

extern "C" const char* dl4ss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, Np) f32 reflect-padded; win (L,); tw (L/2+1, 2) f32 for the FFT
// tile, cos_t, sin_t (L, F) f32 for the direct tile (the tables of the body
// that does not run may be null); mag (B, T, F) f32 or bf16 (mag_bf16);
// re, im (B, T, F) f32. body: 1 the FFT tile, 2 the direct tile.
extern "C" int dl4ss_stft_features(const void* x, const void* win,
                                   const void* tw, const void* cos_t,
                                   const void* sin_t, void* mag, void* re,
                                   void* im, int B, int Np, int T, int L,
                                   int hop, int F, int mag_bf16, int body,
                                   void* stream) {
  const dl4ss::StftArgs args{
      static_cast<const float*>(x),     static_cast<const float*>(win),
      static_cast<const float*>(tw),    static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), B, Np, T, L, hop, F, body};
  const auto s = static_cast<cudaStream_t>(stream);
  float* re_f = static_cast<float*>(re);
  float* im_f = static_cast<float*>(im);
  if (mag_bf16)
    return dl4ss::stft_launch(
        args,
        dl4ss::EmitFeatures<__nv_bfloat16>{
            static_cast<__nv_bfloat16*>(mag), re_f, im_f, T, F},
        s);
  return dl4ss::stft_launch(
      args, dl4ss::EmitFeatures<float>{static_cast<float*>(mag), re_f, im_f,
                                       T, F},
      s);
}
