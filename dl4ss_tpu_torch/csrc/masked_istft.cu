// K4 — masked iSTFT: mask apply + inverse real DFT + window + overlap-add.
//
// Replaces dl4ss_tpu/ops/pallas_stft.py::_masked_istft_kernel (the Pallas
// body of pallas_masked_istft). For each channel (b, k) it writes the raw
// overlap-add
//   ola[b,k,n] = sum_{t covers n} win[j] * irfft(m . X[b,t])[j],
// j = n - t*hop, with m = masks[b,k,t,:] and X the mixture spectrum
// (Re, Im). The window-square normalisation, center trim and length pad
// stay plain torch outside, as in the JAX wrapper (pallas_stft.py:288-308).
//
// Bound on the H100: bytes. At B=16, K=2, T=313, F=129, L=256 the function
// reads Re, Im and the masks (~10.3 MB in f32) and writes the overlap-add
// (~5.1 MB): ~4.6 us at 3.35 TB/s, while the inverse real FFTs of its
// 10,016 frames are ~51 MFLOP (< 1 us of f32). So the kernel does an FFT's
// work and no more: the shared-memory inverse real-FFT tile of
// istft_tile.cuh (shared with K10; one block per channel and 8 output hops,
// one warp per frame, the forward tile's FFT stages run on conj Z, the
// overlap-add summed in shared memory, no atomics), which leaves the launch
// and the traffic. A frame length that is no power of two takes that
// header's direct iDFT gather.
//
// This file adds the loader, which applies the mask as the warp reads the
// frame's bins (lanes on neighbouring bins: coalesced).
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

}  // namespace

// re, im (B, T, F) f32; masks (B, K, T, F) f32, or bf16 when mask_bf16;
// win (L,) f32; tw (L/2+1, 2) f32 for the FFT tile, mre, mim (F, L) f32 for
// the direct tile (the tables of the body that does not run may be null);
// out (B, K, (T-1)*hop + L) f32. body: 1 the FFT tile, 2 the direct tile.
extern "C" int dl4ss_masked_istft(const void* re, const void* im,
                                  const void* masks, const void* win,
                                  const void* tw, const void* mre,
                                  const void* mim, void* out, int B, int K,
                                  int T, int F, int L, int hop, int out_len,
                                  int mask_bf16, int body, void* stream) {
  const dl4ss::IstftArgs args{
      static_cast<const float*>(win), static_cast<const float*>(tw),
      static_cast<const float*>(mre), static_cast<const float*>(mim),
      static_cast<float*>(out),       B * K, T, F, L, hop, out_len, body};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* re_f = static_cast<const float*>(re);
  const auto* im_f = static_cast<const float*>(im);
  if (mask_bf16)
    return dl4ss::istft_launch(
        args,
        LoadMasked<__nv_bfloat16>{re_f, im_f,
                                  static_cast<const __nv_bfloat16*>(masks), K,
                                  T, F},
        s);
  return dl4ss::istft_launch(
      args,
      LoadMasked<float>{re_f, im_f, static_cast<const float*>(masks), K, T,
                        F},
      s);
}
