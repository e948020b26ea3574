// The framing + window + real DFT tiles shared by K1 (stft_features.cu) and
// K9 (stft_ri.cu). Both kernels read the (reflect-padded) signal directly at
// frame offsets t*hop and differ only in what they write per (frame, bin):
// the caller passes that as an epilogue functor `emit(b, t, f, re, im)`.
//
// Replaces the bodies of dl4ss_tpu/ops/pallas_stft.py::_stft_feat_kernel
// and ::_stft_kernel, which form frames(x) * win and multiply by the real
// DFT matrix on the matrix unit. On the H100 the function is bound by its
// bytes (the signal in, the spectrum out: ~3 us at B=16 and 5 s utterances),
// so the work per frame has to be the least there is, a real FFT's
// 2.5 L log2 L operations, not the direct product's 4 L F.
//
// Two hand-written bodies. The caller names the one to run (the shape rule
// is ops/stft_kernels.py::stft_body); the launch refuses the FFT body on a
// shape it cannot take.
//
// * stft_fft_tile, for a power-of-two L in [32, 2048] and hop <= L. One
//   block covers utterance b and a tile of FR = STFT_FFT_FRAMES frames.
//   1. It copies the (FR-1)*hop + L samples the tile spans from global to
//      shared memory once, in 16-byte loads from the aligned address at or
//      below the tile's first sample, so the overlap of neighbouring frames
//      costs no second global read and no (B, T, L) frame tensor is formed.
//      The window and the twiddle table land in shared memory beside it.
//   2. One warp per frame. The warp packs the windowed frame into L/2
//      complex points z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] as it reads
//      them, runs an L/2-point complex FFT as Stockham autosort stages
//      (radix 4, and one last radix-2 stage when log2(L/2) is odd) between
//      two padded per-warp shared-memory buffers with __syncwarp() (the
//      stages of fft_stages.cuh, shared with the inverse tile), and
//      splits the result into the L/2+1 bins of the real transform,
//      X[k] = (Z[k] + conj Z[L/2-k])/2 - i W_L^k (Z[k] - conj Z[L/2-k])/2.
//   3. Every twiddle comes from one (L/2+1, 2) table of cos, -sin(2 pi k/L)
//      made in float64 on the host: W_{L/2}^k = W_L^{2k} serves the stages,
//      W_L^{q} = -W_L^{q-L/2} the upper half, so no sincosf runs and the
//      error stays at f32 round-off.
//   4. Lanes stride over k in the split step, so the epilogue's stores of a
//      frame's bins are coalesced.
//   5. FR = 8 frames, so 8 warps, per block: a B=16 batch of 5 s utterances
//      is 640 blocks of ~24 KB, all resident at once on the 132 SMs, and a
//      B=1 request still spreads over 40. Measured on the H100 beside 4 and
//      16 (PERF.md): 8 is fastest or equal at B=1, 16 and 32.
//   What is left above the byte bound is the launch itself and the latency
//   of one block's load -> FFT -> store chain: every block is resident at
//   once, so the phases do not overlap across blocks. Conflict-free buffer
//   indexing, 8-byte frame loads, per-stage twiddle tables and two frames
//   per warp were each tried on the card and moved nothing or lost.
//
// * stft_direct_tile, for every other L: the direct product. One block per
//   (utterance, 16 frames) stages its windowed frames in shared memory;
//   each thread owns one bin and keeps 16 Re/Im accumulators in registers,
//   so each cos/-sin table value read from global memory (coalesced across
//   f, L2-resident) feeds 32 FMAs. f32 FMA on the CUDA cores throughout (no
//   TF32): the parity bar is 1e-4 against the reference's Precision.HIGHEST.
#pragma once

#include <cstdint>

#include "dl4ss_common.cuh"
#include "fft_stages.cuh"

namespace dl4ss {

enum StftBody { STFT_BODY_FFT = 1, STFT_BODY_DIRECT = 2 };

// Frames per block of the FFT body.
constexpr int STFT_FFT_FRAMES = 8;

// What the FFT body needs of a shape: a power-of-two L whose stages fill a
// warp and whose buffers fit in shared memory, and frames that lie inside
// the staged span.
inline bool stft_fft_takes(int L, int hop) {
  return L >= 32 && L <= 2048 && (L & (L - 1)) == 0 && hop > 0 && hop <= L;
}

// ---------------------------------------------------------------------------
// The FFT body
// ---------------------------------------------------------------------------

// Shared-memory layout of the FFT body, in floats: the twiddle table, the
// window, the staged samples (3 floats of slack for the aligned copy), then
// two padded N-point buffers per warp.
struct StftFftLayout {
  int tw, win, sig, buf, buf_points, total;
};
__host__ __device__ inline StftFftLayout stft_fft_layout(int L, int hop,
                                                         int warps) {
  const int N = L >> 1;
  StftFftLayout o;
  o.tw = 0;
  o.win = (2 * (N + 1) + 3) & ~3;
  o.sig = o.win + L;
  o.buf = o.sig + (((STFT_FFT_FRAMES - 1) * hop + L + 3 + 3) & ~3);
  o.buf_points = fft_pad(N - 1) + 1;
  o.total = o.buf + warps * 2 * 2 * o.buf_points;
  return o;
}

template <typename Emit>
__device__ __forceinline__ void stft_fft_tile(
    const float* __restrict__ x,    // (B, Np) reflect-padded signal
    const float* __restrict__ win,  // (L,)
    const float* __restrict__ tw_g, // (L/2+1, 2) cos, -sin(2 pi k / L)
    int Np, int T, int L, int hop, const Emit& emit) {
  extern __shared__ __align__(16) float smem[];
  const int N = L >> 1;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int FR = STFT_FFT_FRAMES;
  const StftFftLayout lay = stft_fft_layout(L, hop, warps);
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
  float* wins = smem + lay.win;
  float* sig = smem + lay.sig;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FR;
  const int nf = min(FR, T - t0);
  const int span = (nf - 1) * hop + L;   // samples this tile's frames cover

  // 1. stage the tile's samples, the window and the twiddles
  const float* src = x + (size_t)b * Np + (size_t)t0 * hop;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float4* src4 = reinterpret_cast<const float4*>(src - mis);
  const int n4 = (mis + span) >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<float4*>(sig)[i] = src4[i];
  for (int i = (n4 << 2) + threadIdx.x; i < mis + span; i += blockDim.x)
    sig[i] = src[i - mis];
  for (int i = threadIdx.x; i < L; i += blockDim.x) wins[i] = win[i];
  for (int i = threadIdx.x; i <= N; i += blockDim.x)
    tw[i] = reinterpret_cast<const float2*>(tw_g)[i];
  __syncthreads();

  // 2. one warp per frame
  float2* buf_a = reinterpret_cast<float2*>(smem + lay.buf)
                  + (size_t)warp * 2 * lay.buf_points;
  float2* buf_b = buf_a + lay.buf_points;
  for (int fr = warp; fr < nf; fr += warps) {
    const float* frame = sig + mis + fr * hop;
    // the first stage reads the windowed, even/odd-packed frame itself
    const auto packed = [&](int n) {
      return make_float2(frame[2 * n] * wins[2 * n],
                         frame[2 * n + 1] * wins[2 * n + 1]);
    };
    const float2* cur = fft_forward(packed, buf_a, buf_b, tw, N, L, lane);
    // 3. split the N-point transform of z into the N+1 bins of the real one
    for (int k = lane; k <= N; k += 32) {
      const float2 zk = cur[fft_pad(k & (N - 1))];
      const float2 zn = cur[fft_pad((N - k) & (N - 1))];
      const float2 even = make_float2(0.5f * (zk.x + zn.x),
                                      0.5f * (zk.y - zn.y));
      const float2 diff = make_float2(0.5f * (zk.x - zn.x),
                                      0.5f * (zk.y + zn.y));
      const float2 c = cmul(diff, tw[k]);
      emit(b, t0 + fr, k, even.x + c.y, even.y - c.x);
    }
    __syncwarp();
  }
}

// Warps per block: one per frame, fewer where L makes the FFT buffers large
// (each warp's pair takes 8.5 L bytes).
inline int stft_fft_warps(int L) {
  return std::max(1, std::min(STFT_FFT_FRAMES, 8192 / L));
}

// ---------------------------------------------------------------------------
// The direct body
// ---------------------------------------------------------------------------

constexpr int STFT_DIRECT_FRAMES = 16;

template <typename Emit>
__device__ __forceinline__ void stft_direct_tile(
    const float* __restrict__ x,      // (B, Np) reflect-padded signal
    const float* __restrict__ win,    // (L,)
    const float* __restrict__ cos_t,  // (L, F) cos
    const float* __restrict__ sin_t,  // (L, F) -sin
    int Np, int T, int L, int hop, int F, const Emit& emit) {
  extern __shared__ __align__(16) float smem[];  // (16, L) windowed frames
  float* frames = smem;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * STFT_DIRECT_FRAMES;
  const int nf = min(STFT_DIRECT_FRAMES, T - t0);
  const float* xb = x + (size_t)b * Np;
  for (int i = threadIdx.x; i < STFT_DIRECT_FRAMES * L; i += blockDim.x) {
    const int fr = i / L, n = i - fr * L;
    frames[i] = fr < nf ? xb[(size_t)(t0 + fr) * hop + n] * win[n] : 0.0f;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc_re[STFT_DIRECT_FRAMES], acc_im[STFT_DIRECT_FRAMES];
#pragma unroll
    for (int j = 0; j < STFT_DIRECT_FRAMES; ++j) acc_re[j] = acc_im[j] = 0.0f;
    for (int n = 0; n < L; ++n) {
      const float c = cos_t[(size_t)n * F + f];
      const float s = sin_t[(size_t)n * F + f];
#pragma unroll
      for (int j = 0; j < STFT_DIRECT_FRAMES; ++j) {
        const float v = frames[j * L + n];
        acc_re[j] = fmaf(v, c, acc_re[j]);
        acc_im[j] = fmaf(v, s, acc_im[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < STFT_DIRECT_FRAMES; ++j)
      if (j < nf) emit(b, t0 + j, f, acc_re[j], acc_im[j]);
  }
}

// ---------------------------------------------------------------------------
// The two kernels and their launch
// ---------------------------------------------------------------------------

// What every STFT entry point is given beside its outputs.
struct StftArgs {
  const float* x;      // (B, Np)
  const float* win;    // (L,)
  const float* tw;     // (L/2+1, 2), the FFT body's table (else null)
  const float* cos_t;  // (L, F), the direct body's tables (else null)
  const float* sin_t;
  int B, Np, T, L, hop, F;
  int body;            // StftBody
};

template <typename Emit>
__global__ void stft_fft_kernel(StftArgs a, Emit emit) {
  stft_fft_tile(a.x, a.win, a.tw, a.Np, a.T, a.L, a.hop, emit);
}
template <typename Emit>
__global__ void stft_direct_kernel(StftArgs a, Emit emit) {
  stft_direct_tile(a.x, a.win, a.cos_t, a.sin_t, a.Np, a.T, a.L, a.hop, a.F,
                   emit);
}

// Launch the body that a.body names, with `emit` as its epilogue. A body
// that cannot take the shape, or whose table is missing, is refused.
template <typename Emit>
inline cudaError_t stft_launch(const StftArgs& a, const Emit& emit,
                               cudaStream_t stream) {
  if (a.B <= 0 || a.T <= 0) return cudaSuccess;
  if (a.body == STFT_BODY_FFT) {
    if (!stft_fft_takes(a.L, a.hop) || !a.tw) return cudaErrorInvalidValue;
    constexpr int FR = STFT_FFT_FRAMES;
    const int warps = stft_fft_warps(a.L);
    const size_t smem =
        sizeof(float) * stft_fft_layout(a.L, a.hop, warps).total;
    cudaError_t err = allow_smem(stft_fft_kernel<Emit>, smem);
    if (err != cudaSuccess) return err;
    stft_fft_kernel<Emit>
        <<<dim3((a.T + FR - 1) / FR, a.B), 32 * warps, smem, stream>>>(
            a, emit);
  } else if (a.body == STFT_BODY_DIRECT) {
    if (!a.cos_t || !a.sin_t) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * STFT_DIRECT_FRAMES * a.L;
    cudaError_t err = allow_smem(stft_direct_kernel<Emit>, smem);
    if (err != cudaSuccess) return err;
    const int threads = std::min(256, (a.F + 31) / 32 * 32);
    stft_direct_kernel<Emit>
        <<<dim3((a.T + STFT_DIRECT_FRAMES - 1) / STFT_DIRECT_FRAMES, a.B),
           threads, smem, stream>>>(a, emit);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace dl4ss
