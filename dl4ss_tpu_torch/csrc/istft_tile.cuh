// The inverse real DFT + window + overlap-add tile shared by K4
// (masked_istft.cu) and K10 (istft_ri.cu). Both write the raw overlap-add
//   ola[c, n] = sum_{t covers n} win[j] * irfft(X[c, t])[j],   j = n - t*hop,
// per channel c, where irfft is the inverse real DFT of idft_matrix
// (ops/stft.py): 1/L for the DC and Nyquist bins, 2/L for the others, and
// the imaginary parts of those two bins ignored. The kernels differ only in
// where a channel's spectrum comes from: the caller passes that as a functor
// `load(c, t, f, &re, &im)`.
//
// Replaces the bodies of dl4ss_tpu/ops/pallas_stft.py::_masked_istft_kernel
// and ::_istft_kernel, which multiply the spectrum by the iDFT matrix on the
// matrix unit and overlap-add R = L/hop shifted copies. On the H100 the
// function is bound by its bytes (the spectrum in, the overlap-add out), so
// the work per frame has to be an inverse real FFT's 2.5 L log2 L
// operations, not the direct product's 4 L F.
//
// Two hand-written bodies. The caller names the one to run (the shape rule
// is ops/stft_kernels.py::istft_body); the launch refuses the FFT body on a
// shape it cannot take.
//
// * istft_fft_tile, for a power-of-two L in [32, 2048] whose hop divides it
//   with R = L/hop <= 8 (so hop is a power of two >= 4). One block owns
//   channel c and the output samples [t0*hop, (t0+FR)*hop) of FR =
//   ISTFT_FFT_HOPS hops; the block of the last frame also owns the tail up
//   to (T-1)*hop + L.
//   1. It computes frames t0-R+1 .. t0+FR-1 (clipped to [0, T-1]): the R-1
//      frames of halo are computed again by the block before rather than
//      exchanged, so no block waits on another and nothing is atomic.
//   2. One warp per frame. The warp reads the frame's L/2+1 bins straight
//      from global memory (lanes on neighbouring bins: coalesced) into
//      shared memory, Im of bins 0 and L/2 set to 0. The first FFT stage
//      forms its points as it reads them, by the inverse of the forward
//      tile's split step:
//        Z[n] = (X[n] + conj X[N-n]) + i W_L^{-n} (X[n] - conj X[N-n]),
//      N = L/2, the N-point spectrum of z[m] = x[2m] + i x[2m+1] (times L).
//      IFFT(Z) = conj(FFT(conj Z)): the forward stages of fft_stages.cuh
//      run unchanged on conj Z, between two padded per-warp buffers, with
//      the forward tile's (L/2+1, 2) float64-made table (W_L^{-n} is the
//      conjugate of its row n). The warp then writes
//        frame[2m] = Re Y[m] * w[2m] / L,  frame[2m+1] = -Im Y[m] * w[2m+1] / L
//      into the block's (FR+R-1, L) frame buffer in shared memory; 1/L is
//      folded into the window as it is staged (exact: L is a power of two).
//   3. After one __syncthreads() every thread sums, for 4 owned samples at
//      a time (the same hop row, hop being a multiple of 4), the <= R frames
//      that cover them in ascending t, reading float4s of the frame buffer,
//      and stores a float4: only the overlap-add reaches device memory, and
//      every sample is summed in the same order whatever FR is, so two calls
//      are bit-equal.
//   4. FR = 8: a B=16 batch of 5 s utterances is 1280 blocks for K4 (K=2)
//      and 640 for K10, of 9 warps and 31 KB; a B=1 request spreads over 80.
//      Measured on the H100 beside 4 and 16 (PERF.md): 8 is fastest or
//      equal for both kernels at B=1 and 16.
//   What is left above the byte bound is the launch and the SMs' own work:
//   K4 takes 0.008 ms for 80 blocks (B=1), 0.013 ms for K10's 640 (one
//   round of the 7 blocks an SM holds) and 0.021 ms for 1280 (two rounds).
//
// * ola_tile, for every other shape: the direct iDFT as a gather. One block
//   covers OLA_THREADS consecutive output samples of OLA_CG channels. It
//   stages the spectra of the few frames covering those samples for its
//   channels in shared memory; then each thread sums, for its own sample,
//   the frames covering it, each as a product with the (F, L) iDFT tables
//   read from L2 (coalesced across the threads' consecutive j). f32 on the
//   CUDA cores in both bodies: the bar is 1e-4.
#pragma once

#include <cstdint>

#include "dl4ss_common.cuh"
#include "fft_stages.cuh"

namespace dl4ss {

enum IstftBody { ISTFT_BODY_FFT = 1, ISTFT_BODY_DIRECT = 2 };

// Output hops per block of the FFT body (FR), and the most frames, R =
// L/hop, that may cover a sample there.
constexpr int ISTFT_FFT_HOPS = 8;
constexpr int ISTFT_FFT_MAX_RATIO = 8;

// What the FFT body needs of a shape: a power-of-two L whose stages fill a
// warp and whose buffers fit in shared memory, a hop that divides it (the
// frames of a hop row are then the same for all its samples) and at most
// ISTFT_FFT_MAX_RATIO frames over each sample (the frame buffer's rows).
inline bool istft_fft_takes(int L, int hop) {
  return L >= 32 && L <= 2048 && (L & (L - 1)) == 0 && hop > 0 &&
         L % hop == 0 && L / hop <= ISTFT_FFT_MAX_RATIO;
}

// ---------------------------------------------------------------------------
// The FFT body
// ---------------------------------------------------------------------------

// Frames a block of the FFT body computes at most.
__host__ __device__ inline int istft_fft_frames(int L, int hop) {
  return ISTFT_FFT_HOPS + L / hop - 1;
}

// Warps per block: one per frame, fewer where L makes the FFT buffers large
// (each warp's pair takes 8.5 L bytes).
inline int istft_fft_warps(int L, int hop) {
  return std::max(1, std::min(istft_fft_frames(L, hop), 8192 / L));
}

// Shared-memory layout of the FFT body, in floats: the twiddle table, the
// window, the frame buffer, then two padded buffers per warp (the second
// first holds the frame's N+1 bins).
struct IstftFftLayout {
  int tw, win, frames, buf, buf_points, total;
};
__host__ __device__ inline IstftFftLayout istft_fft_layout(int L, int hop,
                                                           int warps) {
  const int N = L >> 1;
  IstftFftLayout o;
  o.tw = 0;
  o.win = (2 * (N + 1) + 3) & ~3;
  o.frames = o.win + L;
  o.buf = o.frames + istft_fft_frames(L, hop) * L;
  o.buf_points = fft_pad(N) + 1;
  o.total = o.buf + warps * 2 * 2 * o.buf_points;
  return o;
}

template <typename Load>
__device__ __forceinline__ void istft_fft_tile(
    const Load& load,
    const float* __restrict__ win,   // (L,)
    const float* __restrict__ tw_g,  // (L/2+1, 2) cos, -sin(2 pi k / L)
    float* __restrict__ out,         // (C, out_len), 16-byte aligned
    int T, int L, int hop, int out_len) {
  extern __shared__ __align__(16) float smem[];
  constexpr int FR = ISTFT_FFT_HOPS;
  const int N = L >> 1;
  const int R = L / hop;
  const int shift = __ffs(hop) - 1;   // hop is a power of two
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const IstftFftLayout lay = istft_fft_layout(L, hop, warps);
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
  float* wins = smem + lay.win;
  float* frames = smem + lay.frames;

  const int c = blockIdx.y;
  const int t0 = blockIdx.x * FR;
  const int tb = max(0, t0 - R + 1);              // the first frame computed
  const int nf = min(T - 1, t0 + FR - 1) - tb + 1;

  // 1. the twiddles, and the window times the inverse transform's 1/L
  const float inv_l = 1.0f / static_cast<float>(L);
  for (int i = threadIdx.x; i < L; i += blockDim.x) wins[i] = win[i] * inv_l;
  for (int i = threadIdx.x; i <= N; i += blockDim.x)
    tw[i] = reinterpret_cast<const float2*>(tw_g)[i];
  __syncthreads();

  // 2. one warp per frame
  float2* buf_a = reinterpret_cast<float2*>(smem + lay.buf)
                  + (size_t)warp * 2 * lay.buf_points;
  float2* spec = buf_a + lay.buf_points;
  const float2* win2 = reinterpret_cast<const float2*>(wins);
  for (int fr = warp; fr < nf; fr += warps) {
    const int t = tb + fr;
    // 4 bins' loads in flight per lane (K10 0.0148 -> 0.0129 ms on the
    // H100, K4 unchanged; 8 gained nothing: PERF.md)
#pragma unroll 4
    for (int k = lane; k <= N; k += 32) {
      float re, im;
      load(c, t, k, &re, &im);
      spec[k] = make_float2(re, k == 0 || k == N ? 0.0f : im);
    }
    __syncwarp();
    // the first stage reads conj Z[n], formed from bins n and N - n
    const auto conj_z = [&](int n) {
      const float2 a = spec[n];
      const float2 b = spec[N - n];
      const float2 even = make_float2(a.x + b.x, a.y - b.y);
      const float2 diff = make_float2(a.x - b.x, a.y + b.y);
      const float2 w = tw[n];
      const float2 d = cmul(diff, make_float2(w.x, -w.y));   // W_L^{-n}
      return make_float2(even.x - d.y, -(even.y + d.x));
    };
    const float2* y = fft_forward(conj_z, buf_a, spec, tw, N, L, lane);
    float2* row = reinterpret_cast<float2*>(frames + fr * L);
    for (int m = lane; m < N; m += 32) {
      const float2 v = y[fft_pad(m)];
      const float2 w = win2[m];
      row[m] = make_float2(v.x * w.x, -v.y * w.y);
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. overlap-add of the owned samples, four at a time
  const int s0 = t0 * hop;
  const int s1 = t0 + FR < T ? s0 + FR * hop : out_len;
  const float4* frames4 = reinterpret_cast<const float4*>(frames);
  float4* out4 = reinterpret_cast<float4*>(out + (size_t)c * out_len + s0);
  for (int i = threadIdx.x; i < (s1 - s0) >> 2; i += blockDim.x) {
    const int n = s0 + 4 * i;
    const int q = n >> shift;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int t = max(0, q - R + 1); t <= min(T - 1, q); ++t) {
      const float4 v = frames4[((t - tb) * L + n - (t << shift)) >> 2];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    out4[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// The direct body
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The two kernels and their launch
// ---------------------------------------------------------------------------

// What every iSTFT entry point is given beside its spectrum.
struct IstftArgs {
  const float* win;    // (L,)
  const float* tw;     // (L/2+1, 2), the FFT body's table (else null)
  const float* mre;    // (F, L), the direct body's tables (else null)
  const float* mim;
  float* out;          // (C, out_len), out_len = (T-1)*hop + L
  int C, T, F, L, hop, out_len;
  int body;            // IstftBody
};

template <typename Load>
__global__ void istft_fft_kernel(IstftArgs a, Load load) {
  istft_fft_tile(load, a.win, a.tw, a.out, a.T, a.L, a.hop, a.out_len);
}
template <typename Load>
__global__ void __launch_bounds__(OLA_THREADS)
    istft_direct_kernel(IstftArgs a, Load load) {
  ola_tile(load, a.mre, a.mim, a.win, a.out, a.C, a.T, a.F, a.L, a.hop,
           a.out_len);
}

// Launch the body that a.body names, with `load` as its spectrum. A body
// that cannot take the shape, or whose table is missing, is refused.
template <typename Load>
inline cudaError_t istft_launch(const IstftArgs& a, const Load& load,
                                cudaStream_t stream) {
  if (a.C <= 0 || a.T <= 0) return cudaSuccess;
  if (a.F != a.L / 2 + 1 || a.out_len != (a.T - 1) * a.hop + a.L)
    return cudaErrorInvalidValue;
  if (a.body == ISTFT_BODY_FFT) {
    if (!istft_fft_takes(a.L, a.hop) || !a.tw || a.C > 65535 ||
        (reinterpret_cast<uintptr_t>(a.out) & 15))
      return cudaErrorInvalidValue;
    constexpr int FR = ISTFT_FFT_HOPS;
    const int warps = istft_fft_warps(a.L, a.hop);
    const size_t smem =
        sizeof(float) * istft_fft_layout(a.L, a.hop, warps).total;
    cudaError_t err = allow_smem(istft_fft_kernel<Load>, smem);
    if (err != cudaSuccess) return err;
    istft_fft_kernel<Load>
        <<<dim3((a.T + FR - 1) / FR, a.C), 32 * warps, smem, stream>>>(a,
                                                                       load);
  } else if (a.body == ISTFT_BODY_DIRECT) {
    if (!a.mre || !a.mim) return cudaErrorInvalidValue;
    const int max_frames = (OLA_THREADS - 1 + a.L - 1) / a.hop + 1;
    const size_t smem = sizeof(float) * OLA_CG * max_frames * 2 * a.F;
    cudaError_t err = allow_smem(istft_direct_kernel<Load>, smem);
    if (err != cudaSuccess) return err;
    istft_direct_kernel<Load>
        <<<dim3((a.out_len + OLA_THREADS - 1) / OLA_THREADS,
                (a.C + OLA_CG - 1) / OLA_CG),
           OLA_THREADS, smem, stream>>>(a, load);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace dl4ss
