// The complex FFT stages shared by the forward real-FFT tile (stft_tile.cuh,
// K1 and K9) and the inverse one (istft_tile.cuh, K4 and K10).
//
// One warp runs an N-point complex FFT (N = L/2, a power of two) as
// Stockham autosort stages, radix 4 and one last radix-2 stage when log2 N
// is odd, between two padded shared-memory buffers with __syncwarp()
// between stages. Every twiddle comes from one (L/2+1, 2) table of
// cos, -sin(2 pi k/L), made in float64 on the host: W_N^k = W_L^{2k} serves
// the stages and W_L^q = -W_L^{q-L/2} the upper half, so no sincosf runs.
// The stages compute the forward transform; the inverse tile runs them on
// conj(Z) and conjugates the result, since IFFT(Z) = conj(FFT(conj Z)).
#pragma once

#include "dl4ss_common.cuh"

namespace dl4ss {

// Index into a warp's FFT buffer: one float2 of padding after every 16, so
// the stride-4p stores of the early stages spread over the banks.
__host__ __device__ __forceinline__ int fft_pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// W_L^q for 0 <= q < L from the half table tw[0 .. L/2].
__device__ __forceinline__ float2 twiddle(const float2* tw, int q, int half) {
  if (q <= half) return tw[q];
  const float2 w = tw[q - half];
  return make_float2(-w.x, -w.y);
}

// One Stockham radix-4 stage of an N-point FFT whose sub-transforms have
// length p so far: butterfly i reads points i + m N/4 and writes points
// 4 (i - k) + k + m p, k = i mod p, with twiddles W_{4p}^{k m}.
template <typename Load>
__device__ __forceinline__ void fft_radix4(const Load& load, float2* dst,
                                           const float2* tw, int N, int p,
                                           int L, int lane) {
  const int quarter = N >> 2;
  const int step = L / (4 * p);   // W_{4p}^k = W_L^{k step}
  for (int i = lane; i < quarter; i += 32) {
    const int k = i & (p - 1);
    const float2 u0 = load(i);
    float2 u1 = load(i + quarter);
    float2 u2 = load(i + 2 * quarter);
    float2 u3 = load(i + 3 * quarter);
    if (p > 1) {
      u1 = cmul(u1, twiddle(tw, k * step, L >> 1));
      u2 = cmul(u2, twiddle(tw, 2 * k * step, L >> 1));
      u3 = cmul(u3, twiddle(tw, 3 * k * step, L >> 1));
    }
    const float2 v0 = cadd(u0, u2), v1 = csub(u0, u2), v2 = cadd(u1, u3);
    const float2 d = csub(u1, u3);
    const float2 v3 = make_float2(d.y, -d.x);   // -i (u1 - u3)
    const int j = ((i - k) << 2) + k;
    dst[fft_pad(j)] = cadd(v0, v2);
    dst[fft_pad(j + p)] = cadd(v1, v3);
    dst[fft_pad(j + 2 * p)] = csub(v0, v2);
    dst[fft_pad(j + 3 * p)] = csub(v1, v3);
  }
}

// The last stage when log2 N is odd: radix 2 with p = N/2.
__device__ __forceinline__ void fft_radix2_last(const float2* src,
                                                float2* dst,
                                                const float2* tw, int N,
                                                int L, int lane) {
  const int p = N >> 1;
  const int step = L / N;         // W_N^k = W_L^{k step}
  for (int k = lane; k < p; k += 32) {
    const float2 u0 = src[fft_pad(k)];
    const float2 u1 = cmul(src[fft_pad(k + p)], twiddle(tw, k * step, L >> 1));
    dst[fft_pad(k)] = cadd(u0, u1);
    dst[fft_pad(k + p)] = csub(u0, u1);
  }
}

// The whole N-point forward FFT of one warp. The first stage reads its
// input points through `load(n)`, so the caller forms them as they are
// read; the stages then alternate between the padded buffers buf_a and
// buf_b. Returns the buffer that holds the result (in fft_pad order),
// which the warp may read after the __syncwarp() that ends the last stage.
template <typename Load>
__device__ __forceinline__ const float2* fft_forward(const Load& load,
                                                     float2* buf_a,
                                                     float2* buf_b,
                                                     const float2* tw, int N,
                                                     int L, int lane) {
  float2* cur = buf_a;
  float2* nxt = buf_b;
  fft_radix4(load, cur, tw, N, 1, L, lane);
  __syncwarp();
  int p = 4;
  for (; 4 * p <= N; p <<= 2) {
    const float2* from = cur;
    fft_radix4([&](int n) { return from[fft_pad(n)]; }, nxt, tw, N, p, L,
               lane);
    __syncwarp();
    float2* t = cur; cur = nxt; nxt = t;
  }
  if (p < N) {
    fft_radix2_last(cur, nxt, tw, N, L, lane);
    __syncwarp();
    float2* t = cur; cur = nxt; nxt = t;
  }
  return cur;
}

}  // namespace dl4ss
