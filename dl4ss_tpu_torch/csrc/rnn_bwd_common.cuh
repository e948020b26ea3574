// Kernels shared by the recurrent backward passes, K5 (gru_bwd.cu) and K8
// (lstm_bwd.cu): the transpose of the recurrent weights U, built once per
// call so the carry product reads U^T coalesced, and the weight gradient
// dU = sum over (t, b) of hprev^T . da, taken after the step loop in a
// fixed order (deterministic: no atomics, no library product).
#pragma once

#include "dl4ss_common.cuh"

namespace dl4ss {

// ut[d, g, k] = u[d, k, g] for u (D, H, G), through 32 x 32 shared tiles.
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ u, T* __restrict__ ut,
                                 int H, int G) {
  __shared__ float tile[32][33];     // bf16 -> f32 -> bf16 is exact
  const int d = blockIdx.z;
  const int g0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const T* src = u + (size_t)d * H * G;
  T* dst = ut + (size_t)d * H * G;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int k = k0 + i, g = g0 + threadIdx.x;
    if (k < H && g < G) tile[i][threadIdx.x] = to_f32(src[(size_t)k * G + g]);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int g = g0 + i, k = k0 + threadIdx.x;
    if (k < H && g < G) store(dst + (size_t)g * H + k, tile[threadIdx.x][i]);
  }
}

template <typename T>
inline cudaError_t transpose(const T* u, T* ut, int D, int H, int G,
                             cudaStream_t stream) {
  transpose_kernel<T><<<dim3((G + 31) / 32, (H + 31) / 32, D), dim3(32, 8), 0,
                        stream>>>(u, ut, H, G);
  return cudaGetLastError();
}

// dU[d, k, g] = sum over n = (t, b) of hprev[t, d, b, k] * da[t, d, b, g],
// in f32: a 64 x 64 output tile per block, 4 x 4 outputs per thread, the n
// axis walked in slices of 16 through shared memory in a fixed order.
constexpr int DU_T = 64, DU_N = 16, DU_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DU_THREADS) du_kernel(
    const T* __restrict__ hprev,   // (T, D, B, H)
    const T* __restrict__ da,      // (T, D, B, G)
    float* __restrict__ du,        // (D, H, G)
    int steps, int D, int B, int H, int G) {
  __shared__ float as[DU_N][DU_T], bs[DU_N][DU_T];
  const int g0 = blockIdx.x * DU_T, k0 = blockIdx.y * DU_T, d = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_total = steps * B;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < n_total; n0 += DU_N) {
    for (int i = threadIdx.x; i < DU_N * DU_T; i += DU_THREADS) {
      const int nn = i / DU_T, cc = i % DU_T, n = n0 + nn;
      const size_t row = ((size_t)(n / B) * D + d) * B + n % B;
      const bool live = n < n_total;
      as[nn][cc] = live && k0 + cc < H ? to_f32(hprev[row * H + k0 + cc])
                                       : 0.0f;
      bs[nn][cc] = live && g0 + cc < G ? to_f32(da[row * G + g0 + cc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < DU_N; ++nn) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[nn][ty + 16 * i];
        bv[i] = bs[nn][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[i][l] = fmaf(av[i], bv[l], acc[i][l]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int k = k0 + ty + 16 * i, g = g0 + tx + 16 * l;
      if (k < H && g < G) du[((size_t)d * H + k) * G + g] = acc[i][l];
    }
}

template <typename T>
inline cudaError_t weight_grad(const T* hprev, const T* da, float* du,
                               int steps, int D, int B, int H, int G,
                               cudaStream_t stream) {
  du_kernel<T><<<dim3((G + DU_T - 1) / DU_T, (H + DU_T - 1) / DU_T, D),
                 DU_THREADS, 0, stream>>>(hprev, da, du, steps, D, B, H, G);
  return cudaGetLastError();
}

}  // namespace dl4ss
