// K3 — fused mask head forward: projection + tanh + dot attention + sigmoid.
//
// Replaces dl4ss_tpu/ops/pallas_maskhead.py::_kernel (the Pallas body of
// fused_dot_masks' forward). Per (utterance b, time t, frequency f):
//   g[f*E+e] = tanh(h[b,t,:].W[:, f*E+e] + bias[f*E+e])
//   mask[b,k,t,f] = sigmoid(sum_e bf16(g[f*E+e] * q[b,k,e]))
// with h, W and q in bf16, f32 accumulation, and the g*q product rounded to
// bf16 before the E-sum — the rounding points of the JAX kernel
// (pallas_maskhead.py:61-67). The (B, T, F*E) embedding grid never reaches
// device memory: only the (B, K, T, F) masks are written.
//
// Bound on the H100: operations. At B=16, T=313, 2H=600, F*E=6450 the
// projection is 38.8 GFLOP, ~39 us at the dense bf16 tensor-core rate;
// the bytes (h, W, masks: ~20 MB) take ~6 us. This WMMA version reaches a
// fraction of the rate (PERF.md); W is re-read from L2 by every time tile.
//
// Design: one block per (column tile, K3_TT time rows, utterance). The
// projection tile, its WMMA main loop and W's packed layout live in
// maskhead_tile.cuh, shared with the backward K6. The f32 result goes to
// shared memory (aliasing the staging buffers), where the tanh, the
// per-k E-contraction and the sigmoid run without leaving the block.
// Later work: wgmma with TMA-fed stages, and W reuse across time tiles.
#include "maskhead_tile.cuh"

namespace {

template <typename InT>
__global__ void maskhead_pack_kernel(const InT* __restrict__ w,  // (D, F*E)
                                     bf16* __restrict__ wt,  // (ntiles, Dp, NC)
                                     int D, int Dp, int fe, int nc_tile,
                                     size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = i % K3_NC;
    const int k = i / K3_NC % Dp;
    const int col = (int)(i / ((size_t)K3_NC * Dp)) * nc_tile + c;
    const bool live = k < D && c < nc_tile && col < fe;
    wt[i] = __float2bfloat16_rn(live ? dl4ss::to_f32(w[(size_t)k * fe + col])
                                     : 0.0f);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(K3_THREADS) maskhead_fwd_kernel(
    const bf16* __restrict__ h,     // (B, T, D)
    const bf16* __restrict__ w,     // packed (ntiles, Dp, K3_NC)
    const float* __restrict__ bias, // (F*E,)
    const bf16* __restrict__ q,     // (B, K, E)
    OutT* __restrict__ out,         // (B, K, T, F)
    int T, int D, int Dp, int F, int E, int K, int ft, int h_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);            // (TT, CS)
  float* qs = reinterpret_cast<float*>(smem + K3_TILE_BYTES);  // (K, E)

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * K3_TT;
  const int f0 = blockIdx.x * ft;
  const int c0 = f0 * E;                  // first column of W in this tile
  const int nc = min(ft, F - f0) * E;     // columns this tile owns
  project_tile(h, w + (size_t)blockIdx.x * Dp * K3_NC, smem, b, t0, T, D,
               h_vec);
  for (int i = threadIdx.x; i < K * E; i += K3_THREADS)
    qs[i] = dl4ss::to_f32(q[(size_t)b * K * E + i]);
  __syncthreads();
  // g = tanh(acc + bias), in place
  for (int i = threadIdx.x; i < K3_TT * nc; i += K3_THREADS) {
    const int r = i / nc, c = i % nc;
    cs[r * K3_CS + c] = tanhf(cs[r * K3_CS + c] + bias[c0 + c]);
  }
  __syncthreads();
  // mask[b, k, t, f] = sigmoid(sum_e bf16(g * q_k)); consecutive threads
  // take consecutive rows, so their column walks fall in distinct banks
  for (int i = threadIdx.x; i < K * K3_TT * ft; i += K3_THREADS) {
    const int r = i % K3_TT, gi = i / K3_TT % ft, k = i / (K3_TT * ft);
    const int t = t0 + r, f = f0 + gi;
    if (t >= T || f >= F) continue;
    const float* g = cs + r * K3_CS + gi * E;
    const float* qk = qs + k * E;
    float e = 0.0f;
    for (int x = 0; x < E; ++x)
      e += __bfloat162float(__float2bfloat16_rn(g[x] * qk[x]));
    dl4ss::store(out + (((size_t)b * K + k) * T + t) * F + f,
                 dl4ss::sigmoid(e));
  }
}

template <typename OutT>
cudaError_t run(const void* h, const void* w, const void* bias,
                const void* q, void* out, int B, int T, int D, int F, int E,
                int K, cudaStream_t stream) {
  Geometry g;
  if (!geometry(D, F, E, &g)) return cudaErrorInvalidValue;
  const dim3 grid(g.ntiles, (T + K3_TT - 1) / K3_TT, B);
  const size_t smem = K3_TILE_BYTES + (size_t)K * E * sizeof(float);
  cudaError_t err = dl4ss::allow_smem(maskhead_fwd_kernel<OutT>, smem);
  if (err != cudaSuccess) return err;
  maskhead_fwd_kernel<OutT><<<grid, K3_THREADS, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const bf16*>(q),
      static_cast<OutT*>(out), T, D, g.Dp, F, E, K, g.ft, vec_width(h, D));
  return cudaGetLastError();
}

template <typename InT>
cudaError_t pack(const void* w, void* wt, int D, int F, int E,
                 cudaStream_t stream) {
  Geometry g;
  if (!geometry(D, F, E, &g)) return cudaErrorInvalidValue;
  const size_t n = (size_t)g.ntiles * g.Dp * K3_NC;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  maskhead_pack_kernel<InT><<<blocks, 256, 0, stream>>>(
      static_cast<const InT*>(w), static_cast<bf16*>(wt), D, g.Dp, F * E,
      g.ft * E, n);
  return cudaGetLastError();
}

}  // namespace

// Elements of the packed W (bf16) for W (D, F*E), or -1 when E is outside
// 1..256.
extern "C" long long dl4ss_maskhead_packed_size(int D, int F, int E) {
  Geometry g;
  if (!geometry(D, F, E, &g)) return -1;
  return (long long)g.ntiles * g.Dp * K3_NC;
}

// w (D, F*E) in f32 (w_f32 != 0) or bf16 -> wt, the packed bf16 tiles.
extern "C" int dl4ss_maskhead_pack(const void* w, void* wt, int D, int F,
                                   int E, int w_f32, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return w_f32 ? pack<float>(w, wt, D, F, E, s)
               : pack<bf16>(w, wt, D, F, E, s);
}

// h (B, T, D) bf16; w packed by dl4ss_maskhead_pack; q (B, K, E) bf16;
// bias (F*E,) f32; out (B, K, T, F) in f32, or bf16 when out_bf16 != 0.
extern "C" int dl4ss_maskhead_fwd(const void* h, const void* w,
                                  const void* bias, const void* q, void* out,
                                  int B, int T, int D, int F, int E, int K,
                                  int out_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? run<bf16>(h, w, bias, q, out, B, T, D, F, E, K, s)
                  : run<float>(h, w, bias, q, out, B, T, D, F, E, K, s);
}
