// K6 — fused mask head backward: recompute g, then the gradients that stay
// inside the E-contraction.
//
// Replaces dl4ss_tpu/ops/pallas_maskhead.py::_bwd_kernel (the Pallas body of
// fused_dot_masks' VJP, _bwd_vjp). With the forward's saved masks m and the
// incoming dout, per (utterance b, time t, frequency f, embedding e):
//   g      = tanh(h[b,t,:].W[:, f*E+e] + bias[f*E+e])       recomputed, f32
//   de_k   = bf16(dout_k * m_k * (1 - m_k))                 (B, K, T, F)
//   dg     = sum_k de_k[t,f] * q_k[e]
//   dacc   = bf16(dg * (1 - g^2))                          -> (B, T, F*E)
//   dq_k[e] = sum over time tiles of sum_f bf16(sum_{t in tile} g * de_k)
// h, W, q, the masks and dout enter as bf16 and are upcast per tile; the
// time tile is 64 rows, as the JAX kernel's default `bwd_tile`, so `col`
// rounds to bf16 at the same points (pallas_maskhead.py:237-241). The 0/1
// S and R matrices of the TPU kernel only route the broadcast over E and
// the fold to E through its matrix unit; here both are plain index
// arithmetic. dW = h^T dacc, dh = dacc W^T and db = sum dacc are plain
// matrix products outside, as in JAX (ops/maskhead_kernels.py).
//
// Bound on the H100: operations, barely. At B=16, T=313, 2H=600,
// F*E=6450 the recomputed projection is 38.8 GFLOP, ~39 us at the dense
// bf16 tensor-core rate; dacc is 64.6 MB of bf16, ~19 us at 3.35 TB/s.
//
// Design: the blocks of K3 (maskhead_tile.cuh): one per (column tile of ft
// whole E-groups, 64 time rows, utterance), reading the W that K3 packed
// for the same weight version. After the projection, the block stages de
// for its rows and frequencies and q in shared memory, writes dacc, sums
// each column over its rows for dq, and folds the bf16-rounded column sums
// to E. Each block writes its own dq partial; a second kernel adds them in
// a fixed order, so dq is deterministic (no atomics).
#include "maskhead_tile.cuh"

namespace {

// Shared memory past the projection tile: q (K, E) and the column sums
// (K, K3_NC) in f32, then de (K, K3_TT, ft) in bf16.
size_t bwd_smem(int K, int E, int ft) {
  return K3_TILE_BYTES + (size_t)K * (E + K3_NC) * sizeof(float) +
         (size_t)K * K3_TT * ft * sizeof(bf16);
}

__global__ void __launch_bounds__(K3_THREADS) maskhead_bwd_kernel(
    const bf16* __restrict__ h,      // (B, T, D)
    const bf16* __restrict__ w,      // packed (ntiles, Dp, K3_NC)
    const float* __restrict__ bias,  // (F*E,)
    const bf16* __restrict__ q,      // (B, K, E)
    const bf16* __restrict__ masks,  // (B, K, T, F) saved forward masks
    const bf16* __restrict__ dout,   // (B, K, T, F)
    bf16* __restrict__ dacc,         // (B, T, F*E)
    float* __restrict__ part,        // (B, T tiles, ntiles, K, E)
    int T, int D, int Dp, int F, int E, int K, int ft, int h_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);                 // (TT, CS)
  float* qs = reinterpret_cast<float*>(smem + K3_TILE_BYTES);  // (K, E)
  float* col = qs + K * E;                                    // (K, NC)
  bf16* des = reinterpret_cast<bf16*>(col + K * K3_NC);       // (K, TT, ft)

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * K3_TT;
  const int f0 = blockIdx.x * ft;
  const int fn = min(ft, F - f0);         // E-groups this tile owns
  const int c0 = f0 * E, nc = fn * E;     // its first column and width
  const int rows = min(K3_TT, T - t0);
  const size_t fe = (size_t)F * E;
  project_tile(h, w + (size_t)blockIdx.x * Dp * K3_NC, smem, b, t0, T, D,
               h_vec);
  for (int i = threadIdx.x; i < K * E; i += K3_THREADS)
    qs[i] = dl4ss::to_f32(q[(size_t)b * K * E + i]);
  for (int i = threadIdx.x; i < K * K3_TT * ft; i += K3_THREADS) {
    const int gi = i % ft, r = i / ft % K3_TT, k = i / (ft * K3_TT);
    float v = 0.0f;
    if (r < rows && gi < fn) {
      const size_t o = (((size_t)b * K + k) * T + t0 + r) * F + f0 + gi;
      const float m = dl4ss::to_f32(masks[o]);
      v = dl4ss::to_f32(dout[o]) * m * (1.0f - m);
    }
    des[i] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // g = tanh(acc + bias), kept in place for the column sums; dacc
  for (int i = threadIdx.x; i < rows * nc; i += K3_THREADS) {
    const int r = i / nc, c = i % nc;
    const int gi = c / E, e = c - gi * E;
    float* p = cs + r * K3_CS + c;
    const float g = tanhf(*p + bias[c0 + c]);
    *p = g;
    float dg = 0.0f;
    for (int k = 0; k < K; ++k)
      dg += __bfloat162float(des[(k * K3_TT + r) * ft + gi]) * qs[k * E + e];
    dacc[((size_t)b * T + t0 + r) * fe + c0 + c] =
        __float2bfloat16_rn(dg * (1.0f - g * g));
  }
  __syncthreads();
  // column sums over this tile's rows, rounded to bf16 as the JAX fold's
  // operand
  for (int i = threadIdx.x; i < K * nc; i += K3_THREADS) {
    const int k = i / nc, c = i % nc, gi = c / E;
    const bf16* dek = des + k * K3_TT * ft + gi;
    float s = 0.0f;
    for (int r = 0; r < rows; ++r)
      s += cs[r * K3_CS + c] * __bfloat162float(dek[r * ft]);
    col[k * K3_NC + c] = __bfloat162float(__float2bfloat16_rn(s));
  }
  __syncthreads();
  // fold the tile's frequencies to E: this block's dq partial
  float* out = part + (((size_t)b * gridDim.y + blockIdx.y) * gridDim.x +
                       blockIdx.x) * K * E;
  for (int i = threadIdx.x; i < K * E; i += K3_THREADS) {
    const int k = i / E, e = i % E;
    float s = 0.0f;
    for (int gi = 0; gi < fn; ++gi) s += col[k * K3_NC + gi * E + e];
    out[i] = s;
  }
}

// dq[b, k, e] = sum over the partials of utterance b, in a fixed order
// (time tile, then column tile).
__global__ void maskhead_dq_kernel(const float* __restrict__ part,
                                   float* __restrict__ dq, int B, int nparts,
                                   int KE) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * KE) return;
  const int b = i / KE, ke = i % KE;
  const float* p = part + (size_t)b * nparts * KE + ke;
  float s = 0.0f;
  for (int j = 0; j < nparts; ++j) s += p[(size_t)j * KE];
  dq[i] = s;
}

}  // namespace

// Floats of the dq partials buffer for these shapes, or -1 when E is
// outside 1..256.
extern "C" long long dl4ss_maskhead_bwd_partials(int B, int T, int D, int F,
                                                 int E, int K) {
  Geometry g;
  if (!geometry(D, F, E, &g)) return -1;
  return (long long)B * ((T + K3_TT - 1) / K3_TT) * g.ntiles * K * E;
}

// h (B, T, D), q (B, K, E), masks and dout (B, K, T, F) in bf16; w packed
// by dl4ss_maskhead_pack; bias (F*E,) f32 -> dacc (B, T, F*E) bf16 and
// dq (B, K, E) f32, with part (dl4ss_maskhead_bwd_partials floats) as
// scratch.
extern "C" int dl4ss_maskhead_bwd(const void* h, const void* w,
                                  const void* bias, const void* q,
                                  const void* masks, const void* dout,
                                  void* dacc, void* part, void* dq, int B,
                                  int T, int D, int F, int E, int K,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  Geometry g;
  if (!geometry(D, F, E, &g) || K < 1) return cudaErrorInvalidValue;
  const dim3 grid(g.ntiles, (T + K3_TT - 1) / K3_TT, B);
  const size_t smem = bwd_smem(K, E, g.ft);
  cudaError_t err = dl4ss::allow_smem(maskhead_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  maskhead_bwd_kernel<<<grid, K3_THREADS, smem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const bf16*>(q),
      static_cast<const bf16*>(masks), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dacc), static_cast<float*>(part), T, D, g.Dp, F, E,
      K, g.ft, vec_width(h, D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = B * K * E;
  maskhead_dq_kernel<<<(total + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dq), B,
      grid.y * grid.x, K * E);
  return cudaGetLastError();
}
