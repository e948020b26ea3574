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
// Design: one block per (column tile, K3_TT time rows, utterance). A tile
// owns ft whole E-groups of W (ft*E <= K3_NC columns), so no reduction
// crosses blocks. W's rows of F*E = 6450 bf16 are not 16-byte aligned
// (reading them in place, 4 bytes at a time, cost K3 ~20%: PERF.md), so
// maskhead_pack_kernel lays W out once per weight version as tiles
// (ntiles, Dp, K3_NC) bf16, zero past each tile's columns and past D
// (Dp rounds D up to K3_KT): every W staging load is then an aligned
// 16-byte vector. h is read in its own (B, T, D) layout, 8 bf16 at a
// time, zero-filled past D. The projection runs on the tensor cores
// through WMMA (mma.sync) 16x16x16 bf16 tiles: each of 8 warps owns one
// 16-row strip
// and 8 column tiles of the 64 x 256 block result, so it loads each A
// fragment once per k-slice. The next k-slice of h and W is fetched into
// registers while the tensor cores work on the current one in shared
// memory. The f32 result then goes to shared memory (aliasing the staging
// buffers), where the tanh, the per-k E-contraction and the sigmoid run
// without leaving the block.
// Later work: wgmma with TMA-fed stages, and W reuse across time tiles.
#include <cstdint>

#include <mma.h>

#include "dl4ss_common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int K3_TT = 64;       // time rows per block
constexpr int K3_KT = 32;       // depth of one staged slice of h and W
constexpr int K3_NC = 256;      // columns per tile (ft*E, zero-filled past)
constexpr int K3_WARPS = 8;
constexpr int K3_THREADS = K3_WARPS * 32;
constexpr int K3_CF = K3_NC / 16 / 2;                  // column frags/warp
// shared-memory row strides, padded off a multiple of 128 bytes so the
// fragment loads and the epilogue's column walks spread over the banks
constexpr int K3_AS = K3_KT + 8;     // bf16
constexpr int K3_BS = K3_NC + 8;     // bf16
constexpr int K3_CS = K3_NC + 4;     // f32
constexpr int K3_A_VECS = K3_TT * K3_KT / 8;           // uint4 per A slice
constexpr int K3_B_VECS = K3_KT * K3_NC / 8;           // uint4 per B slice
constexpr int K3_B_PER_THREAD = K3_B_VECS / K3_THREADS;
static_assert(K3_A_VECS == K3_THREADS, "one A vector per thread");
static_assert(K3_TT / 16 * 2 == K3_WARPS, "warp -> (row strip, half)");

// Eight consecutive bf16 row[c..c+8) as one uint4, zero past column n.
// `vec` is the widest access the row's alignment allows: 8, 2 or 1.
__device__ __forceinline__ uint4 load8(const bf16* row, int c, int n,
                                       int vec) {
  if (c + 8 <= n) {
    if (vec == 8) return *reinterpret_cast<const uint4*>(row + c);
    if (vec == 2) {
      const unsigned* p = reinterpret_cast<const unsigned*>(row + c);
      return make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
  union { uint4 v; unsigned short e[8]; } u;
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int i = 0; i < 8; ++i) u.e[i] = c + i < n ? r[c + i] : 0;
  return u.v;
}

// The packed W's geometry: ft whole E-groups per tile, ntiles tiles of
// Dp rows. False when E does not fit a tile.
struct Geometry {
  int ft, ntiles, Dp;
};

bool geometry(int D, int F, int E, Geometry* g) {
  if (D < 1 || F < 1 || E < 1 || E > K3_NC) return false;
  g->ft = std::min(F, K3_NC / E);
  g->ntiles = (F + g->ft - 1) / g->ft;
  g->Dp = (D + K3_KT - 1) / K3_KT * K3_KT;
  return true;
}

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
  bf16* as = reinterpret_cast<bf16*>(smem);              // (TT, AS)
  bf16* bs = as + K3_TT * K3_AS;                         // (KT, BS)
  float* cs = reinterpret_cast<float*>(smem);            // (TT, CS), later
  float* qs = cs + K3_TT * K3_CS;                        // (K, E)

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * K3_TT;
  const int f0 = blockIdx.x * ft;
  const int c0 = f0 * E;                  // first column of W in this tile
  const int nc = min(ft, F - f0) * E;     // columns this tile owns
  const int warp = threadIdx.x / 32;
  const int strip = warp / 2, half = warp % 2;
  const bf16* wt = w + (size_t)blockIdx.x * Dp * K3_NC;

  // A: thread -> (row, 8-column chunk); B: thread -> 4 (row, chunk) pairs
  const int a_row = threadIdx.x / (K3_KT / 8);
  const int a_col = threadIdx.x % (K3_KT / 8) * 8;
  const bool a_live = t0 + a_row < T;
  const bf16* a_src = h + ((size_t)b * T + t0 + a_row) * D;
  uint4 ra, rb[K3_B_PER_THREAD];
  auto fetch = [&](int k0) {
    ra = a_live ? load8(a_src, k0 + a_col, D, h_vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < K3_B_PER_THREAD; ++i) {
      const int v = threadIdx.x + i * K3_THREADS;
      const int row = v / (K3_NC / 8), col = v % (K3_NC / 8) * 8;
      rb[i] = *reinterpret_cast<const uint4*>(
          wt + (size_t)(k0 + row) * K3_NC + col);
    }
  };
  auto stash = [&]() {
    *reinterpret_cast<uint4*>(as + a_row * K3_AS + a_col) = ra;
#pragma unroll
    for (int i = 0; i < K3_B_PER_THREAD; ++i) {
      const int v = threadIdx.x + i * K3_THREADS;
      const int row = v / (K3_NC / 8), col = v % (K3_NC / 8) * 8;
      *reinterpret_cast<uint4*>(bs + row * K3_BS + col) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[K3_CF];
#pragma unroll
  for (int i = 0; i < K3_CF; ++i) wmma::fill_fragment(acc[i], 0.0f);
  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += K3_KT) {
    const bool more = k0 + K3_KT < D;
    if (more) fetch(k0 + K3_KT);    // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < K3_KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, as + strip * 16 * K3_AS + kk, K3_AS);
#pragma unroll
      for (int i = 0; i < K3_CF; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + kk * K3_BS + (half * K3_CF + i) * 16,
                               K3_BS);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < K3_CF; ++i)
    wmma::store_matrix_sync(cs + strip * 16 * K3_CS + (half * K3_CF + i) * 16,
                            acc[i], K3_CS, wmma::mem_row_major);
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

// The widest staging access of h (8, 2 or 1 bf16) that keeps every row
// of D elements aligned.
int vec_width(const void* p, int D) {
  const auto a = reinterpret_cast<uintptr_t>(p);
  if (D % 8 == 0 && a % 16 == 0) return 8;
  if (D % 2 == 0 && a % 4 == 0) return 2;
  return 1;
}

template <typename OutT>
cudaError_t run(const void* h, const void* w, const void* bias,
                const void* q, void* out, int B, int T, int D, int F, int E,
                int K, cudaStream_t stream) {
  Geometry g;
  if (!geometry(D, F, E, &g)) return cudaErrorInvalidValue;
  const dim3 grid(g.ntiles, (T + K3_TT - 1) / K3_TT, B);
  const size_t staging = (size_t)(K3_TT * K3_AS + K3_KT * K3_BS) * sizeof(bf16);
  const size_t result = (size_t)K3_TT * K3_CS * sizeof(float);
  const size_t smem = std::max(staging, result) + (size_t)K * E * sizeof(float);
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
