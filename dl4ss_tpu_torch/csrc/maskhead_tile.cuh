// The projection tile shared by the mask-head kernels K3 (maskhead_fwd.cu)
// and K6 (maskhead_bwd.cu): acc = h[b, t0:t0+K3_TT, :] . W[:, tile] on the
// tensor cores, and the packed layout of W it reads.
//
// W's rows of F*E = 6450 bf16 are not 16-byte aligned (reading them in
// place, 4 bytes at a time, cost K3 ~20%: PERF.md), so maskhead_fwd.cu's
// pack kernel lays W out once per weight version as tiles
// (ntiles, Dp, K3_NC) bf16, each tile ft whole E-groups (ft*E <= K3_NC
// columns, so no E-contraction crosses blocks), zero past each tile's
// columns and past D (Dp rounds D up to K3_KT): every W staging load is an
// aligned 16-byte vector. h is read in its own (B, T, D) layout, 8 bf16 at
// a time, zero-filled past D. The product runs through WMMA (mma.sync)
// 16x16x16 bf16 tiles with f32 accumulation: each of 8 warps owns one
// 16-row strip and 8 column tiles of the 64 x 256 block result, so it loads
// each A fragment once per k-slice. The next k-slice of h and W is fetched
// into registers while the tensor cores work on the current one in shared
// memory.
#pragma once

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
// shared memory of project_tile: the staging buffers, then the f32 result
// in the same bytes
constexpr size_t K3_STAGING_BYTES =
    (size_t)(K3_TT * K3_AS + K3_KT * K3_BS) * sizeof(bf16);
constexpr size_t K3_RESULT_BYTES = (size_t)K3_TT * K3_CS * sizeof(float);
constexpr size_t K3_TILE_BYTES = K3_STAGING_BYTES > K3_RESULT_BYTES
                                     ? K3_STAGING_BYTES
                                     : K3_RESULT_BYTES;

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

// The widest staging access of h (8, 2 or 1 bf16) that keeps every row
// of D elements aligned.
int vec_width(const void* p, int D) {
  const auto a = reinterpret_cast<uintptr_t>(p);
  if (D % 8 == 0 && a % 16 == 0) return 8;
  if (D % 2 == 0 && a % 4 == 0) return 2;
  return 1;
}

// acc[r, c] = h[b, t0 + r, :] . wt[:, c] for r < K3_TT, c < K3_NC (rows past
// T read as zero) into the f32 result at smem (row stride K3_CS), which
// aliases the staging buffers. wt is this block's tile of the packed W
// (Dp, K3_NC). The caller synchronises before reading the result.
__device__ __forceinline__ void project_tile(
    const bf16* __restrict__ h, const bf16* __restrict__ wt,
    unsigned char* smem, int b, int t0, int T, int D, int h_vec) {
  bf16* as = reinterpret_cast<bf16*>(smem);              // (TT, AS)
  bf16* bs = as + K3_TT * K3_AS;                         // (KT, BS)
  float* cs = reinterpret_cast<float*>(smem);            // (TT, CS), later
  const int warp = threadIdx.x / 32;
  const int strip = warp / 2, half = warp % 2;

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
}

}  // namespace
