// What the recurrent backward passes, K5 (gru_bwd.cu) and K8 (lstm_bwd.cu),
// share. They replace `_gru_bwd_kernel` and `_lstm_bwd_kernel` of
// dl4ss_tpu/ops/pallas_rnn.py, whose grid is sequential over time and so
// recomputes the gates, carries the gradient and sums dU inside one loop.
//
// Bound on the H100: the function's arithmetic is three products of the
// same size (the gate recompute hprev . U, the carry da . U^T and dU =
// hprev^T . da), 16-22 GFLOP a layer at H=300, B=16, T=313: 0.24-0.32 ms at
// the f32 CUDA-core rate. What sets the time is the chain of T dependent
// carry products. Only that product depends on the step before; the
// recompute and dU read saved values only. Both recurrences are linear in
// the carried gradient, so the backward splits into three phases:
//
//   A  `rnn_bwd_coef_kernel`, off the chain, all steps at once: the gate
//      recompute as one tiled (T*B) x H x G product per direction
//      (rnn_resident.cuh's `tile_product`), whose epilogue turns the gates into
//      the cell's NC coefficients per (t, d, b, unit): the factors by which
//      the step multiplies dh (and dc). Coefficients, not gates: the chain
//      is then ~10 FMAs per unit and reads neither xp, hprev nor cs. They
//      are f32, (T, D, B, H, NC): 60 MB (GRU) / 72 MB (LSTM) of scratch at
//      the path's shape, allocated by the caller per call.
//   B  `rnn_bwd_chain_kernel`, the chain: ONE cooperative launch per layer
//      runs all T steps of both directions. A block owns RES_UNITS hidden
//      units j of one direction for one tile of RES_BT batch rows and holds
//      its columns of U^T (= rows j of U, no transpose needed) in registers
//      for all steps (rnn_resident.cuh, the cell's ResidentTiling: 16 warps,
//      45-57 floats a thread).
//      A step: wait for the group's barrier, stage da_{t+1} of the group's
//      rows from L2 in shared memory, the resident product, the cell's
//      coefficient math for the owned (row, unit), store dxp_t and da_t,
//      arrive. The coefficients and dhs of step t are loaded before the
//      wait, so their latency hides behind the barrier. Blocks that share
//      (direction, row tile) form a barrier group; at B=16, H=300 that is
//      8 groups of 13 blocks, 104 of the 132 SMs. The elementwise carry
//      (dh*z, dc) and the GRU's db_n sum stay in the owner thread's
//      registers across the steps. The barrier is a ticket in device
//      memory (rnn_resident.cuh). A thread block cluster per group, with
//      the hardware's barrier, was built and measured on an NVIDIA H100
//      80GB HBM3: eight clusters of 13 blocks do not all fit the card at
//      once, so they ran in two waves and the layer took 1.4x as long.
//   C  `weight_grad`, after the loop: dU with the (t, b) axis split
//      DU_SPLIT ways over the grid (the same `tile_product`), then a
//      fixed-order sum of the partials. Deterministic: no atomics on data.
//
// A batch whose chain grid does not fit the card at once runs the chain in
// chunks of rows, one launch each (rnn_resident.cuh's `chunked`); phases A
// and C take the whole batch. The stepwise body (one kernel launch per
// step, gru_bwd.cu / lstm_bwd.cu) stays for a width whose slice does not fit
// the registers (G > the tiling's COLS, H > 304) and for batches past the
// chunks where the resident body was measured faster.
// ops/rnn_kernels.py::rnn_body is the only rule; the entry points here are
// told the body and refuse the resident one where it cannot run (the chain
// launch checks the width, the tickets and the grid; the coefficient
// product before it takes any shape). `transpose` serves the stepwise body
// alone.
#pragma once

#include "rnn_resident.cuh"

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

// row of (t, d, b) in a (T, D, B, *) array, for n = t * B + b
__device__ __forceinline__ size_t tdb_row(int n, int d, int D, int B) {
  return ((size_t)(n / B) * D + d) * B + n % B;
}

// ---- phase A: the coefficients of every step ------------------------------

// A cell (GruCell, LstmCell) names NG gates, NC coefficients, KS column
// warps that share a unit's columns, MAXI register columns per unit and
// thread, and two device functions:
//   coefficients(a, x, e0, e1, row, d, j, H, hp, out): a[NG] = hprev . U at
//     unit j of `row`, x = xp + row * G, hp = hprev there -> out[NC];
//   step(c, dot, dhs, state, dx, dw): the linear step for one (row, unit).
struct CoefArgs {
  const void* xp;      // (T, D, B, G)
  const void* wh;      // (D, H, G)
  const void* hprev;   // (T, D, B, H)
  const void* e0;      // the cell's own saved inputs
  const void* e1;
  float* coef;         // (T, D, B, H, NC)
  int steps, D, B, H;
};

template <typename T, typename Cell>
__global__ void __launch_bounds__(TILE_THREADS, 2) rnn_bwd_coef_kernel(
    CoefArgs p) {
  constexpr int NG = Cell::NG, NC = Cell::NC;
  __shared__ __align__(16) float as[TILE_K][TILE_LD];
  __shared__ float bs[TILE_K][NG * 32];
  __shared__ size_t rows[TILE_M];      // tdb_row of the tile's rows
  const int H = p.H, G = NG * H, N = p.steps * p.B;
  const int n0 = blockIdx.x * TILE_M, j0 = blockIdx.y * 32, d = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const T* hprev = static_cast<const T*>(p.hprev);
  const T* U = static_cast<const T*>(p.wh) + (size_t)d * H * G;
  if (threadIdx.x < TILE_M)
    rows[threadIdx.x] =
        tdb_row(min(n0 + (int)threadIdx.x, N - 1), d, p.D, p.B);
  float acc[8][NG];
  tile_product<NG, true>(
      (H + TILE_K - 1) / TILE_K,
      [&](int s, int kk, int m) {
        const int k = s * TILE_K + kk;
        return n0 + m < N && k < H ? to_f32(hprev[rows[m] * H + k]) : 0.0f;
      },
      [&](int s, int kk, int c) {
        const int k = s * TILE_K + kk, j = j0 + c % 32;
        return k < H && j < H ? to_f32(U[(size_t)k * G + (c / 32) * H + j])
                              : 0.0f;
      },
      [](int) {}, as, bs, acc);
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + ty * 8 + i;
    if (n >= N) break;
    const size_t row = rows[ty * 8 + i];
    float out[NC];
    Cell::coefficients(acc[i], static_cast<const T*>(p.xp) + row * G, p.e0,
                       p.e1, row, d, j, H, to_f32(hprev[row * H + j]), out);
    float* dst = p.coef + (row * H + j) * NC;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[c] = out[c];
  }
}

template <typename T, typename Cell>
inline cudaError_t coefficients(const CoefArgs& p, cudaStream_t stream) {
  const dim3 grid((p.steps * p.B + TILE_M - 1) / TILE_M, (p.H + 31) / 32,
                  p.D);
  rnn_bwd_coef_kernel<T, Cell><<<grid, TILE_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---- phase B: the chain ---------------------------------------------------

struct ChainArgs {
  const void* wh;      // (D, H, G)
  const float* coef;   // (T, D, B, H, NC)
  const void* dhs;     // (T, D, B, H)
  void* dx;            // (T, D, B, G): dxp
  void* dw;            // (T, D, B, G): what the carry and dU read (GRU: da_w;
                       // LSTM: dxp itself)
  float* sums;         // (B, D, H): the cell's per-(row, unit) sum over t
                       // (GRU: dhn, for db_n); null where the cell has none
  unsigned int* tickets;   // one per group of the launch, zero at launch
  int steps, D, B, H;
  int row0, rows;      // the launch's batch rows: row0 .. row0 + rows - 1
  int members;         // blocks per group
};

template <typename T, typename Cell>
__global__ void __launch_bounds__(Cell::Tiling::THREADS, 1)
    rnn_bwd_chain_kernel(ChainArgs p) {
  using Ti = typename Cell::Tiling;
  constexpr int NG = Cell::NG, NC = Cell::NC, KS = Ti::KS, UW = Ti::UW;
  constexpr int UWARPS = Ti::UWARPS, WARP_UNITS = UW * 32 / RES_LANES;
  constexpr int THREADS = Ti::THREADS, OWNED = RES_UNITS * RES_BT;
  static_assert(Ti::OUTS == 1, "one output a unit: its row of U");
  static_assert(OWNED <= THREADS, "one owner thread per (row, unit)");
  extern __shared__ float4 vec[];     // (G): da_{t+1}, the 4 rows per column
  const int H = p.H, G = NG * H, B = p.B, D = p.D;
  // (KS, RES_UNITS, RES_BT): the column warps' sums
  float* part = reinterpret_cast<float*>(vec + G);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ks = warp / UWARPS;
  const int q = lane / RES_LANES, c = lane % RES_LANES;
  // the first of this lane group's units, within the block
  const int lu = (warp % UWARPS) * WARP_UNITS + q * UW;
  const int group = blockIdx.x / p.members, member = blockIdx.x % p.members;
  // a launch's rows are whole tiles but for the batch's last one, so B
  // bounds the rows of every tile
  const int tiles = (p.rows + RES_BT - 1) / RES_BT;
  const int d = group / tiles, b0 = p.row0 + (group % tiles) * RES_BT;
  const int j0 = member * RES_UNITS;        // the block's first unit
  unsigned int* ticket = p.tickets + group;

  float w[UW][Ti::MAXI];
  {
    const T* rows = static_cast<const T*>(p.wh) +
                    ((size_t)d * H + min(j0 + lu, H - 1)) * G;
    const int valid = max(0, min(UW, H - j0 - lu));
    resident_load<UW, Ti::MAXI, KS>(
        w, [&](int u, int g) {
          return u < valid ? to_f32(rows[(size_t)u * G + g]) : 0.0f;
        }, G, c, ks);
  }

  // threads 0 .. OWNED - 1 each own one (row, unit) of the block's, units
  // running fastest: their loads and stores are contiguous over the units
  const int ou = threadIdx.x % RES_UNITS, ob = threadIdx.x / RES_UNITS;
  const int j = j0 + ou, b = b0 + ob;
  const bool owner = threadIdx.x < OWNED && j < H && b < B;
  typename Cell::State state = {};
  const T* dhs = static_cast<const T*>(p.dhs);
  T* dx = static_cast<T*>(p.dx);
  T* dw = static_cast<T*>(p.dw);
  const size_t step_rows = (size_t)D * B;

  for (int t = p.steps - 1; t >= 0; --t) {
    const size_t row = (size_t)t * step_rows + (size_t)d * B + b;
    float cf[NC], g_out = 0.0f;
    if (owner) {        // independent of the chain: in flight over the wait
      const float* src = p.coef + (row * H + j) * NC;
#pragma unroll
      for (int i = 0; i < NC; ++i) cf[i] = __ldg(src + i);
      g_out = to_f32(dhs[row * H + j]);
    }
    float dot = 0.0f;
    if (t + 1 < p.steps) {
      group_wait(ticket, (unsigned int)p.members * (p.steps - 1 - t));
      // stage the group's rows of da_{t+1}, eight L2 loads in flight per
      // thread before the first is used
      const T* next =
          dw + ((size_t)(t + 1) * step_rows + (size_t)d * B + b0) * G;
      for (int g = threadIdx.x; g < G; g += 2 * THREADS) {
        float v[2][RES_BT];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < RES_BT; ++r)
            v[h][r] = g + h * THREADS < G && b0 + r < B
                          ? load_shared_result(next + (size_t)r * G + g +
                                               h * THREADS)
                          : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (g + h * THREADS < G)
            vec[g + h * THREADS] =
                make_float4(v[h][0], v[h][1], v[h][2], v[h][3]);
      }
      __syncthreads();
      float acc[UW][RES_BT];
      resident_dot<UW, Ti::MAXI, KS>(w, vec, G, c, ks, acc);
      // the eight lanes of a group hold the same UW * RES_BT sums: lane
      // c stores sums c and c + 8
#pragma unroll
      for (int u = 0; u < UW; ++u)
#pragma unroll
        for (int r = 0; r < RES_BT; ++r)
          if ((u * RES_BT + r) % RES_LANES == c)
            part[(ks * RES_UNITS + lu + u) * RES_BT + r] = acc[u][r];
      __syncthreads();
      if (owner) {        // the column warps' sums, in order
#pragma unroll
        for (int k = 0; k < KS; ++k)
          dot += part[(k * RES_UNITS + ou) * RES_BT + ob];
      }
    }
    if (owner) {
      float vx[NG], vw[NG];
      Cell::step(cf, dot, g_out, state, vx, vw);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        store(dx + row * G + g * H + j, vx[g]);
        if (Cell::SPLIT) store(dw + row * G + g * H + j, vw[g]);
      }
    }
    if (t > 0) group_arrive(ticket);
  }
  if (owner && p.sums != nullptr)
    p.sums[((size_t)b * D + d) * H + j] = Cell::total(state);
}

// The chain of the whole batch: one cooperative launch per chunk of
// `chunk` rows (rnn_resident.cuh's `chunked`), each of D * tiles groups of
// `members` blocks, all of which must be resident at once for the ticket
// barrier, or the launch is refused (cudaErrorCooperativeLaunchTooLarge
// comes back to the caller). A width past the slice is refused first.
template <typename T, typename Cell>
inline cudaError_t chain(ChainArgs p, int groups, int chunk,
                         cudaStream_t stream) {
  using Ti = typename Cell::Tiling;
  if (Cell::NG * p.H > Ti::COLS) return cudaErrorInvalidValue;
  p.members = (p.H + RES_UNITS - 1) / RES_UNITS;
  const size_t smem = ((size_t)RES_BT * Cell::NG * p.H +
                       Ti::KS * RES_UNITS * RES_BT) * sizeof(float);
  return chunked(p.D, p.B, chunk, groups, p.tickets,
                 [&](int row0, int rows, unsigned int* tickets) {
                   ChainArgs q = p;
                   q.row0 = row0;
                   q.rows = rows;
                   q.tickets = tickets;
                   void* args[] = {&q};
                   const int tiles = (rows + RES_BT - 1) / RES_BT;
                   return reported(cudaLaunchCooperativeKernel(
                       reinterpret_cast<void*>(
                           rnn_bwd_chain_kernel<T, Cell>),
                       dim3(p.D * tiles * p.members), dim3(Ti::THREADS),
                       args, smem, stream));
                 });
}

// ---- phase C: the weight gradient -----------------------------------------

// dU[d, k, g] = sum over n = (t, b) of hprev[t, d, b, k] * da[t, d, b, g] in
// f32. Block (x, y, z) takes a 64 x (NG * 32) output tile of direction
// z / DU_SPLIT over slice z % DU_SPLIT of the n axis, walked 16 at a time in
// a fixed order, and writes its partial; sum_partials_kernel adds the
// DU_SPLIT partials in order.
constexpr int DU_SPLIT = 16;

template <typename T, int NG>
__global__ void __launch_bounds__(TILE_THREADS, 2) du_partial_kernel(
    const T* __restrict__ hprev,   // (T, D, B, H)
    const T* __restrict__ da,      // (T, D, B, G)
    float* __restrict__ part,      // (DU_SPLIT, D, H, G)
    int steps, int D, int B, int H, int G) {
  __shared__ __align__(16) float as[TILE_K][TILE_LD];
  __shared__ float bs[TILE_K][NG * 32];
  const int g0 = blockIdx.x * NG * 32, k0 = blockIdx.y * TILE_M;
  const int d = blockIdx.z / DU_SPLIT, s = blockIdx.z % DU_SPLIT;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int n_total = steps * B;
  const int chunk = (n_total + DU_SPLIT - 1) / DU_SPLIT;
  const int n_lo = s * chunk, n_hi = min(n_total, n_lo + chunk);
  __shared__ size_t rows[2][TILE_K];   // tdb_row of a slice, by its parity
  float acc[8][NG];
  tile_product<NG, false>(
      (n_hi - n_lo + TILE_K - 1) / TILE_K,
      [&](int sl, int nn, int m) {
        return n_lo + sl * TILE_K + nn < n_hi && k0 + m < H
                   ? to_f32(hprev[rows[sl & 1][nn] * H + k0 + m])
                   : 0.0f;
      },
      [&](int sl, int nn, int c) {
        return n_lo + sl * TILE_K + nn < n_hi && g0 + c < G
                   ? to_f32(da[rows[sl & 1][nn] * G + g0 + c])
                   : 0.0f;
      },
      [&](int sl) {
        if (threadIdx.x < TILE_K)
          rows[sl & 1][threadIdx.x] = tdb_row(
              min(n_lo + sl * TILE_K + (int)threadIdx.x, n_hi - 1), d, D, B);
      },
      as, bs, acc);
  float* out = part + ((size_t)s * D + d) * H * G;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int k = k0 + ty * 8 + i, col = g0 + g * 32 + tx;
      if (k < H && col < G) out[(size_t)k * G + col] = acc[i][g];
    }
}

// out[i] = part[0][i] + part[1][i] + ... over `parts` slabs of n values.
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int parts,
                                    size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float total = 0.0f;
  for (int s = 0; s < parts; ++s) total += part[(size_t)s * n + i];
  out[i] = total;
}

inline cudaError_t sum_partials(const float* part, float* out, int parts,
                                size_t n, cudaStream_t stream) {
  sum_partials_kernel<<<(unsigned int)((n + 255) / 256), 256, 0, stream>>>(
      part, out, parts, n);
  return cudaGetLastError();
}

// part: (parts, D, H, G) f32 scratch from the caller, who says how many
// slabs it allocated: any count but DU_SPLIT is refused.
template <typename T, int NG>
inline cudaError_t weight_grad(const T* hprev, const T* da, float* du,
                               float* part, int parts, int steps, int D, int B,
                               int H, int G, cudaStream_t stream) {
  if (parts != DU_SPLIT) return cudaErrorInvalidValue;
  const dim3 grid((G + NG * 32 - 1) / (NG * 32), (H + TILE_M - 1) / TILE_M,
                  D * DU_SPLIT);
  du_partial_kernel<T, NG><<<grid, TILE_THREADS, 0, stream>>>(
      hprev, da, part, steps, D, B, H, G);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, du, DU_SPLIT, (size_t)D * H * G, stream);
}

}  // namespace dl4ss
