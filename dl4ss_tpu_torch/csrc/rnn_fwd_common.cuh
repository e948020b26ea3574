// What the recurrent forward passes, K2 (gru_fwd.cu) and K7 (lstm_fwd.cu),
// share: their resident body, one persistent cooperative launch that walks
// all T steps of both directions. They replace `_gru_fwd_kernel` and
// `_lstm_fwd_kernel` of dl4ss_tpu/ops/pallas_rnn.py, whose grid is
// sequential over time and keeps h (and c) in VMEM scratch.
//
// Bound on the H100: a layer's arithmetic is the T dependent products h . U
// (5.4 GFLOP for the GRU, 7.2 for the LSTM at H=300, B=16, T=313: 0.08 and
// 0.11 ms at the f32 CUDA-core rate). What sets the time is the chain: each
// step needs the whole h of the step before. A launch per step pays a launch
// and a pass over U from L2 every step; here one launch keeps U on the SMs.
//
// A block owns RES_UNITS hidden units j of one direction for one tile of
// RES_BT batch rows and holds their NG gate columns U[:, g * H + j] in
// registers for all steps (rnn_resident.cuh, the cell's ResidentTiling: a
// lane group holds 3 of the block's 24 * NG gate columns, 6 (GRU) or 8
// (LSTM) unit warps x 2 column warps split the H rows of U, 19 a lane: 57
// floats a thread).
// A step t:
//   1. the owner thread of each (row, unit) loads xp[t] there, before the
//      wait, so that its latency hides behind the barrier;
//   2. wait for the group's ticket (the other members' h_{t-1});
//   3. stage the group's rows of h_{t-1} from L2 as one float4 per column;
//   4. the resident product, NG sums per (unit, row) and lane group;
//   5. the column warps' sums added in a fixed order by the owner;
//   6. the cell's gate math in the owner thread;
//   7. store h_t (and c_t);
//   8. arrive.
// At t = 0, h0 = 0: no wait and no product. Blocks that share (direction,
// row tile) form a barrier group: at B=16, H=300 8 groups of 13 blocks, 104
// of the 132 SMs. The LSTM's c and the GRU's b_n stay in the owner thread's
// registers across the steps. The numerics are the JAX kernel's: f32 inputs
// compute in f32; bf16 inputs keep the h carry in bf16 (the staged vector is
// the rounded h_{t-1}, which the GRU's z * h term also uses), accumulate in
// f32, and carry the LSTM's c in f32 (only the stored cs is rounded). Sums
// run in one fixed order with no atomics on data: two calls agree bit for
// bit.
//
// A batch whose grid does not fit the card at once runs in chunks of rows,
// one launch each (rnn_resident.cuh's `chunked`); ops/rnn_kernels.py sizes
// them from the card's SM count. The stepwise body (one launch per step, in
// gru_fwd.cu / lstm_fwd.cu) stays for the widths the registers cannot hold.
#pragma once

#include "rnn_resident.cuh"

namespace dl4ss {

// A forward cell (GruFwdCell, LstmFwdCell) names NG gates, whether it emits
// its cell state (CELL_OUT), its Tiling, a per-(row, unit) State and
//   init(bias, d, j, H) -> State: before the first step;
//   step(x, a, hp, state, c_out) -> h: x = xp[t] and a = h_{t-1} . U at the
//     NG gates of the unit, hp = h_{t-1} there.
struct FwdArgs {
  const void* xp;        // (T, D, B, G)
  const void* wh;        // (D, H, G)
  const float* bias;     // (D, H): the cell's per-unit constant (GRU: b_n)
  void* hs;              // (T, D, B, H)
  void* cs;              // (T, D, B, H): the cell state (LSTM); else null
  unsigned int* tickets; // one per group of the launch, zero at launch
  int steps, D, B, H;
  int row0, rows;        // the launch's batch rows: row0 .. row0 + rows - 1
  int members;           // blocks per group
};

template <typename T, typename Cell>
__global__ void __launch_bounds__(Cell::Tiling::THREADS, 1)
    rnn_fwd_chain_kernel(FwdArgs p) {
  using Ti = typename Cell::Tiling;
  constexpr int NG = Cell::NG, KS = Ti::KS, MAXI = Ti::MAXI, UW = Ti::UW;
  constexpr int THREADS = Ti::THREADS, OWNED = RES_UNITS * RES_BT;
  static_assert(Ti::OUTS == NG, "a unit's outputs are its NG gate columns");
  static_assert(OWNED <= THREADS, "one owner thread per (row, unit)");
  __shared__ float4 vec[Ti::COLS];     // h_{t-1}, the 4 rows per column
  // the column warps' sums of the block's outputs (unit * NG + gate)
  __shared__ float part[KS][Ti::OUTPUTS][RES_BT];
  const int H = p.H, G = NG * H, B = p.B, D = p.D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ks = Ti::column_warp(warp), c = lane % RES_LANES;
  const int lo = Ti::lane_output(warp, lane);   // its first output
  const int group = blockIdx.x / p.members, member = blockIdx.x % p.members;
  const int tiles = (p.rows + RES_BT - 1) / RES_BT;
  // a launch's rows are whole tiles but for the batch's last one, so B
  // bounds the rows of every tile
  const int d = group / tiles, b0 = p.row0 + (group % tiles) * RES_BT;
  const int j0 = member * RES_UNITS;        // the block's first unit
  unsigned int* ticket = p.tickets + group;

  float w[UW][MAXI];
  {
    const T* U = static_cast<const T*>(p.wh) + (size_t)d * H * G;
    resident_load<UW, MAXI, KS>(
        w, [&](int u, int k) {
          const int j = j0 + (lo + u) / NG, g = (lo + u) % NG;
          return j < H ? to_f32(U[(size_t)k * G + g * H + j]) : 0.0f;
        }, H, c, ks);
  }

  // threads 0 .. OWNED - 1 each own one (row, unit) of the block's, units
  // running fastest: their loads and stores are contiguous over the units
  const int ou = threadIdx.x % RES_UNITS, ob = threadIdx.x / RES_UNITS;
  const int j = j0 + ou, b = b0 + ob;
  const bool owner = threadIdx.x < OWNED && j < H && b < B;
  typename Cell::State state = {};
  if (owner) state = Cell::init(p.bias, d, j, H);
  const T* xp = static_cast<const T*>(p.xp);
  T* hs = static_cast<T*>(p.hs);
  T* cs = static_cast<T*>(p.cs);
  const size_t step_rows = (size_t)D * B;

  for (int t = 0; t < p.steps; ++t) {
    const size_t row = (size_t)t * step_rows + (size_t)d * B + b;
    float x[NG];
    if (owner) {        // independent of the chain: in flight over the wait
#pragma unroll
      for (int g = 0; g < NG; ++g) x[g] = to_f32(xp[row * G + g * H + j]);
    }
    float a[NG] = {}, hp = 0.0f;
    if (t > 0) {
      group_wait(ticket, (unsigned int)p.members * t);
      stage_rows<THREADS>(
          vec, hs + ((size_t)(t - 1) * step_rows + (size_t)d * B + b0) * H,
          H, H, b0, B);
      float acc[UW][RES_BT];
      resident_dot<UW, MAXI, KS>(w, vec, H, c, ks, acc);
      // the eight lanes of a group hold the same UW * RES_BT sums: lane c
      // stores sums c and c + 8
#pragma unroll
      for (int u = 0; u < UW; ++u)
#pragma unroll
        for (int r = 0; r < RES_BT; ++r)
          if ((u * RES_BT + r) % RES_LANES == c)
            part[ks][lo + u][r] = acc[u][r];
      __syncthreads();
      if (owner) {        // the column warps' sums, in order
#pragma unroll
        for (int k = 0; k < KS; ++k)
#pragma unroll
          for (int g = 0; g < NG; ++g) a[g] += part[k][ou * NG + g][ob];
        hp = reinterpret_cast<const float*>(vec + j)[ob];
      }
    }
    if (owner) {
      float c_out;
      const float h = Cell::step(x, a, hp, state, c_out);
      store(hs + row * H + j, h);
      if (Cell::CELL_OUT) store(cs + row * H + j, c_out);
    }
    if (t + 1 < p.steps) group_arrive(ticket);
  }
}

// The whole batch: one cooperative launch per chunk of `chunk` rows, each of
// D * tiles groups of `members` blocks that must all be resident at once, or
// the launch is refused (cudaErrorCooperativeLaunchTooLarge comes back to
// the caller). A width past the slice is refused first.
template <typename T, typename Cell>
inline cudaError_t fwd_chain(FwdArgs p, int groups, int chunk,
                             cudaStream_t stream) {
  using Ti = typename Cell::Tiling;
  if (p.H > Ti::COLS) return cudaErrorInvalidValue;
  p.members = (p.H + RES_UNITS - 1) / RES_UNITS;
  return chunked(p.D, p.B, chunk, groups, p.tickets,
                 [&](int row0, int rows, unsigned int* tickets) {
                   FwdArgs q = p;
                   q.row0 = row0;
                   q.rows = rows;
                   q.tickets = tickets;
                   void* args[] = {&q};
                   const int tiles = (rows + RES_BT - 1) / RES_BT;
                   return reported(cudaLaunchCooperativeKernel(
                       reinterpret_cast<void*>(
                           rnn_fwd_chain_kernel<T, Cell>),
                       dim3(p.D * tiles * p.members), dim3(Ti::THREADS),
                       args, 0, stream));
                 });
}

}  // namespace dl4ss
