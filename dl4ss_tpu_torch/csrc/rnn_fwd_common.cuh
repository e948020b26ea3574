// What the recurrent forward passes, K2 (gru_fwd.cu) and K7 (lstm_fwd.cu),
// share: their resident chain, one persistent launch that walks all T steps
// of both directions, with two ways to pass h from block to block (the
// ticket body and the cluster body below). They replace `_gru_fwd_kernel`
// and `_lstm_fwd_kernel` of dl4ss_tpu/ops/pallas_rnn.py, whose grid is
// sequential over time and keeps h (and c) in VMEM scratch.
//
// Bound on the H100: a layer's arithmetic is the T dependent products h . U
// (5.4 GFLOP for the GRU, 7.2 for the LSTM at H=300, B=16, T=313: 0.08 and
// 0.11 ms at the f32 CUDA-core rate). What sets the time is the chain: each
// step needs the whole h of the step before. A launch per step pays a launch
// and a pass over U from L2 every step; here one launch keeps U on the SMs.
//
// A block owns Ti::UNITS hidden units j of one direction for one tile of
// RES_BT batch rows and holds their NG gate columns U[:, g * H + j] in
// registers for all steps (rnn_resident.cuh's ResidentTiling: a lane group
// holds UW of the block's UNITS * NG gate columns, unit warps x 2 column
// warps split the H rows of U, 19 a lane). Blocks that share (direction, row
// tile) form a barrier group. A step t:
//   1. the owner thread of each (row, unit) loads xp[t] there, before the
//      wait, so that its latency hides behind it;
//   2. wait for the group's h_{t-1}, staged as one float4 of the 4 rows per
//      column;
//   3. the resident product, NG sums per (unit, row) and lane group;
//   4. the column warps' sums added in a fixed order by the owner;
//   5. the cell's gate math in the owner thread;
//   6. store h_t (and c_t);
//   7. pass h_t on to the group.
// At t = 0, h0 = 0: no wait and no product. The two bodies differ in 2 and 7
// alone:
//   * ticket (`resident`): the owners' stores of h_t are the message. A
//     ticket per group in device memory (`group_arrive`), waited on with an
//     acquire load (`group_wait`), then the group's rows of h_{t-1} staged
//     from L2 (`stage_rows`). The grid is one cooperative launch per chunk
//     of rows, all resident at once: at B=16, H=300 8 groups of 13 blocks
//     (RES_UNITS = 24 units a block), 104 of the 132 SMs.
//   * cluster: each group is one thread-block cluster. The owners write h_t
//     into the block's `sent` vector; the block pushes it into a step-parity
//     buffer of every member's shared memory with `st.async`, counted on the
//     member's `Inbox`; step t + 1 waits on its own inbox and reads h_t from
//     its own shared memory. No L2 round trip is left on the chain. Only a
//     cluster must be resident, which the hardware guarantees, so groups
//     need not fit the card at once to be right, only to be fast; the
//     cluster's width comes from the tiling the caller names, by units a
//     block: 19 (16 blocks a cluster at H=300; an H100 holds 7 such
//     clusters at once) or 36 (9 blocks; it holds 9, so B=16's 8 groups
//     fit, where 8 clusters of 13 blocks of 24 units would not).
// Both bodies keep the column split (KS, the 8-lane butterfly, the in-order
// sum over the column warps) whatever the units a block, so each output is
// summed in one order and the two bodies agree bit for bit. The LSTM's c and
// the GRU's b_n stay in the owner thread's registers across the steps. The
// numerics are the JAX kernel's: f32 inputs compute in f32; bf16 inputs
// keep the h carry in bf16 (the staged vector is the rounded h_{t-1}, which
// the GRU's z * h term also uses), accumulate in f32, and carry the LSTM's c
// in f32 (only the stored cs is rounded). Sums run in one fixed order with
// no atomics on data: two calls agree bit for bit.
//
// A batch whose ticket grid does not fit the card at once runs in chunks of
// rows, one launch each (rnn_resident.cuh's `chunked`); ops/rnn_kernels.py
// sizes them from the card's SM count, and names the cluster body only
// where the card's occupancy query says every cluster of the launch is
// resident at once, and both bodies only up to B=40. Past it the time of
// these bodies grows with every 4 rows, since each barrier group holds its
// own copy of U and reads h once per FMA. There the tiled body
// (rnn_fwd_tiled.cuh) takes over, where the stepwise body (one launch per
// step, in gru_fwd.cu / lstm_fwd.cu) ran before (K7 from B=52, where it
// was measured faster): at B=256, H=300 a GRU
// layer is 86.5 GFLOP of h . U, 1.29 ms at the f32 FFMA rate, a step 2.2
// MFLOP an SM, so the step is bound by arithmetic, not by the chain. It
// holds each block's U once in shared memory for a group of 32 rows and
// multiplies with register tiles of 4 rows x 5 units x NG gates a lane: a
// U value serves 4 rows, an h value 5 * NG columns. The stepwise body
// stays for the widths past every persistent body.
#pragma once

#include <atomic>

#include "rnn_resident.cuh"

namespace dl4ss {

// The cluster body's code, beside BODY_RESIDENT and BODY_STEPWISE
// (rnn_resident.cuh) and K7's BODY_WIDE (rnn_fwd_wide.cuh).
constexpr int BODY_CLUSTER = 4;

// A forward cell (GruFwdCell, LstmFwdCell) names NG gates, whether it emits
// its cell state (CELL_OUT), its Tiling (the ticket body's, RES_UNITS units
// a block), its ClusterTiling19 and ClusterTiling36 (the cluster body's, 19
// and 36 units a block), a per-(row, unit) State and
//   init(bias, d, j, H) -> State: before the first step;
//   step(x, a, hp, state, c_out) -> h: x = xp[t] and a = h_{t-1} . U at the
//     NG gates of the unit, hp = h_{t-1} there.
struct FwdArgs {
  const void* xp;        // (T, D, B, G)
  const void* wh;        // (D, H, G)
  const float* bias;     // (D, H): the cell's per-unit constant (GRU: b_n)
  void* hs;              // (T, D, B, H)
  void* cs;              // (T, D, B, H): the cell state (LSTM); else null
  unsigned int* tickets; // ticket body: one per group, zero at launch
  int steps, D, B, H;
  int row0, rows;        // the launch's batch rows: row0 .. row0 + rows - 1
  int members;           // blocks per group
};

// h as the next step reads it: rounded to the carry's dtype.
__device__ __forceinline__ float carried(float h, const float*) { return h; }
__device__ __forceinline__ float carried(float h, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(h));
}

template <typename T, typename Cell, typename Ti, bool CLUSTER>
__global__ void __launch_bounds__(Ti::THREADS, 1)
    rnn_fwd_chain_kernel(FwdArgs p) {
  constexpr int NG = Cell::NG, KS = Ti::KS, MAXI = Ti::MAXI, UW = Ti::UW;
  constexpr int THREADS = Ti::THREADS, UNITS = Ti::UNITS;
  constexpr int OWNED = UNITS * RES_BT;
  static_assert(Ti::OUTS == NG, "a unit's outputs are its NG gate columns");
  static_assert(OWNED <= THREADS, "one owner thread per (row, unit)");
  // h_{t-1}, the 4 rows per column; the cluster body's h_t lands in the
  // buffer of t's parity while step t reads the other
  __shared__ float4 vec[CLUSTER ? 2 : 1][Ti::COLS];
  // the column warps' sums of the block's outputs (unit * NG + gate)
  __shared__ float part[KS][Ti::SLOTS][RES_BT];
  // the cluster body: the block's h_t before it is sent (rows past B stay
  // 0), and the arrival of each parity's buffer
  __shared__ float4 sent[CLUSTER ? UNITS : 1];
  __shared__ Inbox inbox[2];
  const int H = p.H, G = NG * H, B = p.B, D = p.D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ks = Ti::column_warp(warp), c = lane % RES_LANES;
  const int lo = Ti::lane_output(warp, lane);   // its first output
  const int group = blockIdx.x / p.members, member = blockIdx.x % p.members;
  const int tiles = (p.rows + RES_BT - 1) / RES_BT;
  // a launch's rows are whole tiles but for the batch's last one, so B
  // bounds the rows of every tile
  const int d = group / tiles, b0 = p.row0 + (group % tiles) * RES_BT;
  const int j0 = member * UNITS;            // the block's first unit
  unsigned int* ticket = p.tickets + group;

  float w[UW][MAXI];
  {
    const T* U = static_cast<const T*>(p.wh) + (size_t)d * H * G;
    resident_load<UW, MAXI, KS>(
        w, [&](int u, int k) {
          const int j = j0 + (lo + u) / NG, g = (lo + u) % NG;
          if constexpr (Ti::SLOTS > Ti::OUTPUTS) {
            if (lo + u >= Ti::OUTPUTS) return 0.0f;     // a spare slot
          }
          return j < H ? to_f32(U[(size_t)k * G + g * H + j]) : 0.0f;
        }, H, c, ks);
  }

  // threads 0 .. OWNED - 1 each own one (row, unit) of the block's, units
  // running fastest: their loads and stores are contiguous over the units
  const int ou = threadIdx.x % UNITS, ob = threadIdx.x / UNITS;
  const int j = j0 + ou, b = b0 + ob;
  const bool owner = threadIdx.x < OWNED && j < H && b < B;
  typename Cell::State state = {};
  if (owner) state = Cell::init(p.bias, d, j, H);
  const T* xp = static_cast<const T*>(p.xp);
  T* hs = static_cast<T*>(p.hs);
  T* cs = static_cast<T*>(p.cs);
  const size_t step_rows = (size_t)D * B;
  // the cluster body: the units this block sends, the bytes a block expects
  const int mine = min(UNITS, H - j0);
  const unsigned int expect = (unsigned int)H * sizeof(float4);
  if constexpr (CLUSTER) {
    if (threadIdx.x < UNITS) sent[threadIdx.x] = make_float4(0, 0, 0, 0);
    if (threadIdx.x == 0) {
      inbox_init(&inbox[0]);
      inbox_init(&inbox[1]);
      inbox_init_fence();
      if (p.steps > 1) inbox_expect(&inbox[0], expect);     // h_0
    }
    cluster_sync();          // every member's inbox is set before a send
  }

  for (int t = 0; t < p.steps; ++t) {
    const size_t row = (size_t)t * step_rows + (size_t)d * B + b;
    float x[NG];
    if (owner) {        // independent of the chain: in flight over the wait
#pragma unroll
      for (int g = 0; g < NG; ++g) x[g] = to_f32(xp[row * G + g * H + j]);
    }
    float a[NG] = {}, hp = 0.0f;
    if (t > 0) {
      const float4* v = vec[(t - 1) % (CLUSTER ? 2 : 1)];
      if constexpr (CLUSTER) {
        inbox_wait(&inbox[(t - 1) & 1], ((t - 1) >> 1) & 1);
      } else {
        group_wait(ticket, (unsigned int)p.members * t);
        stage_rows<THREADS>(
            vec[0],
            hs + ((size_t)(t - 1) * step_rows + (size_t)d * B + b0) * H, H,
            H, b0, B);
      }
      float acc[UW][RES_BT];
      resident_dot<UW, MAXI, KS>(w, v, H, c, ks, acc);
      // the eight lanes of a group hold the same UW * RES_BT sums: lane c
      // stores sums c, c + 8, ...
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
        hp = reinterpret_cast<const float*>(v + j)[ob];
      }
    }
    if constexpr (CLUSTER) {
      float h = 0.0f;
      if (owner) {
        float c_out;
        h = Cell::step(x, a, hp, state, c_out);
        store(hs + row * H + j, h);
        if (Cell::CELL_OUT) store(cs + row * H + j, c_out);
      }
      if (t + 1 == p.steps) break;
      // the block's units of h_t into the buffer of t's parity of every
      // member, counted on their inbox of t's parity. h_{t+1} will land in
      // the other buffer, whose h_{t-1} this block has read by now: arm it
      if (owner) reinterpret_cast<float*>(sent + ou)[ob] = carried(h, hs);
      __syncthreads();
      if (threadIdx.x == 0 && t + 2 < p.steps)
        inbox_expect(&inbox[(t + 1) & 1], expect);
      for (int i = threadIdx.x; i < p.members * mine; i += THREADS)
        cluster_send(&vec[t & 1][j0 + i % mine], sent[i % mine],
                     &inbox[t & 1], i / mine);
    } else {
      if (owner) {
        float c_out;
        const float h = Cell::step(x, a, hp, state, c_out);
        store(hs + row * H + j, h);
        if (Cell::CELL_OUT) store(cs + row * H + j, c_out);
      }
      if (t + 1 < p.steps) group_arrive(ticket);
    }
  }
  // no member leaves while a send to or from it may be in flight
  if constexpr (CLUSTER) cluster_sync();
}

// The ticket body, the whole batch: one cooperative launch per chunk of
// `chunk` rows, each of D * tiles groups of `members` blocks that must all
// be resident at once, or the launch is refused
// (cudaErrorCooperativeLaunchTooLarge comes back to the caller). A width
// past the slice is refused first.
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
                           rnn_fwd_chain_kernel<T, Cell, Ti, false>),
                       dim3(p.D * tiles * p.members), dim3(Ti::THREADS),
                       args, 0, stream));
                 });
}

// The cluster body's launch of D * tiles clusters of ceil(H / Ti::UNITS)
// blocks (up to 16, past the portable 8), for a launch or for the occupancy
// query. False for a width past the slice.
template <typename Ti>
struct ClusterLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1] = {};
  bool valid;
  ClusterLaunch(int H, int groups, cudaStream_t stream)
      : valid(H >= 1 && H <= Ti::COLS && groups >= 1) {
    const int members = (H + Ti::UNITS - 1) / Ti::UNITS;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = members;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(groups * members);
    config.blockDim = dim3(Ti::THREADS);
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
  }
};

// A cluster past the portable 8 blocks needs the kernel's opt-in, set once
// per kernel and device (not again inside a CUDA graph's capture).
template <typename T, typename Cell, typename Ti>
inline cudaError_t allow_cluster(int H) {
  static std::atomic<unsigned long long> allowed{0};    // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (H + Ti::UNITS - 1) / Ti::UNITS <= 8 ||
      dev >= 64 || (allowed.load() >> dev & 1))
    return err;
  err = cudaFuncSetAttribute(
      rnn_fwd_chain_kernel<T, Cell, Ti, true>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) allowed.fetch_or(1ull << dev);
  return err;
}

// The cluster body, the whole batch in one launch: one cluster per group.
template <typename T, typename Cell, typename Ti>
inline cudaError_t fwd_cluster_launch(FwdArgs p, cudaStream_t stream) {
  const int groups = p.D * ((p.B + RES_BT - 1) / RES_BT);
  ClusterLaunch<Ti> launch(p.H, groups, stream);
  if (!launch.valid) return cudaErrorInvalidValue;
  const auto kernel = rnn_fwd_chain_kernel<T, Cell, Ti, true>;
  const cudaError_t err = allow_cluster<T, Cell, Ti>(p.H);
  if (err != cudaSuccess) return reported(err);
  p.members = launch.attr[0].val.clusterDim.x;
  p.row0 = 0;
  p.rows = p.B;
  p.tickets = nullptr;
  return reported(cudaLaunchKernelEx(&launch.config, kernel, p));
}

// How many clusters of the cluster body at width H the card holds at once
// (cudaOccupancyMaxActiveClusters for the kernel's own registers, threads
// and shared memory); minus the error if the runtime refuses the query.
template <typename T, typename Cell, typename Ti>
inline long long fwd_cluster_fit(int H) {
  ClusterLaunch<Ti> launch(H, 1, nullptr);
  if (!launch.valid) return -(long long)cudaErrorInvalidValue;
  const auto kernel = rnn_fwd_chain_kernel<T, Cell, Ti, true>;
  int clusters = 0;
  cudaError_t err = allow_cluster<T, Cell, Ti>(H);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.config);
  return err == cudaSuccess ? clusters : -(long long)reported(err);
}

// The cluster body at `units` hidden units a block: the cell's
// ClusterTiling19 or ClusterTiling36. Any other count is refused.
template <typename T, typename Cell>
inline cudaError_t fwd_cluster(FwdArgs p, int units, cudaStream_t stream) {
  using Narrow = typename Cell::ClusterTiling19;
  using Broad = typename Cell::ClusterTiling36;
  if (units == Narrow::UNITS)
    return fwd_cluster_launch<T, Cell, Narrow>(p, stream);
  if (units == Broad::UNITS)
    return fwd_cluster_launch<T, Cell, Broad>(p, stream);
  return cudaErrorInvalidValue;
}

template <typename T, typename Cell>
inline long long fwd_cluster_fit(int units, int H) {
  using Narrow = typename Cell::ClusterTiling19;
  using Broad = typename Cell::ClusterTiling36;
  if (units == Narrow::UNITS) return fwd_cluster_fit<T, Cell, Narrow>(H);
  if (units == Broad::UNITS) return fwd_cluster_fit<T, Cell, Broad>(H);
  return -(long long)cudaErrorInvalidValue;
}

}  // namespace dl4ss
