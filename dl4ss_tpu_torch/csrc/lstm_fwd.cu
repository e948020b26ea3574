// K7 — BiLSTM forward recurrence over the whole sequence, both directions.
//
// Replaces dl4ss_tpu/ops/pallas_rnn.py::_lstm_fwd_kernel (the Pallas body of
// pallas_lstm_scan). As in the JAX wrapper, the input projections
// xp = x.Wx + bx + bh (every bias folded in) and the direction flip stay
// outside; this kernel runs, per step t and direction d, with h0 = c0 = 0
// and the gate order i, f, g, o:
//   a = xp + h.U;  i,f,o = sigmoid(a_i, a_f, a_o);  g = tanh(a_g)
//   c' = f*c + i*g;  h' = o*tanh(c')
// and writes hs[t] = h' and cs[t] = c', which the backward (K8) reads.
// Dtypes follow the JAX kernel (pallas_rnn.py:266-279): f32 inputs compute
// in f32; bf16 inputs keep bf16 operands and a bf16 h with f32
// accumulation. The cell state is carried in f32 in both cases (its own
// (D, B, H) buffer, updated in place: each element is read and written by
// one thread); only the stored cs is rounded to the input dtype.
//
// Bound on the H100: at H=300, B=16, T=313 the h.U products are 7.2 GFLOP
// per layer, ~0.11 ms at the f32 CUDA-core rate. As for K2 (gru_fwd.cu) the
// real limit is the 313 dependent steps.
//
// Design, after K2: five bodies, named to the entry point by the caller
// (ops/rnn_kernels.py::rnn_body, by shape and the card's occupancy answer).
// The tiled body (rnn_fwd_tiled.cuh) takes the batches from B=52 on at
// H <= 300, where it was measured to beat the stepwise body. The resident
// body is
// rnn_fwd_common.cuh's chain with LstmFwdCell below: c stays in the owner
// thread's register for all steps. The cluster body is the same chain with
// each (direction, 4 rows) one thread-block cluster that passes h through
// distributed shared memory. The wide body (rnn_fwd_wide.cuh, the same
// cell) is one persistent launch for the widths the registers cannot hold
// (H > 304, the TDAA classifier's H=600 among them), with each direction's
// U held once in the blocks' shared memory. The stepwise body takes every
// other shape: one kernel per step from a C loop (one ctypes call per
// layer), each costing a launch and one pass over U (1.44 MB per direction
// in f32 at H=300, L2-resident).
//
// Design of one step of the stepwise body: a block owns K7_JT hidden units
// j of one direction for a tile of up to K7_BT batch rows, whose h_prev (=
// hs[t-1]) it stages in shared memory. Its K7_KW warps split the
// k-reduction of h.U: lane j of warp w reads U[k, {j, H+j, 2H+j, 3H+j}] for
// its k-slice once (coalesced across j) and applies each value to every
// batch row of the tile. The partial sums meet in shared memory, where each
// (row, j) output gets its gate math. With four gates a thread holds
// 4*K7_BT accumulators, so the batch tile is 8 rows (K2's is 16): 32
// registers of accumulators and 64 KB of partial sums plus K7_BT*H*4 B of
// staged h: 74 KB at H=300, 83 KB at H=600 (the TDAA classifier width), 96
// KB at H=1024. Past H=5216 the block exceeds the 227 KB limit: the opt-in
// then fails, the entry point returns its error and the wrapper raises.
#include "rnn_fwd_common.cuh"
#include "rnn_fwd_tiled.cuh"
#include "rnn_fwd_wide.cuh"

namespace {

constexpr int K7_JT = 32;   // hidden units per block: one per lane
constexpr int K7_KW = 16;   // warps splitting the k-reduction
constexpr int K7_BT = 8;    // batch rows per block
constexpr int K7_THREADS = 32 * K7_KW;

template <typename T>
__global__ void __launch_bounds__(K7_THREADS) lstm_step_kernel(
    const T* __restrict__ xp_t,     // (D, B, 4H) projections at step t
    const T* __restrict__ wh,       // (D, H, 4H) recurrent weights
    const T* __restrict__ h_prev,   // (D, B, H) hs[t-1], or null at t == 0
    float* __restrict__ c,          // (D, B, H) f32 cell carry, in place
    T* __restrict__ h_out,          // (D, B, H) hs[t]
    T* __restrict__ c_out,          // (D, B, H) cs[t]
    int B, int H) {
  extern __shared__ float smem[];
  float* hsh = smem;                 // (K7_BT, H) rows of h_prev
  float* red = smem + K7_BT * H;     // (K7_KW, K7_BT, 4, K7_JT) partials
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * K7_BT;
  const int nb = min(K7_BT, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool first = h_prev == nullptr;
  for (int i = threadIdx.x; i < K7_BT * H; i += K7_THREADS) {
    const int bb = i / H, k = i % H;
    hsh[i] = (!first && bb < nb)
                 ? dl4ss::to_f32(h_prev[((size_t)d * B + b0 + bb) * H + k])
                 : 0.0f;
  }
  __syncthreads();

  const int G = 4 * H;
  const int j = blockIdx.x * K7_JT + lane;
  float acc[K7_BT][4];
#pragma unroll
  for (int bb = 0; bb < K7_BT; ++bb)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[bb][g] = 0.0f;
  if (j < H && !first) {
    const int kc = (H + K7_KW - 1) / K7_KW;
    const int k_lo = warp * kc, k_hi = min(H, k_lo + kc);
    const T* U = wh + (size_t)d * H * G;
#pragma unroll 4
    for (int k = k_lo; k < k_hi; ++k) {
      const T* Uk = U + (size_t)k * G;
      float u[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) u[g] = dl4ss::to_f32(Uk[g * H + j]);
#pragma unroll
      for (int bb = 0; bb < K7_BT; ++bb) {
        const float hk = hsh[bb * H + k];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[bb][g] = fmaf(hk, u[g], acc[bb][g]);
      }
    }
  }
#pragma unroll
  for (int bb = 0; bb < K7_BT; ++bb)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      red[((warp * K7_BT + bb) * 4 + g) * K7_JT + lane] = acc[bb][g];
  __syncthreads();

  for (int o = threadIdx.x; o < K7_BT * K7_JT; o += K7_THREADS) {
    const int bb = o / K7_JT, jj = o % K7_JT;
    const int jo = blockIdx.x * K7_JT + jj;
    if (bb >= nb || jo >= H) continue;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int w = 0; w < K7_KW; ++w)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        a[g] += red[((w * K7_BT + bb) * 4 + g) * K7_JT + jj];
    const T* x = xp_t + ((size_t)d * B + b0 + bb) * G;
    const float ig = dl4ss::sigmoid(dl4ss::to_f32(x[jo]) + a[0]);
    const float fg = dl4ss::sigmoid(dl4ss::to_f32(x[H + jo]) + a[1]);
    const float gg = tanhf(dl4ss::to_f32(x[2 * H + jo]) + a[2]);
    const float og = dl4ss::sigmoid(dl4ss::to_f32(x[3 * H + jo]) + a[3]);
    const size_t u = ((size_t)d * B + b0 + bb) * H + jo;
    const float cn = fg * (first ? 0.0f : c[u]) + ig * gg;
    c[u] = cn;
    dl4ss::store(c_out + u, cn);
    dl4ss::store(h_out + u, og * tanhf(cn));
  }
}

template <typename T>
cudaError_t run_stepwise(const void* xp, const void* wh, void* hs, void* cs,
                         void* c, int steps, int D, int B, int H,
                         cudaStream_t stream) {
  const dim3 grid((H + K7_JT - 1) / K7_JT, D, (B + K7_BT - 1) / K7_BT);
  const size_t smem =
      ((size_t)K7_BT * H + (size_t)K7_KW * K7_BT * 4 * K7_JT) * sizeof(float);
  cudaError_t err = dl4ss::allow_smem(lstm_step_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(xp);
  T* h = static_cast<T*>(hs);
  T* co = static_cast<T*>(cs);
  const size_t step_x = (size_t)D * B * 4 * H, step_h = (size_t)D * B * H;
  for (int t = 0; t < steps; ++t) {
    lstm_step_kernel<T><<<grid, K7_THREADS, smem, stream>>>(
        x + t * step_x, static_cast<const T*>(wh),
        t ? h + (t - 1) * step_h : nullptr, static_cast<float*>(c),
        h + t * step_h, co + t * step_h, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The resident body's gate math: i, f, o = sigmoid, g = tanh of x + a;
// c' = f * c + i * g (c in f32 in the owner's register), h' = o * tanh(c').
struct LstmFwdCell {
  static constexpr int NG = 4;
  static constexpr bool CELL_OUT = true;
  // 4 outputs a unit, 3 a lane group (a unit's gates may span two); 8
  // unit warps x 2 column warps split H <= 304 rows, 19 a lane: 57 floats,
  // the fastest of the tilings measured (PERF.md, PR 6)
  using Tiling = dl4ss::ResidentTiling<3, 4, 8, 2, 19>;
  // the cluster body's two tilings: 19 units a block (76 outputs in 80
  // slots, 4 a lane group, 5 unit warps: 76 floats a thread; 16 blocks a
  // cluster at H=300) and 36 (6 a lane group, 6 unit warps: 114 floats a
  // thread; 9 blocks a cluster at H=300)
  using ClusterTiling19 = dl4ss::ResidentTiling<4, 4, 5, 2, 19, 19>;
  using ClusterTiling36 = dl4ss::ResidentTiling<6, 4, 6, 2, 19, 36>;
  struct State {
    float c;
  };
  __device__ static State init(const float*, int, int, int) { return {0.0f}; }
  __device__ static float step(const float (&x)[NG], const float (&a)[NG],
                               float, State& s, float& c_out) {
    const float ig = dl4ss::sigmoid(x[0] + a[0]);
    const float fg = dl4ss::sigmoid(x[1] + a[1]);
    const float gg = tanhf(x[2] + a[2]);
    const float og = dl4ss::sigmoid(x[3] + a[3]);
    s.c = fg * s.c + ig * gg;
    c_out = s.c;
    return og * tanhf(s.c);
  }
};

template <typename T>
cudaError_t run(const void* xp, const void* wh, void* hs, void* cs, void* c,
                void* tickets, int groups, int chunk, int units, int steps,
                int D, int B, int H, int body, cudaStream_t stream) {
  const dl4ss::FwdArgs args = {xp, wh, nullptr, hs, cs,
                               static_cast<unsigned int*>(tickets), steps, D,
                               B, H, 0, 0, 0};
  if (body == dl4ss::BODY_RESIDENT)
    return dl4ss::fwd_chain<T, LstmFwdCell>(args, groups, chunk, stream);
  if (body == dl4ss::BODY_CLUSTER)
    return dl4ss::fwd_cluster<T, LstmFwdCell>(args, units, stream);
  if (body == dl4ss::BODY_TILED)
    return dl4ss::tiled::fwd_tiled<T, LstmFwdCell>(args, groups, chunk,
                                                   stream);
  if (body == dl4ss::BODY_WIDE)
    return dl4ss::wide::fwd_chain<T, LstmFwdCell>(
        {xp, wh, hs, cs, static_cast<unsigned int*>(tickets), steps, D, B, H,
         0, 0, 0, 0},
        groups, stream);
  if (body == dl4ss::BODY_STEPWISE)
    return run_stepwise<T>(xp, wh, hs, cs, c, steps, D, B, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// xp (T, D, B, 4H) and wh (D, H, 4H) in f32, or both in bf16 (bf16 != 0);
// hs, cs (T, D, B, H) in the input dtype. body: 1 resident, 2 stepwise, 3
// wide, 4 cluster, 5 tiled (as in gru_fwd.cu); the resident, wide, cluster
// and tiled bodies return an error for a shape they cannot hold. Resident:
// tickets = `groups` zeroed 32-bit counters, one per direction and 4 batch
// rows (any other count is refused), and the batch runs in chunks of
// `chunk` rows (a multiple of 4), one launch each. Wide: tickets =
// `groups` = D zeroed counters, one launch; `chunk` is not read. Cluster:
// one launch, `units` hidden units a block (19 or 36; any other count is
// refused). Tiled: as in gru_fwd.cu. Stepwise: c (D, B, H) f32 scratch
// (the cell carry; it need not be initialised). What a body does not use
// may be null.
extern "C" int dl4ss_lstm_fwd(const void* xp, const void* wh, void* hs,
                              void* cs, void* c, void* tickets, int groups,
                              int chunk, int units, int steps, int D, int B,
                              int H, int bf16, int body, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(xp, wh, hs, cs, c, tickets, groups, chunk,
                                   units, steps, D, B, H, body, s)
              : run<float>(xp, wh, hs, cs, c, tickets, groups, chunk, units,
                           steps, D, B, H, body, s);
}

// How many clusters of the cluster body, `units` hidden units a block at
// width H, the card holds at once; minus a CUDA error code.
extern "C" long long dl4ss_lstm_fwd_clusters(int bf16, int units, int H) {
  return bf16 ? dl4ss::fwd_cluster_fit<__nv_bfloat16, LstmFwdCell>(units, H)
              : dl4ss::fwd_cluster_fit<float, LstmFwdCell>(units, H);
}
