// K2 — BiGRU forward recurrence over the whole sequence, both directions.
//
// Replaces dl4ss_tpu/ops/pallas_rnn.py::_gru_fwd_kernel (the Pallas body of
// pallas_gru_scan). As in the JAX wrapper, the input projections
// xp = x.Wx + bias (r,z biases folded in) and the direction flip stay
// outside; this kernel runs, per step t and direction d, with h0 = 0:
//   r,z = sigmoid(xp_rz + h.U_rz);  n = tanh(xp_n + r*(h.U_n + b_n))
//   h'  = (1-z)*n + z*h
// f32 inputs compute in f32; bf16 inputs keep bf16 operands and h carry
// with f32 accumulation (the JAX kernel's dtype rule, pallas_rnn.py:152-158).
//
// Bound on the H100: at H=300, B=16, T=313 the h.U products are 5.4 GFLOP
// per layer, ~80 us at the f32 CUDA-core rate. The real limit is the 313
// dependent steps.
//
// Design: four bodies, named to the entry point by the caller
// (ops/rnn_kernels.py::rnn_body, by shape and the card's occupancy answer).
//
// The resident body (rnn_fwd_common.cuh): ONE persistent cooperative launch
// per chunk of batch rows walks all steps of both directions, each block
// with the gate columns of its 24 hidden units of U in registers and a
// ticket barrier per (direction, 4 rows). The cluster body is the same
// chain with each (direction, 4 rows) one thread-block cluster that passes
// h through distributed shared memory, in one launch. GruFwdCell below is
// their gate math. The tiled body (rnn_fwd_tiled.cuh) takes the batches
// past the resident body (B > 40 at H=300): one persistent launch per
// layer whose blocks hold U in shared memory for 32 rows each, with the
// same cell.
//
// The stepwise body, for the widths past the persistent bodies (H > 304):
// one kernel per step, launched from a C loop in the same library, so one
// ctypes call per layer; each step costs the latency of one pass over U
// plus a launch.
//
// Design of one step: a block owns K2_JT hidden units j of one direction
// for a tile of up to K2_BT batch rows, whose h_prev (= hs[t-1]; no
// ping-pong buffer) it stages in shared memory. Its K2_KW warps split the
// k-reduction of h.U: lane j of warp w reads U[k, j], U[k, H+j], U[k, 2H+j]
// for its k-slice once (coalesced across j, L2-resident) and applies each
// value to every batch row of the tile, so U is read once per block and
// step rather than once per batch row. Sixteen warps keep each warp's
// chain of U loads short (19 k at H=300). The partial sums meet in shared
// memory, where each (row, j) output gets its gate math and is written to
// hs[t].
#include "rnn_fwd_common.cuh"
#include "rnn_fwd_tiled.cuh"

namespace {

constexpr int K2_JT = 32;   // hidden units per block: one per lane
constexpr int K2_KW = 16;   // warps splitting the k-reduction
constexpr int K2_BT = 16;   // batch rows per block
constexpr int K2_THREADS = 32 * K2_KW;

template <typename T>
__global__ void __launch_bounds__(K2_THREADS) gru_step_kernel(
    const T* __restrict__ xp_t,     // (D, B, 3H) projections at step t
    const T* __restrict__ wh,       // (D, H, 3H) recurrent weights
    const float* __restrict__ bhn,  // (D, H) candidate bias b_n
    const T* __restrict__ h_prev,   // (D, B, H) hs[t-1], or null at t == 0
    T* __restrict__ h_out,          // (D, B, H) hs[t]
    int B, int H) {
  extern __shared__ float smem[];
  float* hsh = smem;                 // (K2_BT, H) rows of h_prev
  float* red = smem + K2_BT * H;     // (K2_KW, K2_BT, 3, K2_JT) partials
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * K2_BT;
  const int nb = min(K2_BT, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < K2_BT * H; i += K2_THREADS) {
    const int bb = i / H, k = i % H;
    hsh[i] = (h_prev != nullptr && bb < nb)
                 ? dl4ss::to_f32(h_prev[((size_t)d * B + b0 + bb) * H + k])
                 : 0.0f;
  }
  __syncthreads();

  const int G = 3 * H;
  const int j = blockIdx.x * K2_JT + lane;
  float acc[K2_BT][3];
#pragma unroll
  for (int bb = 0; bb < K2_BT; ++bb) acc[bb][0] = acc[bb][1] = acc[bb][2] = 0.0f;
  if (j < H) {
    const int kc = (H + K2_KW - 1) / K2_KW;
    const int k_lo = warp * kc, k_hi = min(H, k_lo + kc);
    const T* U = wh + (size_t)d * H * G;
#pragma unroll 4
    for (int k = k_lo; k < k_hi; ++k) {
      const T* Uk = U + (size_t)k * G;
      const float ur = dl4ss::to_f32(Uk[j]);
      const float uz = dl4ss::to_f32(Uk[H + j]);
      const float un = dl4ss::to_f32(Uk[2 * H + j]);
#pragma unroll
      for (int bb = 0; bb < K2_BT; ++bb) {
        const float hk = hsh[bb * H + k];
        acc[bb][0] = fmaf(hk, ur, acc[bb][0]);
        acc[bb][1] = fmaf(hk, uz, acc[bb][1]);
        acc[bb][2] = fmaf(hk, un, acc[bb][2]);
      }
    }
  }
#pragma unroll
  for (int bb = 0; bb < K2_BT; ++bb)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      red[((warp * K2_BT + bb) * 3 + g) * K2_JT + lane] = acc[bb][g];
  __syncthreads();

  for (int o = threadIdx.x; o < K2_BT * K2_JT; o += K2_THREADS) {
    const int bb = o / K2_JT, jj = o % K2_JT;
    const int jo = blockIdx.x * K2_JT + jj;
    if (bb >= nb || jo >= H) continue;
    float a[3] = {0.0f, 0.0f, 0.0f};
    for (int w = 0; w < K2_KW; ++w)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        a[g] += red[((w * K2_BT + bb) * 3 + g) * K2_JT + jj];
    const T* x = xp_t + ((size_t)d * B + b0 + bb) * G;
    const float r = dl4ss::sigmoid(dl4ss::to_f32(x[jo]) + a[0]);
    const float z = dl4ss::sigmoid(dl4ss::to_f32(x[H + jo]) + a[1]);
    const float n = tanhf(dl4ss::to_f32(x[2 * H + jo]) +
                          r * (a[2] + bhn[(size_t)d * H + jo]));
    dl4ss::store(h_out + ((size_t)d * B + b0 + bb) * H + jo,
                 (1.0f - z) * n + z * hsh[bb * H + jo]);
  }
}

template <typename T>
cudaError_t run_stepwise(const void* xp, const void* wh, const void* bhn,
                         void* hs, int steps, int D, int B, int H,
                         cudaStream_t stream) {
  const dim3 grid((H + K2_JT - 1) / K2_JT, D, (B + K2_BT - 1) / K2_BT);
  const size_t smem =
      ((size_t)K2_BT * H + (size_t)K2_KW * K2_BT * 3 * K2_JT) * sizeof(float);
  cudaError_t err = dl4ss::allow_smem(gru_step_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(xp);
  T* h = static_cast<T*>(hs);
  const size_t step_x = (size_t)D * B * 3 * H, step_h = (size_t)D * B * H;
  for (int t = 0; t < steps; ++t) {
    gru_step_kernel<T><<<grid, K2_THREADS, smem, stream>>>(
        x + t * step_x, static_cast<const T*>(wh),
        static_cast<const float*>(bhn), t ? h + (t - 1) * step_h : nullptr,
        h + t * step_h, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The resident body's gate math: r, z = sigmoid(x_rz + a_rz),
// n = tanh(x_n + r * (a_n + b_n)), h' = (1 - z) * n + z * h.
struct GruFwdCell {
  static constexpr int NG = 3;
  static constexpr bool CELL_OUT = false;
  // 3 outputs a unit (its gate columns of U), 3 a lane group; 6 unit
  // warps x 2 column warps split H <= 304 rows of U, 19 a lane: 57 floats
  using Tiling = dl4ss::ResidentTiling<3, 3, 6, 2, 19>;
  // the cluster body's two tilings: 19 units a block (57 outputs in 60
  // slots, 5 unit warps, 57 floats a thread: 16 blocks a cluster at H=300)
  // and 36 (108 outputs in 120 slots, 5 a lane group, 6 unit warps: 95
  // floats a thread; 9 blocks a cluster at H=300)
  using ClusterTiling19 = dl4ss::ResidentTiling<3, 3, 5, 2, 19, 19>;
  using ClusterTiling36 = dl4ss::ResidentTiling<5, 3, 6, 2, 19, 36>;
  struct State {
    float bn;
  };
  __device__ static State init(const float* bias, int d, int j, int H) {
    return {bias[(size_t)d * H + j]};
  }
  __device__ static float step(const float (&x)[NG], const float (&a)[NG],
                               float hp, State& s, float&) {
    const float r = dl4ss::sigmoid(x[0] + a[0]);
    const float z = dl4ss::sigmoid(x[1] + a[1]);
    const float n = tanhf(x[2] + r * (a[2] + s.bn));
    return (1.0f - z) * n + z * hp;
  }
};

template <typename T>
cudaError_t run(const void* xp, const void* wh, const void* bhn, void* hs,
                void* tickets, int groups, int chunk, int units, int steps,
                int D, int B, int H, int body, cudaStream_t stream) {
  const dl4ss::FwdArgs args = {xp, wh, static_cast<const float*>(bhn), hs,
                               nullptr, static_cast<unsigned int*>(tickets),
                               steps, D, B, H, 0, 0, 0};
  if (body == dl4ss::BODY_RESIDENT)
    return dl4ss::fwd_chain<T, GruFwdCell>(args, groups, chunk, stream);
  if (body == dl4ss::BODY_CLUSTER)
    return dl4ss::fwd_cluster<T, GruFwdCell>(args, units, stream);
  if (body == dl4ss::BODY_TILED)
    return dl4ss::tiled::fwd_tiled<T, GruFwdCell>(args, groups, chunk,
                                                  stream);
  if (body == dl4ss::BODY_STEPWISE)
    return run_stepwise<T>(xp, wh, bhn, hs, steps, D, B, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// xp (T, D, B, 3H) and wh (D, H, 3H) in f32, or both in bf16 (bf16 != 0);
// bhn (D, 1, H) f32; hs (T, D, B, H) in the input dtype. body: 1 resident,
// 2 stepwise, 4 cluster, 5 tiled; the resident, cluster and tiled bodies
// return an error for a shape they cannot hold. Resident: tickets =
// `groups` zeroed 32-bit counters, one per direction and 4 batch rows (any
// other count is refused), and the batch runs in chunks of `chunk` rows (a
// multiple of 4), one launch each. Cluster: one launch, `units` hidden
// units a block (19 or 36; any other count is refused). Tiled: tickets =
// `groups` zeroed counters, one per direction and 32 batch rows, and
// chunks of `chunk` rows (a multiple of 32), one launch each. What a body
// does not use may be null.
extern "C" int dl4ss_gru_fwd(const void* xp, const void* wh, const void* bhn,
                             void* hs, void* tickets, int groups, int chunk,
                             int units, int steps, int D, int B, int H,
                             int bf16, int body, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(xp, wh, bhn, hs, tickets, groups, chunk,
                                   units, steps, D, B, H, body, s)
              : run<float>(xp, wh, bhn, hs, tickets, groups, chunk, units,
                           steps, D, B, H, body, s);
}

// How many clusters of the cluster body, `units` hidden units a block at
// width H, the card holds at once; minus a CUDA error code.
extern "C" long long dl4ss_gru_fwd_clusters(int bf16, int units, int H) {
  return bf16 ? dl4ss::fwd_cluster_fit<__nv_bfloat16, GruFwdCell>(units, H)
              : dl4ss::fwd_cluster_fit<float, GruFwdCell>(units, H);
}
