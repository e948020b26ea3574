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
// dependent steps: this version launches one kernel per step (a C loop in
// the same library, so one ctypes call per layer), and each step costs the
// latency of one pass over U plus a launch. The U-resident persistent
// design is later work: one direction's U is 1.08 MB in f32 (540 KB in
// bf16), more than one SM's 227 KB of shared memory, so it must be split
// across the blocks of a cluster or a cooperative grid.
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
#include "dl4ss_common.cuh"

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
cudaError_t run(const void* xp, const void* wh, const void* bhn, void* hs,
                int steps, int D, int B, int H, cudaStream_t stream) {
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

}  // namespace

// xp (T, D, B, 3H) and wh (D, H, 3H) in f32, or both in bf16 (bf16 != 0);
// bhn (D, 1, H) f32; hs (T, D, B, H) in the input dtype.
extern "C" int dl4ss_gru_fwd(const void* xp, const void* wh, const void* bhn,
                             void* hs, int steps, int D, int B, int H,
                             int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(xp, wh, bhn, hs, steps, D, B, H, s)
              : run<float>(xp, wh, bhn, hs, steps, D, B, H, s);
}
