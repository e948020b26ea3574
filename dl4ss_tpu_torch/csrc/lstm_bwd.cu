// K8 — BiLSTM backward (backpropagation through time), both directions.
//
// Replaces dl4ss_tpu/ops/pallas_rnn.py::_lstm_bwd_kernel (the Pallas body of
// pallas_lstm_scan's VJP, _lstm_bwd_vjp). It takes what that VJP hands its
// kernel: xp (T, D, B, 4H), U (D, H, 4H), hprev and cprev (T, D, B, H) (hs
// and cs one step late, zero at t = 0), cs and dhs (T, D, B, H). Per step,
// in reverse, it recomputes the forward gates i, f, g, o from hprev and
//   dh = carry + dhs_t          tc = tanh(cs_t)
//   do = dh*tc                  dc = dc_carry + dh*o*(1 - tc^2)
//   di = dc*g    dg = dc*i      df = dc*cprev     dc_carry = dc*f
//   da_t  = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]
//   dxp_t = da_t                carry = da_t . U^T
// and over all steps dU = sum_t hprev_t^T . da_t. Unlike the GRU (K5) one
// da serves both uses, so dxp itself is what the next step and dU read.
// Dtypes follow _lstm_bwd_vjp: bf16 inputs give a bf16 dxp, that is da is
// rounded to bf16 before both products (pallas_rnn.py:345-352); dh, dc and
// dU stay f32.
//
// Bound on the H100: at H=300, B=16, T=313 one layer's arithmetic is ~21.6
// GFLOP (the gate recompute, the carry product and dU, 7.2 GFLOP each),
// ~0.32 ms at the f32 CUDA-core rate. As for K5 the 313 dependent carry
// products set the time, not the operations.
//
// Design, after K5: two bodies, named to the entry point by the caller
// (ops/rnn_kernels.py::rnn_body, by shape alone).
//
// The resident body (rnn_bwd_common.cuh has the three phases). The step is
// linear in dh and dc, so phase A turns the recomputed gates of every step
// into six coefficients per unit,
//   k_c = o(1-tc^2)   k_i = g i(1-i)   k_f = cprev f(1-f)   k_g = i(1-g^2)
//   k_o = tc o(1-o)   and f itself,
// and the chain, one cooperative launch for all T steps with U^T resident
// in registers, is left with dc = dc_carry + dh k_c, da = [dc k_i, dc k_f,
// dc k_g, dh k_o], dc_carry = dc f and dh = da_{t+1} . U^T + dhs_t. dc is
// carried in the owner thread's register. dU comes from the split
// reduction shared with K5.
//
// The stepwise body, for widths and batches the resident one cannot hold
// (the TDAA classifier's H=600 among them): one kernel per step t from a C
// loop. A block owns K8_JT hidden units j of one direction for K8_BT batch
// rows: it stages hprev_t and da_{t+1} (= dxp_{t+1}, left in device memory
// by the previous launch) in shared memory, its K8_KW warps split the gate
// recompute hprev_t . U (over H) and then the carry da_{t+1} . U^T (over
// 4H; U^T is built once per call so both reads are coalesced across j),
// and the first K8_BT*K8_JT threads each finish one (row, unit). dc is
// carried in an f32 (D, B, H) buffer updated in place by the one thread
// that owns each element. With four gates the staged da row is 4H long, so
// the batch tile is 8 rows (K5's is 16). Shared memory is K8_BT*5H*4 B of
// staged rows plus 64 KB of partial sums: 112 KB at H=300, 160 KB at H=600,
// 224 KB at H=1000. Past H=1043 the block exceeds the 227 KB limit: the
// opt-in fails, the entry point returns its error and the wrapper raises.
#include "rnn_bwd_common.cuh"

namespace {

constexpr int K8_JT = 32;   // hidden units per block: one per lane
constexpr int K8_KW = 16;   // warps splitting each reduction
constexpr int K8_BT = 8;    // batch rows per block
constexpr int K8_THREADS = 32 * K8_KW;
constexpr int K8_OWNERS = K8_BT * K8_JT;   // threads finishing a (row, unit)
static_assert(K8_OWNERS <= K8_THREADS, "one (row, unit) per owner thread");

template <typename T>
__global__ void __launch_bounds__(K8_THREADS) lstm_bwd_step_kernel(
    const T* __restrict__ xp_t,       // (D, B, 4H) projections at step t
    const T* __restrict__ wh,         // (D, H, 4H) U
    const T* __restrict__ wht,        // (D, 4H, H) U transposed
    const T* __restrict__ hprev_t,    // (D, B, H)
    const T* __restrict__ cprev_t,    // (D, B, H)
    const T* __restrict__ cs_t,       // (D, B, H)
    const T* __restrict__ dhs_t,      // (D, B, H)
    const T* __restrict__ da_next,    // (D, B, 4H) dxp_{t+1}; null at T-1
    float* __restrict__ dc,           // (D, B, H) dc carry of t+1, then t
    T* __restrict__ dxp_t,            // (D, B, 4H)
    int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* hsh = smem;                   // (K8_BT, H) rows of hprev_t
  float* dsh = hsh + K8_BT * H;        // (K8_BT, 4H) rows of da_{t+1}
  float* red = dsh + K8_BT * G;        // (K8_KW, K8_BT, 4, K8_JT) partials
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * K8_BT;
  const int nb = min(K8_BT, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool has_next = da_next != nullptr;
  for (int i = threadIdx.x; i < K8_BT * H; i += K8_THREADS) {
    const int r = i / H, k = i % H;
    hsh[i] = r < nb ? dl4ss::to_f32(hprev_t[((size_t)d * B + b0 + r) * H + k])
                    : 0.0f;
  }
  if (has_next)
    for (int i = threadIdx.x; i < K8_BT * G; i += K8_THREADS) {
      const int r = i / G, g = i % G;
      dsh[i] = r < nb
                   ? dl4ss::to_f32(da_next[((size_t)d * B + b0 + r) * G + g])
                   : 0.0f;
    }
  __syncthreads();

  const int j = blockIdx.x * K8_JT + lane;   // this lane's unit in the loops
  {  // gate pre-activations a = hprev_t . U at columns j, H+j, 2H+j, 3H+j
    float acc[K8_BT][4];
#pragma unroll
    for (int r = 0; r < K8_BT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
    if (j < H) {
      const int kc = (H + K8_KW - 1) / K8_KW;
      const int k_lo = warp * kc, k_hi = min(H, k_lo + kc);
      const T* U = wh + (size_t)d * H * G;
#pragma unroll 4
      for (int k = k_lo; k < k_hi; ++k) {
        const T* Uk = U + (size_t)k * G;
        float u[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) u[g] = dl4ss::to_f32(Uk[g * H + j]);
#pragma unroll
        for (int r = 0; r < K8_BT; ++r) {
          const float hk = hsh[r * H + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hk, u[g], acc[r][g]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < K8_BT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        red[((warp * K8_BT + r) * 4 + g) * K8_JT + lane] = acc[r][g];
  }
  __syncthreads();

  // the first K8_OWNERS threads each own one (row rr, unit jo)
  const bool owner = threadIdx.x < K8_OWNERS;
  const int rr = threadIdx.x / K8_JT, jj = threadIdx.x % K8_JT;
  const int jo = blockIdx.x * K8_JT + jj;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (owner)
    for (int w = 0; w < K8_KW; ++w)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        a[g] += red[((w * K8_BT + rr) * 4 + g) * K8_JT + jj];
  float carry = 0.0f;             // (da_{t+1} . U^T)[row, jo]
  if (has_next) {
    __syncthreads();              // every owner has read its partials
    float acc[K8_BT];
#pragma unroll
    for (int r = 0; r < K8_BT; ++r) acc[r] = 0.0f;
    if (j < H) {
      const int gc = (G + K8_KW - 1) / K8_KW;
      const int g_lo = warp * gc, g_hi = min(G, g_lo + gc);
      const T* Ut = wht + (size_t)d * G * H;
#pragma unroll 4
      for (int g = g_lo; g < g_hi; ++g) {
        const float u = dl4ss::to_f32(Ut[(size_t)g * H + j]);
#pragma unroll
        for (int r = 0; r < K8_BT; ++r)
          acc[r] = fmaf(dsh[r * G + g], u, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < K8_BT; ++r)
      red[(warp * K8_BT + r) * K8_JT + lane] = acc[r];
    __syncthreads();
    if (owner)
      for (int w = 0; w < K8_KW; ++w)
        carry += red[(w * K8_BT + rr) * K8_JT + jj];
  }
  if (!owner || rr >= nb || jo >= H) return;

  const size_t row = (size_t)d * B + b0 + rr;
  const T* x = xp_t + row * G;
  const float ig = dl4ss::sigmoid(dl4ss::to_f32(x[jo]) + a[0]);
  const float fg = dl4ss::sigmoid(dl4ss::to_f32(x[H + jo]) + a[1]);
  const float gg = tanhf(dl4ss::to_f32(x[2 * H + jo]) + a[2]);
  const float og = dl4ss::sigmoid(dl4ss::to_f32(x[3 * H + jo]) + a[3]);
  const size_t u = row * H + jo;
  const float tc = tanhf(dl4ss::to_f32(cs_t[u]));
  const float dh = carry + dl4ss::to_f32(dhs_t[u]);
  const float d_o = dh * tc;
  const float dcv = (has_next ? dc[u] : 0.0f) + dh * og * (1.0f - tc * tc);
  const float di = dcv * gg;
  const float dg = dcv * ig;
  const float df = dcv * dl4ss::to_f32(cprev_t[u]);
  dc[u] = dcv * fg;
  T* dx = dxp_t + row * G;
  dl4ss::store(dx + jo, di * ig * (1.0f - ig));
  dl4ss::store(dx + H + jo, df * fg * (1.0f - fg));
  dl4ss::store(dx + 2 * H + jo, dg * (1.0f - gg * gg));
  dl4ss::store(dx + 3 * H + jo, d_o * og * (1.0f - og));
}

// The resident body's cell: see the note at the top of this file.
struct LstmCell {
  static constexpr int NG = 4, NC = 6;
  // as GruCell's: G <= 1216 columns, 19 a lane
  using Tiling = dl4ss::ResidentTiling<3, 1, 2, 8, 19>;
  static constexpr bool SPLIT = false;   // one da serves dxp, carry and dU
  struct State {
    float dc;
  };
  // e0 = cprev, e1 = cs, both (T, D, B, H) in the input dtype
  template <typename T>
  __device__ static void coefficients(const float (&a)[NG], const T* x,
                                      const void* e0, const void* e1,
                                      size_t row, int, int j, int H, float,
                                      float (&out)[NC]) {
    const float ig = dl4ss::sigmoid(dl4ss::to_f32(x[j]) + a[0]);
    const float fg = dl4ss::sigmoid(dl4ss::to_f32(x[H + j]) + a[1]);
    const float gg = tanhf(dl4ss::to_f32(x[2 * H + j]) + a[2]);
    const float og = dl4ss::sigmoid(dl4ss::to_f32(x[3 * H + j]) + a[3]);
    const size_t u = row * H + j;
    const float cp = dl4ss::to_f32(static_cast<const T*>(e0)[u]);
    const float tc = tanhf(dl4ss::to_f32(static_cast<const T*>(e1)[u]));
    out[0] = og * (1.0f - tc * tc);
    out[1] = gg * ig * (1.0f - ig);
    out[2] = cp * fg * (1.0f - fg);
    out[3] = ig * (1.0f - gg * gg);
    out[4] = tc * og * (1.0f - og);
    out[5] = fg;
  }
  __device__ static void step(const float (&c)[NC], float dot, float dhs,
                              State& s, float (&dx)[NG], float (&)[NG]) {
    const float dh = dot + dhs;
    const float dc = s.dc + dh * c[0];
    dx[0] = dc * c[1];
    dx[1] = dc * c[2];
    dx[2] = dc * c[3];
    dx[3] = dh * c[4];
    s.dc = dc * c[5];
  }
  __device__ static float total(const State&) { return 0.0f; }
};

template <typename T>
cudaError_t run_resident(const void* xp, const void* wh, const void* hprev,
                         const void* cprev, const void* cs, const void* dhs,
                         void* dxp, void* du, void* work, void* du_part,
                         void* tickets, int du_parts, int groups, int chunk,
                         int steps, int D, int B, int H,
                         cudaStream_t stream) {
  const int G = 4 * H;
  float* coef = static_cast<float*>(work);    // (T, D, B, H, 6)
  cudaError_t err = dl4ss::coefficients<T, LstmCell>(
      {xp, wh, hprev, cprev, cs, coef, steps, D, B, H}, stream);
  if (err != cudaSuccess) return err;
  err = dl4ss::chain<T, LstmCell>(
      {wh, coef, dhs, dxp, dxp, nullptr, static_cast<unsigned int*>(tickets),
       steps, D, B, H, 0, 0, 0}, groups, chunk, stream);
  if (err != cudaSuccess) return err;
  return dl4ss::weight_grad<T, 4>(static_cast<const T*>(hprev),
                                  static_cast<const T*>(dxp),
                                  static_cast<float*>(du),
                                  static_cast<float*>(du_part), du_parts,
                                  steps, D, B, H, G, stream);
}

template <typename T>
cudaError_t run_stepwise(const void* xp, const void* wh, const void* hprev,
                         const void* cprev, const void* cs, const void* dhs,
                         void* dxp, void* du, void* wht, void* dc,
                         void* du_part, int du_parts, int steps, int D, int B,
                         int H, cudaStream_t stream) {
  const int G = 4 * H;
  const T* U = static_cast<const T*>(wh);
  T* Ut = static_cast<T*>(wht);
  cudaError_t err = dl4ss::transpose(U, Ut, D, H, G, stream);
  if (err != cudaSuccess) return err;

  const dim3 grid((H + K8_JT - 1) / K8_JT, D, (B + K8_BT - 1) / K8_BT);
  const size_t smem = ((size_t)K8_BT * 5 * H +
                       (size_t)K8_KW * K8_BT * 4 * K8_JT) * sizeof(float);
  err = dl4ss::allow_smem(lstm_bwd_step_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(xp);
  const T* hp = static_cast<const T*>(hprev);
  const T* cp = static_cast<const T*>(cprev);
  const T* cc = static_cast<const T*>(cs);
  const T* dh = static_cast<const T*>(dhs);
  T* dx = static_cast<T*>(dxp);
  const size_t sg = (size_t)D * B * G, sh = (size_t)D * B * H;
  for (int t = steps - 1; t >= 0; --t) {
    lstm_bwd_step_kernel<T><<<grid, K8_THREADS, smem, stream>>>(
        x + t * sg, U, Ut, hp + t * sh, cp + t * sh, cc + t * sh, dh + t * sh,
        t + 1 < steps ? dx + (t + 1) * sg : nullptr, static_cast<float*>(dc),
        dx + t * sg, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return dl4ss::weight_grad<T, 4>(hp, dx, static_cast<float*>(du),
                                  static_cast<float*>(du_part), du_parts,
                                  steps, D, B, H, G, stream);
}

template <typename T>
cudaError_t run(const void* xp, const void* wh, const void* hprev,
                const void* cprev, const void* cs, const void* dhs, void* dxp,
                void* du, void* wht, void* dc, void* work, void* du_part,
                void* tickets, int du_parts, int groups, int chunk, int steps,
                int D, int B, int H, int body, cudaStream_t stream) {
  if (body == dl4ss::BODY_RESIDENT)
    return run_resident<T>(xp, wh, hprev, cprev, cs, dhs, dxp, du, work,
                           du_part, tickets, du_parts, groups, chunk, steps,
                           D, B, H, stream);
  if (body == dl4ss::BODY_STEPWISE)
    return run_stepwise<T>(xp, wh, hprev, cprev, cs, dhs, dxp, du, wht, dc,
                           du_part, du_parts, steps, D, B, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// xp, hprev, cprev, cs, dhs (T, D, B, *) and wh (D, H, 4H) in f32, or all in
// bf16 (bf16 != 0) -> dxp (T, D, B, 4H) in the input dtype and du
// (D, H, 4H) in f32. body: 1 resident, 2 stepwise; the resident body returns
// an error for a shape it cannot hold. Scratch from the caller, for both
// bodies: du_part (du_parts, D, H, 4H) f32. Resident: work = (T, D, B, H, 6)
// f32 and tickets = `groups` zeroed 32-bit counters. du_parts and groups say
// what the caller allocated: a count other than the kernels' own (16 slabs;
// one group per direction and 4 batch rows) is refused with an error.
// Stepwise: wht (D, 4H, H) in the input dtype and dc (D, B, H) f32 (it need
// not be initialised). What a body does not use may be null.
extern "C" int dl4ss_lstm_bwd(const void* xp, const void* wh,
                              const void* hprev, const void* cprev,
                              const void* cs, const void* dhs, void* dxp,
                              void* du, void* wht, void* dc, void* work,
                              void* du_part, void* tickets, int du_parts,
                              int groups, int chunk, int steps, int D, int B,
                              int H, int bf16, int body, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(xp, wh, hprev, cprev, cs, dhs, dxp, du,
                                   wht, dc, work, du_part, tickets, du_parts,
                                   groups, chunk, steps, D, B, H, body, s)
              : run<float>(xp, wh, hprev, cprev, cs, dhs, dxp, du, wht, dc,
                           work, du_part, tickets, du_parts, groups, chunk,
                           steps, D, B, H, body, s);
}
