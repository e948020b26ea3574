// K5 — BiGRU backward (backpropagation through time), both directions.
//
// Replaces dl4ss_tpu/ops/pallas_rnn.py::_gru_bwd_kernel (the Pallas body of
// pallas_gru_scan's VJP, _gru_bwd_vjp). It takes what that VJP hands its
// kernel: xp (T, D, B, 3H), U (D, H, 3H), b_n (D, 1, H), hprev (T, D, B, H)
// (hs one step late, zero at t = 0) and dhs (T, D, B, H). Per step, in
// reverse, it recomputes the forward gates from hprev and
//   dh   = carry + dhs_t
//   dn = dh(1-z)   dz = dh(hprev-n)   da_n = dn(1-n^2)   dr = da_n*hn
//   dhn = da_n*r   da_z = dz z(1-z)   da_r = dr r(1-r)
//   dxp_t = [da_r, da_z, da_n]        da_w_t = [da_r, da_z, dhn]
//   carry = dh*z + da_w_t . U^T
// and over all steps dU = sum_t hprev_t^T . da_w_t and db_n = sum dhn. The
// third gate of dxp gets da_n while the recurrent product gets dhn = da_n*r:
// n's pre-activation reaches h only through r*(h.U_n + b_n). Dtypes follow
// _gru_bwd_vjp: bf16 inputs give bf16 dxp and round da_w to bf16 before
// both products; the carry, dU and db_n stay f32.
//
// Bound on the H100: at H=300, B=16, T=313 one layer's arithmetic is ~16
// GFLOP (the gate recompute, the carry product and dU, 5.4 GFLOP each),
// ~0.24 ms at the f32 CUDA-core rate. The 313 dependent carry products set
// the time, not the operations.
//
// Design: two bodies, named to the entry point by the caller
// (ops/rnn_kernels.py::rnn_body, by shape alone).
//
// The resident body (rnn_bwd_common.cuh has the three phases). The step is
// linear in dh = carry + dhs_t, so phase A turns the recomputed gates of
// every step into five coefficients per unit,
//   c_n = (1-z)(1-n^2)   c_r = c_n hn r(1-r)   c_z = (hprev-n) z(1-z)
//   c_h = c_n r          and z itself,
// and the chain, one cooperative launch for all T steps with U^T resident
// in registers, is left with da_r = dh c_r, da_z = dh c_z, da_n = dh c_n,
// dhn = dh c_h and carry = dh z + da_w . U^T. db_n is summed over t in the
// owner thread's register and over the batch rows by a fixed-order pass;
// dU comes from the split reduction shared with K8.
//
// The stepwise body, for widths and batches the resident one cannot hold:
// one kernel per step t from a C loop. A block owns K5_JT hidden units j of
// one direction for K5_BT batch rows: it stages hprev_t and da_w_{t+1} in
// shared memory, its K5_KW warps split the gate recompute hprev_t . U (over
// H) and the carry da_w_{t+1} . U^T (over 3H; U^T is built once per call so
// both reads are coalesced across j), and each thread finishes one (row,
// unit). dU and db_n are taken after the loop from the stored da_w and dhn,
// each output summed in a fixed order: deterministic, with no atomics and
// no library product.
#include "rnn_bwd_common.cuh"

namespace {

constexpr int K5_JT = 32;   // hidden units per block: one per lane
constexpr int K5_KW = 16;   // warps splitting each reduction
constexpr int K5_BT = 16;   // batch rows per block
constexpr int K5_THREADS = 32 * K5_KW;
static_assert(K5_BT * K5_JT == K5_THREADS, "one (row, unit) per thread");

template <typename T>
__global__ void __launch_bounds__(K5_THREADS) gru_bwd_step_kernel(
    const T* __restrict__ xp_t,       // (D, B, 3H) projections at step t
    const T* __restrict__ wh,         // (D, H, 3H) U
    const T* __restrict__ wht,        // (D, 3H, H) U transposed
    const float* __restrict__ bhn,    // (D, H) candidate bias b_n
    const T* __restrict__ hprev_t,    // (D, B, H)
    const T* __restrict__ dhs_t,      // (D, B, H)
    const T* __restrict__ daw_next,   // (D, B, 3H) da_w_{t+1}; null at T-1
    float* __restrict__ dhz,          // (D, B, H) dh*z of step t+1, then t
    T* __restrict__ dxp_t,            // (D, B, 3H)
    T* __restrict__ daw_t,            // (D, B, 3H)
    float* __restrict__ dhn_t,        // (D, B, H)
    int B, int H) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* hsh = smem;                   // (K5_BT, H) rows of hprev_t
  float* dsh = hsh + K5_BT * H;        // (K5_BT, 3H) rows of da_w_{t+1}
  float* red = dsh + K5_BT * G;        // (K5_KW, K5_BT, 3, K5_JT) partials
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * K5_BT;
  const int nb = min(K5_BT, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool has_next = daw_next != nullptr;
  for (int i = threadIdx.x; i < K5_BT * H; i += K5_THREADS) {
    const int r = i / H, k = i % H;
    hsh[i] = r < nb ? dl4ss::to_f32(hprev_t[((size_t)d * B + b0 + r) * H + k])
                    : 0.0f;
  }
  if (has_next)
    for (int i = threadIdx.x; i < K5_BT * G; i += K5_THREADS) {
      const int r = i / G, g = i % G;
      dsh[i] = r < nb
                   ? dl4ss::to_f32(daw_next[((size_t)d * B + b0 + r) * G + g])
                   : 0.0f;
    }
  __syncthreads();

  const int j = blockIdx.x * K5_JT + lane;   // this lane's unit in the loops
  {  // gate pre-activations a = hprev_t . U at columns j, H+j, 2H+j
    float acc[K5_BT][3];
#pragma unroll
    for (int r = 0; r < K5_BT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
    if (j < H) {
      const int kc = (H + K5_KW - 1) / K5_KW;
      const int k_lo = warp * kc, k_hi = min(H, k_lo + kc);
      const T* U = wh + (size_t)d * H * G;
#pragma unroll 4
      for (int k = k_lo; k < k_hi; ++k) {
        const T* Uk = U + (size_t)k * G;
        const float ur = dl4ss::to_f32(Uk[j]);
        const float uz = dl4ss::to_f32(Uk[H + j]);
        const float un = dl4ss::to_f32(Uk[2 * H + j]);
#pragma unroll
        for (int r = 0; r < K5_BT; ++r) {
          const float hk = hsh[r * H + k];
          acc[r][0] = fmaf(hk, ur, acc[r][0]);
          acc[r][1] = fmaf(hk, uz, acc[r][1]);
          acc[r][2] = fmaf(hk, un, acc[r][2]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < K5_BT; ++r)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        red[((warp * K5_BT + r) * 3 + g) * K5_JT + lane] = acc[r][g];
  }
  __syncthreads();

  // from here on thread -> (row rr, unit jo)
  const int rr = threadIdx.x / K5_JT, jj = threadIdx.x % K5_JT;
  const int jo = blockIdx.x * K5_JT + jj;
  float a[3] = {0.0f, 0.0f, 0.0f};
  for (int w = 0; w < K5_KW; ++w)
#pragma unroll
    for (int g = 0; g < 3; ++g) a[g] += red[((w * K5_BT + rr) * 3 + g) * K5_JT + jj];
  float c = 0.0f;                 // (da_w_{t+1} . U^T)[row, jo]
  if (has_next) {
    __syncthreads();              // every thread has read its partials
    float acc[K5_BT];
#pragma unroll
    for (int r = 0; r < K5_BT; ++r) acc[r] = 0.0f;
    if (j < H) {
      const int gc = (G + K5_KW - 1) / K5_KW;
      const int g_lo = warp * gc, g_hi = min(G, g_lo + gc);
      const T* Ut = wht + (size_t)d * G * H;
#pragma unroll 4
      for (int g = g_lo; g < g_hi; ++g) {
        const float u = dl4ss::to_f32(Ut[(size_t)g * H + j]);
#pragma unroll
        for (int r = 0; r < K5_BT; ++r)
          acc[r] = fmaf(dsh[r * G + g], u, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < K5_BT; ++r) red[(warp * K5_BT + r) * K5_JT + lane] = acc[r];
    __syncthreads();
    for (int w = 0; w < K5_KW; ++w) c += red[(w * K5_BT + rr) * K5_JT + jj];
  }
  if (rr >= nb || jo >= H) return;

  const size_t row = (size_t)d * B + b0 + rr;
  const T* x = xp_t + row * G;
  const float hp = hsh[rr * H + jo];
  const float r = dl4ss::sigmoid(dl4ss::to_f32(x[jo]) + a[0]);
  const float z = dl4ss::sigmoid(dl4ss::to_f32(x[H + jo]) + a[1]);
  const float hn = a[2] + bhn[(size_t)d * H + jo];
  const float n = tanhf(dl4ss::to_f32(x[2 * H + jo]) + r * hn);
  const size_t u = row * H + jo;
  const float dh = (has_next ? dhz[u] + c : 0.0f) + dl4ss::to_f32(dhs_t[u]);
  const float dn = dh * (1.0f - z);
  const float dz = dh * (hp - n);
  const float da_n = dn * (1.0f - n * n);
  const float dr = da_n * hn;
  const float dhn = da_n * r;
  const float da_z = dz * z * (1.0f - z);
  const float da_r = dr * r * (1.0f - r);
  T* dx = dxp_t + row * G;
  dl4ss::store(dx + jo, da_r);
  dl4ss::store(dx + H + jo, da_z);
  dl4ss::store(dx + 2 * H + jo, da_n);
  T* dw = daw_t + row * G;
  dl4ss::store(dw + jo, da_r);
  dl4ss::store(dw + H + jo, da_z);
  dl4ss::store(dw + 2 * H + jo, dhn);
  dhz[u] = dh * z;
  dhn_t[u] = dhn;
}

// db_n[d, j] = sum over (t, b) of dhn[t, d, b, j]: 8 warps each sum every
// eighth (t, b) for 32 units, then one warp adds the 8 partials in order.
__global__ void gru_bwd_dbn_kernel(const float* __restrict__ dhn,
                                   float* __restrict__ dbn, int steps, int D,
                                   int B, int H) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = blockIdx.y, j = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (j < H)
    for (int n = warp; n < steps * B; n += 8)
      s += dhn[(((size_t)(n / B) * D + d) * B + n % B) * H + j];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < H) {
    float total = 0.0f;
    for (int w = 0; w < 8; ++w) total += part[w][lane];
    dbn[(size_t)d * H + j] = total;
  }
}

// The resident body's cell: see the note at the top of this file.
struct GruCell {
  static constexpr int NG = 3, NC = 5;
  // one output a unit (its row of U), 3 a lane group; 2 unit warps x 8
  // column warps split G <= 960 columns, 15 a lane
  using Tiling = dl4ss::ResidentTiling<3, 1, 2, 8, 15>;
  static constexpr bool SPLIT = true;    // da_w differs from dxp (dhn / da_n)
  struct State {
    float dhz, dbn;
  };
  // e0 = b_n (D, H) f32
  template <typename T>
  __device__ static void coefficients(const float (&a)[NG], const T* x,
                                      const void* e0, const void*, size_t,
                                      int d, int j, int H, float hp,
                                      float (&out)[NC]) {
    const float r = dl4ss::sigmoid(dl4ss::to_f32(x[j]) + a[0]);
    const float z = dl4ss::sigmoid(dl4ss::to_f32(x[H + j]) + a[1]);
    const float hn = a[2] + static_cast<const float*>(e0)[(size_t)d * H + j];
    const float n = tanhf(dl4ss::to_f32(x[2 * H + j]) + r * hn);
    const float c_n = (1.0f - z) * (1.0f - n * n);
    out[0] = c_n * hn * r * (1.0f - r);
    out[1] = (hp - n) * z * (1.0f - z);
    out[2] = c_n;
    out[3] = c_n * r;
    out[4] = z;
  }
  __device__ static void step(const float (&c)[NC], float dot, float dhs,
                              State& s, float (&dx)[NG], float (&dw)[NG]) {
    const float dh = s.dhz + dot + dhs;
    dx[0] = dw[0] = dh * c[0];
    dx[1] = dw[1] = dh * c[1];
    dx[2] = dh * c[2];
    dw[2] = dh * c[3];
    s.dhz = dh * c[4];
    s.dbn += dw[2];
  }
  __device__ static float total(const State& s) { return s.dbn; }
};

template <typename T>
cudaError_t run_resident(const void* xp, const void* wh, const void* bhn,
                         const void* hprev, const void* dhs, void* dxp,
                         void* du, void* dbn, void* daw, void* work,
                         void* du_part, void* tickets, int du_parts,
                         int groups, int chunk, int steps, int D, int B,
                         int H, cudaStream_t stream) {
  const int G = 3 * H;
  // work: the coefficients (T, D, B, H, 5), then the db_n partials (B, D, H)
  float* coef = static_cast<float*>(work);
  float* sums = coef + (size_t)steps * D * B * H * GruCell::NC;
  cudaError_t err = dl4ss::coefficients<T, GruCell>(
      {xp, wh, hprev, bhn, nullptr, coef, steps, D, B, H}, stream);
  if (err != cudaSuccess) return err;
  err = dl4ss::chain<T, GruCell>(
      {wh, coef, dhs, dxp, daw, sums, static_cast<unsigned int*>(tickets),
       steps, D, B, H, 0, 0, 0}, groups, chunk, stream);
  if (err != cudaSuccess) return err;
  err = dl4ss::sum_partials(sums, static_cast<float*>(dbn), B, (size_t)D * H,
                            stream);
  if (err != cudaSuccess) return err;
  return dl4ss::weight_grad<T, 3>(static_cast<const T*>(hprev),
                                  static_cast<const T*>(daw),
                                  static_cast<float*>(du),
                                  static_cast<float*>(du_part), du_parts,
                                  steps, D, B, H, G, stream);
}

template <typename T>
cudaError_t run_stepwise(const void* xp, const void* wh, const void* bhn,
                         const void* hprev, const void* dhs, void* dxp,
                         void* du, void* dbn, void* wht, void* daw, void* dhz,
                         void* dhn, void* du_part, int du_parts, int steps,
                         int D, int B, int H, cudaStream_t stream) {
  const int G = 3 * H;
  const T* U = static_cast<const T*>(wh);
  T* Ut = static_cast<T*>(wht);
  cudaError_t err = dl4ss::transpose(U, Ut, D, H, G, stream);
  if (err != cudaSuccess) return err;

  const dim3 grid((H + K5_JT - 1) / K5_JT, D, (B + K5_BT - 1) / K5_BT);
  const size_t smem = ((size_t)K5_BT * 4 * H +
                       (size_t)K5_KW * K5_BT * 3 * K5_JT) * sizeof(float);
  err = dl4ss::allow_smem(gru_bwd_step_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(xp);
  const T* hp = static_cast<const T*>(hprev);
  const T* dh = static_cast<const T*>(dhs);
  T* dx = static_cast<T*>(dxp);
  T* dw = static_cast<T*>(daw);
  float* dn = static_cast<float*>(dhn);
  const size_t sg = (size_t)D * B * G, sh = (size_t)D * B * H;
  for (int t = steps - 1; t >= 0; --t) {
    gru_bwd_step_kernel<T><<<grid, K5_THREADS, smem, stream>>>(
        x + t * sg, U, Ut, static_cast<const float*>(bhn), hp + t * sh,
        dh + t * sh, t + 1 < steps ? dw + (t + 1) * sg : nullptr,
        static_cast<float*>(dhz), dx + t * sg, dw + t * sg, dn + t * sh, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  err = dl4ss::weight_grad<T, 3>(hp, dw, static_cast<float*>(du),
                                 static_cast<float*>(du_part), du_parts, steps,
                                 D, B, H, G, stream);
  if (err != cudaSuccess) return err;
  gru_bwd_dbn_kernel<<<dim3((H + 31) / 32, D), 256, 0, stream>>>(
      dn, static_cast<float*>(dbn), steps, D, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* xp, const void* wh, const void* bhn,
                const void* hprev, const void* dhs, void* dxp, void* du,
                void* dbn, void* wht, void* daw, void* dhz, void* work,
                void* du_part, void* tickets, int du_parts, int groups,
                int chunk, int steps, int D, int B, int H, int body,
                cudaStream_t stream) {
  if (body == dl4ss::BODY_RESIDENT)
    return run_resident<T>(xp, wh, bhn, hprev, dhs, dxp, du, dbn, daw, work,
                           du_part, tickets, du_parts, groups, chunk, steps,
                           D, B, H, stream);
  if (body == dl4ss::BODY_STEPWISE)
    return run_stepwise<T>(xp, wh, bhn, hprev, dhs, dxp, du, dbn, wht, daw,
                           dhz, work, du_part, du_parts, steps, D, B, H,
                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// xp, hprev, dhs (T, D, B, *) and wh (D, H, 3H) in f32, or all in bf16
// (bf16 != 0); bhn (D, 1, H) f32 -> dxp (T, D, B, 3H) in the input dtype,
// du (D, H, 3H) and dbn (D, 1, H) in f32. body: 1 resident, 2 stepwise; the
// resident body returns an error for a shape it cannot hold. Scratch from
// the caller, for both bodies: daw (T, D, B, 3H) in the input dtype and
// du_part (du_parts, D, H, 3H) f32. Resident: work = (T*D*B*H*5 + B*D*H) f32
// and tickets = `groups` zeroed 32-bit counters; the chain walks the batch
// in chunks of `chunk` rows (a multiple of 4), one launch each. du_parts and
// groups say what the caller allocated: a count other than the kernels' own
// (16 slabs; one group per direction and 4 batch rows) is refused with an
// error.
// Stepwise: wht (D, 3H, H) in the input dtype, dhz (D, B, H) f32 and work =
// (T, D, B, H) f32. What a body does not use may be null.
extern "C" int dl4ss_gru_bwd(const void* xp, const void* wh, const void* bhn,
                             const void* hprev, const void* dhs, void* dxp,
                             void* du, void* dbn, void* wht, void* daw,
                             void* dhz, void* work, void* du_part,
                             void* tickets, int du_parts, int groups,
                             int chunk, int steps, int D, int B, int H,
                             int bf16, int body, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(xp, wh, bhn, hprev, dhs, dxp, du, dbn, wht,
                                   daw, dhz, work, du_part, tickets, du_parts,
                                   groups, chunk, steps, D, B, H, body, s)
              : run<float>(xp, wh, bhn, hprev, dhs, dxp, du, dbn, wht, daw,
                           dhz, work, du_part, tickets, du_parts, groups,
                           chunk, steps, D, B, H, body, s);
}
