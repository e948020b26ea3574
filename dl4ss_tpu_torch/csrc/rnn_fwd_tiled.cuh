// The tiled body of the recurrent forwards K2 (gru_fwd.cu) and K7
// (lstm_fwd.cu): ONE persistent launch per layer (per chunk of batch rows)
// for all T steps of both directions, for the batches past the resident
// body (B > 40 at H=300; K7 from B=52). It takes the place of the stepwise
// body there, which launched a kernel per step and re-read U from L2 in
// every one.
//
// Bound on the H100: at B=256, H=300, T=313 a GRU layer's h . U products
// are 2 directions x 313 steps x 2 * 256 * 300 * 900 = 86.5 GFLOP, 1.29 ms
// at the f32 FFMA rate (67 TFLOP/s); the LSTM's 4H columns make it 115
// GFLOP, 1.72 ms. At this batch a step is 2.2 MFLOP an SM and bound by the
// arithmetic, not by the chain's latency as at B <= 40: the resident and
// cluster bodies, which hold U in registers and read h once per FMA, scale
// linearly in B there. Here the product is a register-tiled matrix product
// that reuses each h value across units and each U value across rows.
//
// Tiling. A barrier group is (direction, tile of ROWS = 32 batch rows); its
// ceil(H / UNITS) blocks (8 at H=300) split the hidden units, UNITS = 40 a
// block, and each block takes the NG gate columns of its units. A block
// holds its U, NG * UNITS columns over the H rows (145 KB for the GRU and
// 193 KB for the LSTM at H=300), in shared memory for the whole launch, so
// U is read from L2 once per launch; with 2 * 8 groups of 8 blocks B=256
// is one launch of 128 blocks on the 132 SMs. A step computes the block's
// ROWS x (NG * UNITS) outputs over the H columns of h_{t-1}:
//   * warp p owns the block's units 5p .. 5p + 4, all NG gate columns of
//     each; its lanes are 8 row quads q x 4 k slices s. A lane holds a
//     register tile of 4 rows x 5 units x NG gates (60 sums for the GRU, 80
//     for the LSTM) over the k quads s, s + 4, s + 8, ...: per 4 k it reads
//     4 float4 of h (its 4 rows) and 5 * NG float4 of U (its columns), and
//     makes 80 * NG FMAs. The lanes of a warp read 4 distinct float4 of U
//     (one per slice, in distinct banks: U's rows lie an odd number of
//     float4 apart) and 32 of h (h rows too).
//   * the 4 slices' sums meet by two xor shuffles, each halving the tile, so
//     that lane (q, s) ends with row 4q + s of its 5 units' NG gates, in a
//     fixed order; it runs the cell's gate math (`Cell::step`, as in the
//     other bodies) for those 5 (row, unit)s in registers and stores h_t.
// Products and sums stay f32 on the CUDA cores: no TF32.
//
// The exchange of h_t within a group: the group's blocks meet at a ticket
// in device memory (rnn_resident.cuh's `group_arrive` / `group_wait`), then
// each stages the group's 32 rows of h_{t-1} from L2. f32 rows of whole
// quads are copied with `cp.async` in two ranges of k (the first FIRST = 8
// quads, then the rest), one commit group each, and the product starts on
// the first as soon as it has landed, so that the copy of the rest
// overlaps it (faster than 1, 2 equal, 3 or 4 ranges on the H100). Every
// block of the launch must be resident at once: a cooperative launch,
// refused otherwise. (One thread-block cluster per group, h_t pushed with
// `st.async` as in rnn_fwd_common.cuh's cluster body, was measured as no
// faster: 3.84 against 3.69 ms a layer at B=32, and it fits only the GRU.)
// Measured on an NVIDIA H100 80GB HBM3 (clock64 sums of block 0, f32, H=300,
// B=256): a step is ~24,800 SM cycles, 13 us: the product with
// the staging 16,100 (the FFMAs alone would take 9,100 at one warp
// instruction a cycle; with two warps a scheduler the loads' latency is
// not hidden), the wait 2,900, the arrive 2,500, the gate math 2,100, the
// shuffles 1,000. 3.95 ms a layer against the stepwise body's 10.36.
// Each output is summed in one fixed order: two calls agree bit for bit.
// The numerics are the other bodies': f32 inputs compute in
// f32; bf16 inputs carry h in bf16 (the exchanged and staged h is the
// rounded one, which the GRU's z * h term also uses), accumulate in f32 and
// carry the LSTM's c in f32. U is held in f32 for both.
#pragma once

#include "rnn_fwd_common.cuh"

namespace dl4ss {

constexpr int BODY_TILED = 5;

namespace tiled {

constexpr int ROWS = 32;        // batch rows per barrier group
constexpr int UNITS = 40;       // hidden units per block
constexpr int TU = 5;           // units of a lane's tile
constexpr int TR = 4;           // rows of a lane's tile
constexpr int SLICES = 4;       // lanes that split k (interleaved quads)
constexpr int THREADS = 32 * UNITS / TU;
constexpr int FIRST = 8;        // k quads the ticket body stages first
constexpr size_t SMEM_MAX = 232448;   // a block's opt-in limit, H100
static_assert((ROWS / TR) * SLICES == 32, "a warp: row quads x slices");
static_assert(TR == SLICES, "the halving leaves lane s with row s");
static_assert(UNITS % 4 == 0, "a block's units start on a float4 of h");

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Shared memory of a block, in bytes: U (ceil(H / 4) rows of NG * UNITS + 1
// float4: an odd stride, so the 4 slices' rows lie in distinct banks) and
// one 32-row buffer of h whose rows are ceil(H / 4) | 1 float4 apart.
inline size_t smem_bytes(int NG, int H) {
  const size_t kq = ceil_div(H, 4);
  return sizeof(float4) * ((NG * UNITS + 1) * kq + ROWS * (kq | 1));
}

// wait until at most n of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void copies_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, typename Cell>
__global__ void __launch_bounds__(THREADS, 1) rnn_fwd_chain_kernel(FwdArgs p) {
  constexpr int NG = Cell::NG, NC = TU * NG, UROW = NG * UNITS + 1;
  extern __shared__ float4 smem[];
  const int H = p.H, G = NG * H, B = p.B, D = p.D;
  const int kq_all = ceil_div(H, 4), hstride = kq_all | 1;
  const int group = blockIdx.x / p.members, member = blockIdx.x % p.members;
  const int tiles = ceil_div(p.rows, ROWS);
  const int d = group / tiles, b0 = p.row0 + (group % tiles) * ROWS;
  const int j0 = member * UNITS;           // the block's first unit
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane / SLICES, s = lane % SLICES;
  float4* u_s = smem;                                  // (kq, UROW)
  float4* h_s = u_s + (size_t)UROW * kq_all;           // (ROWS, hstride)
  unsigned int* ticket = p.tickets + group;

  // row kq, column u * NG + g of the block: U[4 kq .. 4 kq + 3, g * H + j0
  // + u] as one float4; consecutive threads read consecutive columns
  {
    const T* U = static_cast<const T*>(p.wh) + (size_t)d * H * G;
    for (int i = threadIdx.x; i < NG * UNITS * kq_all; i += THREADS) {
      const int col = i % (NG * UNITS), kq = i / (NG * UNITS);
      const int j = j0 + col / NG, g = col % NG;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kq + e;
        v[e] = j < H && k < H ? to_f32(U[(size_t)k * G + g * H + j]) : 0.0f;
      }
      u_s[(size_t)kq * UROW + col] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  // the lane's (row, unit)s once the slices are summed: row 4q + s of the
  // tile, units 5 * warp .. + 4 of the block
  const int rl = TR * q + s, ul = TU * warp;
  const int b = b0 + rl;
  bool own[TU];
  typename Cell::State state[TU];
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    own[u] = b < p.row0 + p.rows && j0 + ul + u < H;
    state[u] = own[u] ? Cell::init(p.bias, d, j0 + ul + u, H)
                      : typename Cell::State{};
  }
  const T* xp = static_cast<const T*>(p.xp);
  T* hs = static_cast<T*>(p.hs);
  T* cs = static_cast<T*>(p.cs);
  const size_t step_rows = (size_t)D * B;
  __syncthreads();           // U is in place

  // f32 rows of whole quads go by cp.async in two ranges of k,
  // the first FIRST quads and the rest, so that the product starts on the
  // first while the rest lands (a multiple of 4: the lanes' quads stay s
  // mod 4)
  static_assert(FIRST % SLICES == 0, "a range starts on slice 0's quad");
  const bool async_rows = sizeof(T) == sizeof(float) && H % 4 == 0;
  constexpr int STAGERS = THREADS / ROWS;   // threads that stage one row
  const int stage_row = threadIdx.x / STAGERS;
  const int stage_quad = threadIdx.x % STAGERS;
  const int edge = min(FIRST, kq_all);

  for (int t = 0; t < p.steps; ++t) {
    const size_t row = (size_t)t * step_rows + (size_t)d * B + b;
    float x[TU][NG];
#pragma unroll
    for (int u = 0; u < TU; ++u)
      if (own[u]) {     // independent of the chain: in flight over the wait
#pragma unroll
        for (int g = 0; g < NG; ++g)
          x[u][g] = to_f32(xp[row * G + g * H + j0 + ul + u]);
      }
    float a[NC] = {};
    float hp[TU] = {};
    if (t > 0) {
      float acc[TR][NC] = {};
      // the product over k quads [lo, hi): this lane's are lo + s, + 4, ...
      auto product = [&](int lo, int hi) {
        const float4* hq = h_s + (size_t)TR * q * hstride;
#pragma unroll 1
        for (int kq = lo + s; kq < hi; kq += SLICES) {
          float4 hv[TR];
#pragma unroll
          for (int r = 0; r < TR; ++r) hv[r] = hq[(size_t)r * hstride + kq];
          const float4* uq = u_s + (size_t)kq * UROW + ul * NG;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 u = uq[c];
#pragma unroll
            for (int r = 0; r < TR; ++r) {
              acc[r][c] = fmaf(hv[r].x, u.x, acc[r][c]);
              acc[r][c] = fmaf(hv[r].y, u.y, acc[r][c]);
              acc[r][c] = fmaf(hv[r].z, u.z, acc[r][c]);
              acc[r][c] = fmaf(hv[r].w, u.w, acc[r][c]);
            }
          }
        }
      };
      group_wait(ticket, (unsigned int)p.members * t);
      const T* src = hs + ((size_t)(t - 1) * step_rows + (size_t)d * B +
                           b0) * H;
      // thread i stages row i / STAGERS, k quads i % STAGERS + STAGERS j
      const bool live = b0 + stage_row < p.row0 + p.rows;
      const T* from = src + (live ? (size_t)stage_row * H : 0);
      float4* dst = h_s + (size_t)stage_row * hstride;
      if (async_rows) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int hi = c ? kq_all : edge;
          for (int kq = (c ? edge : 0) + stage_quad; kq < hi;
               kq += STAGERS) {
            const unsigned int to = static_cast<unsigned int>(
                __cvta_generic_to_shared(dst + kq));
            asm volatile(
                "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                "l"(reinterpret_cast<const float*>(from) +
                    (live ? 4 * kq : 0)),
                "r"(live ? 16 : 0)
                : "memory");
          }
          copies_commit();
        }
        copies_pending<1>();
        __syncthreads();
        product(0, edge);
        copies_pending<0>();
        __syncthreads();
        product(edge, kq_all);
      } else {
        for (int kq = stage_quad; kq < kq_all; kq += STAGERS) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = live && 4 * kq + e < H
                       ? load_shared_result(from + 4 * kq + e)
                       : 0.0f;
          dst[kq] = make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();
        product(0, kq_all);
      }
      // h_{t-1} at the lane's own (row, unit)s, for the GRU's z * h
      const float* hrow =
          reinterpret_cast<const float*>(h_s + (size_t)rl * hstride);
#pragma unroll
      for (int u = 0; u < TU; ++u)
        hp[u] = j0 + ul + u < H ? hrow[j0 + ul + u] : 0.0f;
      // the slices' sums: xor 2 keeps rows {0, 1} or {2, 3}, xor 1 one of
      // the two, so lane s ends with row s of its quad
      const bool hi2 = s & 2, hi1 = s & 1;
      float half[2][NC];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float keep = hi2 ? acc[r + 2][c] : acc[r][c];
          const float give = hi2 ? acc[r][c] : acc[r + 2][c];
          half[r][c] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
        }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float keep = hi1 ? half[1][c] : half[0][c];
        const float give = hi1 ? half[0][c] : half[1][c];
        a[c] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      if (!own[u]) continue;
      float c_out;
      float au[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) au[g] = a[u * NG + g];
      const float h = Cell::step(x[u], au, hp[u], state[u], c_out);
      store(hs + row * H + j0 + ul + u, h);
      if (Cell::CELL_OUT) store(cs + row * H + j0 + ul + u, c_out);
    }
    if (t + 1 < p.steps) group_arrive(ticket);
  }
}

// The whole batch in chunks of `chunk` rows (a multiple of ROWS), one
// cooperative launch of D * ceil(rows / 32) groups of ceil(H / UNITS)
// blocks each, in order; a chunk takes D * ceil(rows / 32) of the `groups`
// zeroed tickets, and `groups` must be D * ceil(B / 32). Refused before
// anything is launched: another count or chunk, a width past 8 blocks a
// group or a block past the shared memory.
template <typename T, typename Cell>
inline cudaError_t fwd_tiled(FwdArgs p, int groups, int chunk,
                             cudaStream_t stream) {
  if (p.H < 1 || p.H > 8 * UNITS || p.B < 1 || p.D < 1 || chunk <= 0 ||
      chunk % ROWS != 0 || groups != p.D * ceil_div(p.B, ROWS))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Cell::NG, p.H);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const auto kernel = rnn_fwd_chain_kernel<T, Cell>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return reported(err);
  p.members = ceil_div(p.H, UNITS);
  for (int row0 = 0; row0 < p.B; row0 += chunk) {
    FwdArgs q = p;
    q.row0 = row0;
    q.rows = std::min(chunk, p.B - row0);
    void* args[] = {&q};
    err = reported(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(kernel),
        dim3(q.D * ceil_div(q.rows, ROWS) * q.members), dim3(THREADS), args,
        smem, stream));
    if (err != cudaSuccess) return err;
    p.tickets += p.D * ceil_div(q.rows, ROWS);
  }
  return cudaSuccess;
}

}  // namespace tiled
}  // namespace dl4ss
