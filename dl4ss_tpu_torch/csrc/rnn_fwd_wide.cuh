// K7's wide body (lstm_fwd.cu): the BiLSTM forward recurrence for widths
// past the registers of the resident body (H > 304: the TDAA classifier's
// H = 600), in ONE persistent cooperative launch per layer for all T steps
// of both directions. It replaces no TPU kernel of its own: it is a third
// body of K7 (`_lstm_fwd_kernel`, dl4ss_tpu/ops/pallas_rnn.py), which the
// TPU ran at every width with U in VMEM.
//
// Bound on the H100: at H=600, B=16, T=313 the h . U products are 28.8
// GFLOP per layer, 0.43 ms at the f32 CUDA-core rate; the chain of 313
// dependent steps sets the time, as for the resident body
// (rnn_fwd_common.cuh). The stepwise body pays a launch, a ramp, a drain
// and one pass over U in L2 (11.5 MB for both directions) every step.
//
// Why not the resident body: it gives every barrier group (one direction
// and 4 batch rows) its own copy of U in registers, 24 units a block; at
// H=600 a unit's 4 x 600 weights no longer fit. Here U is held ONCE per
// direction, in the blocks' shared memory, and serves every batch row:
//   * a block owns UNITS hidden units of one direction for ALL B rows: its
//     slice of U (the 4 * UNITS gate columns over the H rows, 96 KB at
//     H=600) is loaded once, k-major, one float4 of a unit's four gates per
//     (k, unit). ceil(H / UNITS) blocks a direction (60 at H=600), one
//     barrier group (ticket, rnn_resident.cuh) per direction; every block
//     of the grid must be on an SM at once, or the cooperative launch is
//     refused.
//   * a step t: the owner thread of each (row, unit) loads xp[t] before the
//     wait; wait for the direction's ticket; stage h_{t-1} of all B rows
//     from L2 into shared memory (asynchronous 16-byte copies, all in
//     flight at once, for f32 rows of whole quads); the product; the gate
//     math in the owner thread, c in its register; store hs[t] and cs[t];
//     arrive.
//   * the product: B x (4 * UNITS) outputs over H. A worker thread owns a
//     register tile of TR rows x 2 units (8 gate columns) over one slice of
//     k: per 4 k, TR float4 of h and 8 float4 of U feed 32 * TR FMA. The
//     slices' sums meet in shared memory, where the staged rows were, and
//     each owner adds its (row, unit)'s in slice order.
//   * staged row b lies at (b % TR) * tiles + b / TR with an odd float4
//     stride, and a row of U holds the first units of the pairs before the
//     second ones: the lanes of a warp, which differ in (row tile, unit
//     pair, slice), then read distinct banks where they can.
// Measured on an NVIDIA H100 80GB HBM3 at B=16 (clock64 sums of block 0): a
// step is 7.2 us, the product 3.2, staging 1.7, the wait 0.8, the owners'
// sums, gate math and stores 0.8, the arrive 0.4. Tiles of 8 rows or 512
// threads were no faster at B=16 (PERF.md, the kernel table and findings).
// Shared memory: U plus the larger of the staged rows and the partial sums
// (2 * TR float4 a thread), 134 KB at H=600, B=16; the caller's rule
// (ops/rnn_kernels.py::wide_smem_bytes) mirrors the formula. The numerics
// are the resident body's: f32 inputs compute in f32; bf16 inputs stage
// the rounded bf16 h, accumulate in f32 and carry c in f32 (only the
// stored cs is rounded). Every sum runs in one fixed order with no atomics
// on data: two calls agree bit for bit.
#pragma once

#include "rnn_resident.cuh"

namespace dl4ss {

constexpr int BODY_WIDE = 3;

namespace wide {

constexpr int UNITS = 10;            // hidden units per block
constexpr int PAIRS = UNITS / 2;     // a worker's units: one pair
constexpr int TR = 4;                // rows of a worker's tile
constexpr int THREADS = 256;
constexpr int OWN = 3;               // (row, unit)s an owner thread holds
constexpr int MAX_ROWS = OWN * THREADS / UNITS;
constexpr int PART_QUADS = 2 * TR * THREADS;  // float4 of sums, at most
constexpr size_t SMEM_MAX = 232448;           // a block's opt-in limit, H100
static_assert(UNITS % 2 == 0, "a worker's units come in pairs");

struct Args {
  const void* xp;        // (T, D, B, 4H)
  const void* wh;        // (D, H, 4H)
  void* hs;              // (T, D, B, H)
  void* cs;              // (T, D, B, H)
  unsigned int* tickets; // one per direction, zero at launch
  int steps, D, B, H;
  int members;           // blocks per direction
  int slices, kquads;    // the product's k-slices, 4 * kquads rows of U each
  int stride;            // a staged row, in float4 (odd)
};

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// U (4 * ceil(H / 4) rows of UNITS float4) and the region that holds the
// staged rows (B rounded up to TR), then the partial sums
inline size_t smem_bytes(int H, int B) {
  const int kq = ceil_div(H, 4);
  return sizeof(float4) *
         ((size_t)4 * kq * UNITS +
          std::max((size_t)TR * ceil_div(B, TR) * (kq | 1),
                   (size_t)PART_QUADS));
}

__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 r = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Elements k .. k + 3 of a row of n that another block of the launch
// wrote, 0 past n; one 8-byte L2 load for bf16 where `whole` (n a multiple
// of 4, so the quad is aligned). f32 rows of whole quads are copied
// asynchronously instead (`stage`).
template <typename T>
__device__ __forceinline__ float4 row_quad(const T* row, int k, int n,
                                           bool whole) {
  if constexpr (sizeof(T) == 2)
    if (whole && k < n) return load_quad(row + k);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = k + e < n ? load_shared_result(row + k + e) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// 16 bytes from L2 straight into shared memory, zeros where not `live`
__device__ __forceinline__ void copy_quad_async(float4* dst, const float* src,
                                                bool live) {
  const unsigned int to =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// Stage rows 0 .. B - 1 of h_{t-1} (src: B rows of H) into the tiles * TR
// staged rows, row b at (b % TR) * tiles + b / TR, zeros past B and past
// H. f32 rows of whole quads go by asynchronous copies, every quad of the
// block in flight at once; other rows through registers, 8 loads a thread
// in flight. Ends with the block's barrier.
template <typename T>
__device__ __forceinline__ void stage(float4* h_s, const T* src, int B, int H,
                                      int tiles, int stride) {
  const int n = TR * tiles * stride;
  const bool whole = H % 4 == 0;
  auto slot = [&](int b) {
    return (size_t)(b % TR * tiles + b / TR) * stride;
  };
  if (sizeof(T) == sizeof(float) && whole) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int b = i / stride, kq = i % stride;
      const bool live = b < B && 4 * kq < H;
      copy_quad_async(h_s + slot(b) + kq,
                      reinterpret_cast<const float*>(src) +
                          (live ? (size_t)b * H + 4 * kq : 0),
                      live);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    return;
  }
  constexpr int BATCH = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * THREADS) {
    float4 v[BATCH];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int i = i0 + e * THREADS, b = i / stride, kq = i % stride;
      v[e] = i < n && b < B ? row_quad(src + (size_t)b * H, 4 * kq, H, whole)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int i = i0 + e * THREADS, b = i / stride, kq = i % stride;
      if (i < n) h_s[slot(b) + kq] = v[e];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float part_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The same name as the resident chain (rnn_fwd_common.cuh) in a namespace
// of its own: a trace counts both as the recurrences' chain kernels.
template <typename T, typename Cell>
__global__ void __launch_bounds__(THREADS, 1) rnn_fwd_chain_kernel(Args p) {
  static_assert(Cell::NG == 4, "a unit's gates are one float4");
  extern __shared__ float4 smem[];
  const int H = p.H, G = 4 * H, B = p.B, D = p.D;
  const int kq_all = ceil_div(H, 4), tiles = ceil_div(B, TR);
  const int rows = TR * tiles;
  const int d = blockIdx.x / p.members;
  const int j0 = (blockIdx.x % p.members) * UNITS;
  unsigned int* ticket = p.tickets + d;
  float4* u_s = smem;                                 // (4 kq_all, UNITS)
  float4* h_s = smem + (size_t)4 * kq_all * UNITS;    // rows, then sums

  // U[k][g * H + j] of the block's units, slot = (u % 2) * PAIRS + u / 2
  {
    const T* U = static_cast<const T*>(p.wh) + (size_t)d * H * G;
    for (int i = threadIdx.x; i < 4 * kq_all * UNITS; i += THREADS) {
      const int k = i / UNITS, slot = i % UNITS;
      const int j = j0 + 2 * (slot % PAIRS) + slot / PAIRS;
      float v[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        v[g] = k < H && j < H ? to_f32(U[(size_t)k * G + g * H + j]) : 0.0f;
      u_s[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  // the worker's tile: rows q * TR .. + TR - 1, units 2 pair and 2 pair + 1
  // of the block, k quads kq0 .. kq1 - 1 (none past the last slice)
  const int work = tiles * PAIRS;
  const int q = threadIdx.x % work / PAIRS, pair = threadIdx.x % PAIRS;
  const int slice = threadIdx.x / work, kq0 = slice * p.kquads;
  const int kq1 = slice < p.slices ? min(kq_all, kq0 + p.kquads) : kq0;

  // the owner's (row, unit)s: threadIdx.x + o * THREADS, units fastest
  typename Cell::State state[OWN];
  int ob[OWN], ou[OWN];
  bool own[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int i = threadIdx.x + o * THREADS;
    ob[o] = i / UNITS;
    ou[o] = i % UNITS;
    own[o] = ob[o] < B && j0 + ou[o] < H;
    state[o] = own[o] ? Cell::init(nullptr, d, j0 + ou[o], H)
                      : typename Cell::State{};
  }
  const T* xp = static_cast<const T*>(p.xp);
  T* hs = static_cast<T*>(p.hs);
  T* cs = static_cast<T*>(p.cs);
  const size_t step_rows = (size_t)D * B;

  for (int t = 0; t < p.steps; ++t) {
    const size_t row0 = (size_t)t * step_rows + (size_t)d * B;
    float x[OWN][4];
#pragma unroll
    for (int o = 0; o < OWN; ++o)
      if (own[o]) {     // independent of the chain: in flight over the wait
#pragma unroll
        for (int g = 0; g < 4; ++g)
          x[o][g] = to_f32(xp[(row0 + ob[o]) * G + g * H + j0 + ou[o]]);
      }
    float a[OWN][4] = {};
    if (t > 0) {
      group_wait(ticket, (unsigned int)p.members * t);
      stage(h_s, hs + (row0 - step_rows) * H, B, H, tiles, p.stride);
      float acc[TR][8] = {};
      const float4* hq = h_s + (size_t)q * p.stride;
      const size_t rstride = (size_t)tiles * p.stride;
#pragma unroll 2
      for (int kq = kq0; kq < kq1; ++kq) {
        float4 hv[TR];
#pragma unroll
        for (int r = 0; r < TR; ++r) hv[r] = hq[r * rstride + kq];
        const float4* uk = u_s + (size_t)4 * kq * UNITS + pair;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 u0 = uk[i * UNITS], u1 = uk[i * UNITS + PAIRS];
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            const float h = part_of(hv[r], i);
            acc[r][0] = fmaf(h, u0.x, acc[r][0]);
            acc[r][1] = fmaf(h, u0.y, acc[r][1]);
            acc[r][2] = fmaf(h, u0.z, acc[r][2]);
            acc[r][3] = fmaf(h, u0.w, acc[r][3]);
            acc[r][4] = fmaf(h, u1.x, acc[r][4]);
            acc[r][5] = fmaf(h, u1.y, acc[r][5]);
            acc[r][6] = fmaf(h, u1.z, acc[r][6]);
            acc[r][7] = fmaf(h, u1.w, acc[r][7]);
          }
        }
      }
      __syncthreads();  // the staged rows are read: the sums take their place
      if (kq1 > kq0) {
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            h_s[((size_t)slice * rows + TR * q + r) * UNITS + 2 * pair +
                half] = make_float4(acc[r][4 * half], acc[r][4 * half + 1],
                                    acc[r][4 * half + 2],
                                    acc[r][4 * half + 3]);
      }
      __syncthreads();
#pragma unroll
      for (int o = 0; o < OWN; ++o)
        if (own[o]) {   // the slices' sums, in order
          const float4* sums = h_s + (size_t)ob[o] * UNITS + ou[o];
#pragma unroll 4
          for (int s = 0; s < p.slices; ++s) {
            const float4 v = sums[(size_t)s * rows * UNITS];
            a[o][0] += v.x;
            a[o][1] += v.y;
            a[o][2] += v.z;
            a[o][3] += v.w;
          }
        }
    }
#pragma unroll
    for (int o = 0; o < OWN; ++o)
      if (own[o]) {
        float c_out;
        const float h = Cell::step(x[o], a[o], 0.0f, state[o], c_out);
        const size_t at = (row0 + ob[o]) * H + j0 + ou[o];
        store(hs + at, h);
        store(cs + at, c_out);
      }
    if (t + 1 < p.steps) group_arrive(ticket);
  }
}

// One cooperative launch of D * ceil(H / UNITS) blocks for the whole call.
// Refused before anything is launched: a ticket count other than D, a
// batch past the owners (MAX_ROWS) or a block past the shared memory; by
// the runtime: a grid that is not all on the card at once
// (cudaErrorCooperativeLaunchTooLarge).
template <typename T, typename Cell>
inline cudaError_t fwd_chain(Args p, int groups, cudaStream_t stream) {
  if (groups != p.D || p.D < 1 || p.B < 1 || p.B > MAX_ROWS || p.H < 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.H, p.B);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const int kq_all = ceil_div(p.H, 4);
  const int most = THREADS / (ceil_div(p.B, TR) * PAIRS);
  p.members = ceil_div(p.H, UNITS);
  p.kquads = ceil_div(kq_all, most);
  p.slices = ceil_div(kq_all, p.kquads);
  p.stride = kq_all | 1;
  const auto kernel = rnn_fwd_chain_kernel<T, Cell>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return reported(err);
  void* args[] = {&p};
  return reported(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(p.D * p.members), dim3(THREADS),
      args, smem, stream));
}

}  // namespace wide
}  // namespace dl4ss
