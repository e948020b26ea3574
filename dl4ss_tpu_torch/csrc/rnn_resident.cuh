// Parts of a persistent recurrent kernel on the H100: one launch runs every
// time step, with its slice of the recurrent weights resident on the SM.
//
// A recurrence of T dependent steps is bound on this card by what one step
// costs in latency, not by its operations: a launch per step pays a launch,
// a ramp and a drain, and every block re-reads the weights from L2 in every
// step because nothing stays on the SM when the block ends. The parts here
// let one launch walk all steps instead:
//
//   * `resident_load` / `resident_dot`: a block owns RES_UNITS hidden units
//     of one direction and holds the weights of their outputs in REGISTERS
//     for the whole launch, so a step reads no weight from any memory. An
//     output is one sum over a vector of `ncols` columns. A warp is four
//     groups of eight lanes; a group owns UW outputs (the cell's
//     ResidentTiling says which), and its eight lanes, together with the
//     same group of the block's other KS - 1 column warps, split the columns
//     (lane c of column warp ks holds columns c + 8 * (i * KS + ks): UW *
//     MAXI floats a thread). The step's input vector is staged in shared memory as one
//     float4 of the RES_BT batch rows per column, so the eight lanes of a
//     group read eight neighbouring float4 in one 128-byte access and the
//     four groups read the same ones. A fixed xor butterfly adds the eight
//     lanes and the caller adds the KS column warps in order, so each sum
//     has one fixed order: deterministic, no atomics on data.
//   * `group_arrive` / `group_wait`: the ticket barrier between steps. The
//     blocks that share a chain (one direction, one tile of RES_BT batch
//     rows) form a group; groups never wait on each other. The ticket is a
//     monotonic counter in device memory, zeroed by the caller before the
//     launch: arrive adds one after the block's stores, wait spins with an
//     acquire load until `members * phase` tickets are in. It needs every
//     block of the grid resident at once, so the kernel is launched with
//     cudaLaunchCooperativeKernel, which refuses a grid that is not.
//     A value another block wrote in the same launch is read with
//     `load_shared_result` (an L2 load: L1 may hold a stale line).
//   * `Inbox`, `cluster_send`, `cluster_sync`: the other way to pass a
//     group's vector on, where the group is one thread-block cluster (the
//     forward's cluster body, rnn_fwd_common.cuh). A block pushes its part
//     of the vector into every member's shared memory with `st.async`,
//     whose arrival completes a transaction on the member's `mbarrier`; the
//     member waits on its own barrier and reads the vector from its own
//     shared memory. No step goes through L2 and no block waits for more
//     than the bytes it needs. Only a cluster's blocks must be co-resident,
//     which the hardware guarantees for every cluster it launches.
//   * `tile_product` / `tile_mac`: a 64 x (NG * 32) register-tiled f32
//     matrix product through shared memory (8 x NG outputs a thread, the A
//     operand read as two 16-byte broadcasts, the next slice's loads in
//     flight while this one is multiplied), for the work that is off the
//     chain and can run for all steps at once. Full f32 on the CUDA cores:
//     the 1e-4 bar of the f32 kernels rules TF32 out.
//
// Nothing here names a forward or a backward pass. The backward chain
// (rnn_bwd_common.cuh) gives each hidden unit ONE output, its row of U over
// the G = NG * H columns of da; the forward chain (rnn_fwd_common.cuh) gives
// each unit NG outputs, its gate columns of U over the H columns of h. The
// two split a block's slice the same size, differently: `ResidentTiling`.
#pragma once

#include "dl4ss_common.cuh"

namespace dl4ss {

// The body an entry point is told to run (ops/rnn_kernels.py names it).
constexpr int BODY_RESIDENT = 1, BODY_STEPWISE = 2;

constexpr int RES_LANES = 8;     // lanes that split an output's columns
constexpr int RES_UNITS = 24;    // hidden units per block, both passes
constexpr int RES_BT = 4;        // batch rows per barrier group (a float4)

// How a block splits the weights of its UNITS hidden units (RES_UNITS but
// in the forward's cluster body, whose blocks may hold more): each unit has
// OUTS outputs (output o of the block is output o % OUTS of unit o / OUTS),
// a lane group owns UW consecutive outputs, a warp four lane groups, UWARPS
// unit warps cover the block's outputs, and KS column warps split the
// columns, MAXI a lane: UW * MAXI floats a thread, up to COLS columns. The
// lane groups' SLOTS outputs may run past OUTPUTS in the last unit warp
// (a width the factors of OUTPUTS cannot give): those slots hold zeros.
template <int UW_, int OUTS_, int UWARPS_, int KS_, int MAXI_,
          int UNITS_ = RES_UNITS>
struct ResidentTiling {
  static constexpr int UW = UW_, OUTS = OUTS_, UWARPS = UWARPS_;
  static constexpr int KS = KS_, MAXI = MAXI_, UNITS = UNITS_;
  static constexpr int OUTPUTS = UNITS * OUTS;
  static constexpr int THREADS = 32 * UWARPS * KS;
  static constexpr int COLS = RES_LANES * MAXI * KS;
  static constexpr int SLOTS = UWARPS * (32 / RES_LANES) * UW;
  static_assert(SLOTS >= OUTPUTS && SLOTS - OUTPUTS < (32 / RES_LANES) * UW,
                "the lane groups cover the block's outputs once, and every "
                "unit warp holds some");
  // the first output (within the block) of this thread's lane group
  __device__ static int lane_output(int warp, int lane) {
    return ((warp % UWARPS) * (32 / RES_LANES) + lane / RES_LANES) * UW;
  }
  __device__ static int column_warp(int warp) { return warp / UWARPS; }
};

// ---- the barrier of one group of blocks -----------------------------------

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Every thread of the block calls it after its stores of the step.
__device__ __forceinline__ void group_arrive(unsigned int* ticket) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();             // the block's stores before the ticket
    atomicAdd(ticket, 1u);
  }
}

// Returns once `target` tickets are in: every member's stores of the phase
// are then visible to L2 loads of any thread of this block.
__device__ __forceinline__ void group_wait(const unsigned int* ticket,
                                           unsigned int target) {
  if (threadIdx.x == 0) {
    while (load_acquire(ticket) < target) {
    }
  }
  __syncthreads();
}

// ---- the exchange of one cluster ------------------------------------------

// A block's arrival barrier for one vector: an mbarrier in its shared memory
// whose phase completes once its own thread has armed it with the bytes to
// expect (`inbox_expect`) and the members' `cluster_send`s have delivered
// them. The bytes may land before the arming: the transaction count then
// runs below zero, and the phase still waits for the arming's arrival.
struct alignas(8) Inbox {
  unsigned long long bar;
};

__device__ __forceinline__ unsigned int shared_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// The address of `p` (this block's shared memory) in member `rank`'s.
__device__ __forceinline__ unsigned int member_addr(const void* p,
                                                    unsigned int rank) {
  unsigned int out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(shared_addr(p)), "r"(rank));
  return out;
}

// One thread, once, before `cluster_sync` makes it visible to the members.
__device__ __forceinline__ void inbox_init(Inbox* in) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(shared_addr(&in->bar)) : "memory");
}
__device__ __forceinline__ void inbox_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread of the receiving block, once per phase, after the phase before
// has completed.
__device__ __forceinline__ void inbox_expect(Inbox* in, unsigned int bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
      :: "r"(shared_addr(&in->bar)), "r"(bytes) : "memory");
}

// Every thread that reads the vector: returns once the phase of `parity`
// has completed, the members' bytes then visible to the caller.
__device__ __forceinline__ void inbox_wait(Inbox* in, unsigned int parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0],"
      " %1;\n"
      " @!done bra WAIT;\n}"
      :: "r"(shared_addr(&in->bar)), "r"(parity) : "memory");
}

// Store v at `dst` (this block's shared memory) in member `rank`, and count
// its 16 bytes on that member's `in`.
__device__ __forceinline__ void cluster_send(float4* dst, float4 v, Inbox* in,
                                             unsigned int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(member_addr(dst, rank)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
         "r"(member_addr(&in->bar, rank))
      : "memory");
}

// The cluster's own barrier: every thread of every member.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A value that another block of the launch wrote: read at L2, never L1.
__device__ __forceinline__ float load_shared_result(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float load_shared_result(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// ---- the resident slice ---------------------------------------------------

// w[u][i] = fetch(u, col) for the column col = c + 8 * (i * KS + ks) of
// output u of this lane group, 0 past `ncols`; fetch returns 0 for an output
// past the layer's edge. c is the lane within its group of eight, ks the
// column warp.
template <int UW, int MAXI, int KS, typename F>
__device__ __forceinline__ void resident_load(float (&w)[UW][MAXI], F fetch,
                                              int ncols, int c, int ks) {
#pragma unroll
  for (int u = 0; u < UW; ++u)
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int col = c + RES_LANES * (i * KS + ks);
      w[u][i] = col < ncols ? fetch(u, col) : 0.0f;
    }
}

// acc[u][b] = sum over the columns g of this lane group and column warp of
// vec[g][b] * w[u][g], for the group's UW outputs and the barrier group's
// RES_BT rows; vec holds one float4 of the rows per column, in shared
// memory. The eight lanes of the group return the same sums.
template <int UW, int MAXI, int KS>
__device__ __forceinline__ void resident_dot(const float (&w)[UW][MAXI],
                                             const float4* vec, int ncols,
                                             int c, int ks,
                                             float (&acc)[UW][RES_BT]) {
#pragma unroll
  for (int u = 0; u < UW; ++u)
#pragma unroll
    for (int b = 0; b < RES_BT; ++b) acc[u][b] = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    const int g0 = RES_LANES * (i * KS + ks);
    if (g0 < ncols) {
      const float4 v = vec[min(g0 + c, ncols - 1)];  // w is 0 past ncols
#pragma unroll
      for (int u = 0; u < UW; ++u) {
        acc[u][0] = fmaf(v.x, w[u][i], acc[u][0]);
        acc[u][1] = fmaf(v.y, w[u][i], acc[u][1]);
        acc[u][2] = fmaf(v.z, w[u][i], acc[u][2]);
        acc[u][3] = fmaf(v.w, w[u][i], acc[u][3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UW; ++u)
#pragma unroll
    for (int b = 0; b < RES_BT; ++b)
#pragma unroll
      for (int off = RES_LANES / 2; off > 0; off >>= 1)
        acc[u][b] += __shfl_xor_sync(0xffffffffu, acc[u][b], off);
}
static_assert(RES_BT == 4, "the staged vector is one float4 per column");

// Stage rows b0 .. b0 + RES_BT - 1 of a (rows, n) array that other blocks
// of the launch wrote, as one float4 per column, into vec[0 .. n): two
// columns a thread per turn, RES_BT L2 loads each, all in flight before the
// first is used. Rows at or past `rows` read as 0. Ends with the block's
// barrier.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_rows(float4* vec, const T* src,
                                           size_t stride, int n, int b0,
                                           int rows) {
  for (int g = threadIdx.x; g < n; g += 2 * THREADS) {
    float v[2][RES_BT];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < RES_BT; ++r)
        v[h][r] = g + h * THREADS < n && b0 + r < rows
                      ? load_shared_result(src + (size_t)r * stride + g +
                                           h * THREADS)
                      : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (g + h * THREADS < n)
        vec[g + h * THREADS] = make_float4(v[h][0], v[h][1], v[h][2], v[h][3]);
  }
  __syncthreads();
}

// A cooperative launch needs every block of the grid on the card at once.
// A call that walks the batch in chunks of `chunk` rows (a multiple of
// RES_BT) makes one launch per chunk, each with its own D * tiles tickets,
// in order, from `tickets`: `groups` is the count the caller zeroed, and any
// count or chunk other than these is refused before anything is launched.
// launch(row0, rows, tickets) makes the chunk's launch.
template <typename L>
inline cudaError_t chunked(int D, int B, int chunk, int groups,
                           unsigned int* tickets, L launch) {
  if (chunk <= 0 || chunk % RES_BT != 0 ||
      groups != D * ((B + RES_BT - 1) / RES_BT))
    return cudaErrorInvalidValue;
  for (int row0 = 0; row0 < B; row0 += chunk) {
    const int rows = std::min(chunk, B - row0);
    const cudaError_t err = launch(row0, rows, tickets);
    if (err != cudaSuccess) return err;
    tickets += D * ((rows + RES_BT - 1) / RES_BT);
  }
  return cudaSuccess;
}

// A launch call's own error also stays behind as the runtime's last error:
// clear it, so that the next entry point's cudaGetLastError() does not
// report a launch that this one already refused.
inline cudaError_t reported(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// ---- the off-chain product tile -------------------------------------------

constexpr int TILE_M = 64;      // rows of the output tile
constexpr int TILE_K = 16;      // slice of the inner axis staged at a time
constexpr int TILE_LD = 68;     // padded row of the A stage (16-byte rows)
constexpr int TILE_THREADS = 256;

// acc[i][g] += sum over kk of as[kk][ty * 8 + i] * bs[kk][g * 32 + tx]:
// thread (ty, tx) owns rows ty * 8 .. + 7 and columns g * 32 + tx of a
// TILE_M x (NG * 32) tile.
template <int NG>
__device__ __forceinline__ void tile_mac(const float (*as)[TILE_LD],
                                         const float (*bs)[NG * 32],
                                         float (&acc)[8][NG], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < TILE_K; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 8]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * 8 + 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) bv[g] = bs[kk][g * 32 + tx];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[i][g] = fmaf(av[i], bv[g], acc[i][g]);
  }
}

// The whole product of one tile: acc += sum over `slices` slices of TILE_K
// of A . B, with fetch_a(s, kk, m) and fetch_b(s, kk, c) the operands'
// elements in device memory (0 past an edge). The next slice's elements are
// loaded into registers while this one is multiplied, so the loads' latency
// hides behind the arithmetic. A_KMAJOR says which way a thread's A elements
// run (kk fastest, or m fastest): the way that is contiguous in memory.
// prepare(s) runs before the barrier that precedes the fetch of slice s, for
// a table the fetches of that slice read.
template <int NG, bool A_KMAJOR, typename FA, typename FB, typename FP>
__device__ __forceinline__ void tile_product(int slices, FA fetch_a,
                                             FB fetch_b, FP prepare,
                                             float (*as)[TILE_LD],
                                             float (*bs)[NG * 32],
                                             float (&acc)[8][NG]) {
  constexpr int NA = TILE_M * TILE_K / TILE_THREADS;
  constexpr int NB = TILE_K * NG * 32 / TILE_THREADS;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float ra[NA], rb[NB];
  auto a_kk = [](int i) { return A_KMAJOR ? i % TILE_K : i / TILE_M; };
  auto a_m = [](int i) { return A_KMAJOR ? i / TILE_K : i % TILE_M; };
  auto fetch = [&](int s) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int i = threadIdx.x + q * TILE_THREADS;
      ra[q] = fetch_a(s, a_kk(i), a_m(i));
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int i = threadIdx.x + q * TILE_THREADS;
      rb[q] = fetch_b(s, i / (NG * 32), i % (NG * 32));
    }
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[i][g] = 0.0f;
  if (slices <= 0) return;
  prepare(0);
  __syncthreads();
  fetch(0);
  for (int s = 0; s < slices; ++s) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int i = threadIdx.x + q * TILE_THREADS;
      as[a_kk(i)][a_m(i)] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int i = threadIdx.x + q * TILE_THREADS;
      bs[i / (NG * 32)][i % (NG * 32)] = rb[q];
    }
    if (s + 1 < slices) prepare(s + 1);
    __syncthreads();
    if (s + 1 < slices) fetch(s + 1);
    tile_mac<NG>(as, bs, acc, ty, tx);
    __syncthreads();
  }
}

}  // namespace dl4ss
