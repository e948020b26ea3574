// The main loop shared by the mask-head kernels K3 (maskhead_fwd.cu) and K6
// (maskhead_bwd.cu): acc = h[b, t0:t0+64, :] . W[:, tile] on Hopper's
// warpgroup tensor-core instruction (wgmma), fed from a ring of shared-memory
// stages by the tensor memory accelerator; and the packed layout of W it
// reads.
//
// Work. A unit is 64 time rows of one utterance (the reference backward's
// 64-row tile); an item is one column tile of W (ft whole E-groups, ft*E <=
// MH_NC = 256 columns, so no E-contraction crosses items) times two units.
// One block per SM walks a contiguous run of items, so consecutive items of a
// block share the column tile and W stays hot in L2 (packed W and h together
// are ~14 MB at B=16, well inside the 50 MB).
//
// Block. Two consumer warpgroups (one unit each, a 64 x 256 f32 accumulator
// in registers: 128 per thread) and a producer warpgroup; `setmaxnreg`
// moves its registers to the consumers. One producer thread issues, per
// stage of MH_KS = 64 inner rows, all on the tensor memory accelerator and
// counted on the stage's `full` barrier by their bytes:
//   - one bulk copy of the item's 64 x 256 slice of packed W (32 KB,
//     contiguous);
//   - per unit one tensor-map copy of its 64 x 64 slice of h, read in its
//     own (B, T, D) layout, zero-filled past T and past D. The map is
//     encoded per call on the host (`mh_encode_h`, through the driver's
//     entry point: no link to libcuda); the wrapper pads D to a multiple of
//     8 (a copy) only when rows are not 16-byte aligned, as a map needs
//     (D = 37 in the card tests; never at D = 600). Copying h with cp.async
//     from a producer warp instead held K3 at 0.17 ms (B=16, on an H100),
//     against 0.11 ms with the map.
// The other three warps stage the epilogue's inputs (below).
// Each consumer warpgroup waits on `full`, issues four m64n256k16 wgmma
// (bf16 in, f32 accumulated) per stage, keeps one stage in flight and frees
// the one before on the stage's `empty` barrier. The producer runs up to
// STAGES slices ahead, into the next item while the consumers run the
// epilogue of this one.
//
// Layout. Every staged operand is K-major with the 128-byte swizzle, the
// layout a wgmma descriptor reads directly: row r of a slice is 128 bytes
// (64 bf16), its 16-byte chunk c stored at chunk c ^ (r % 8). The pack kernel
// (maskhead_fwd.cu) writes W once per weight version as (ntiles, nslices,
// 256 columns, 64 inner) in exactly that form, zero past each tile's ft*E
// columns and past D, so one bulk copy lands a stage ready for the tensor
// cores; W's own rows of F*E bf16 are not 16-byte aligned, and the model's W
// is f32.
#pragma once

#include <cstdint>

#include <cuda.h>

#include "dl4ss_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MH_ROWS = 64;         // rows of a unit: one consumer warpgroup
constexpr int MH_NC = 256;          // columns of a tile: wgmma N
constexpr int MH_KS = 64;           // inner rows per stage: one swizzle atom
constexpr int MH_CONSUMERS = 2;     // consumer warpgroups = units per item
constexpr int MH_CONSUMER_THREADS = MH_CONSUMERS * 128;
constexpr int MH_THREADS = MH_CONSUMER_THREADS + 128;  // + the producer's
// Registers a thread: 384 threads start at 168 (65,536 over 12 warps, in
// whole warps of 8 registers); the producer warpgroup gives up all but 40
// and the consumers take 232, enough for the 128 accumulators and the
// epilogue (at 168 ptxas serialises the wgmma and spills).
constexpr int MH_PRODUCER_REGS = 40;
constexpr int MH_CONSUMER_REGS = 232;
static_assert(MH_CONSUMER_THREADS * MH_CONSUMER_REGS +
                  128 * MH_PRODUCER_REGS <= 65536, "the register file");
constexpr int MH_MAX_GROUPS = 16;   // E-groups per tile (n16 products)
constexpr int MH_MAX_K = 4;         // queries per utterance
constexpr int MH_W_BYTES = MH_NC * MH_KS * 2;          // 32 KB a stage
constexpr int MH_A_BYTES = MH_ROWS * MH_KS * 2;        // 8 KB a unit
constexpr int MH_STAGE_BYTES = MH_W_BYTES + MH_CONSUMERS * MH_A_BYTES;
static_assert(MH_STAGE_BYTES % 1024 == 0, "stages stay 1024-byte aligned");

// The problem and its tiling, passed by value to the kernels.
struct MhPlan {
  const bf16* w;       // packed (ntiles, nslices, MH_NC, MH_KS)
  const float* bias;   // (F*E,)
  const bf16* q;       // (B, K, E)
  int T, F, E, K;
  int ft, ntiles, nslices;       // E-groups a tile, tiles, stages an item
  int nt, nunits, npairs, items; // 64-row units: per utterance, all, pairs
};

// The packed W's geometry for W (D, F*E); false when E is outside 1..256.
inline bool mh_geometry(int D, int F, int E, int* ft, int* ntiles,
                        int* nslices) {
  if (D < 1 || F < 1 || E < 1 || E > MH_NC) return false;
  *ft = std::min(std::min(F, MH_NC / E), MH_MAX_GROUPS);
  *ntiles = (F + *ft - 1) / *ft;
  *nslices = (D + MH_KS - 1) / MH_KS;
  return true;
}

inline long long mh_packed_size(int D, int F, int E) {
  int ft, ntiles, nslices;
  if (!mh_geometry(D, F, E, &ft, &ntiles, &nslices)) return -1;
  return (long long)ntiles * nslices * MH_NC * MH_KS;
}

// Fill `p` for a launch; false for shapes the kernels do not take.
inline bool mh_plan(MhPlan* p, const void* h, const void* w,
                    const void* bias, const void* q, int B, int T, int D,
                    int F, int E, int K) {
  if (B < 1 || T < 1 || K < 1 || K > MH_MAX_K || D % 8 != 0 ||
      reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      !mh_geometry(D, F, E, &p->ft, &p->ntiles, &p->nslices))
    return false;
  p->w = static_cast<const bf16*>(w);
  p->bias = static_cast<const float*>(bias);
  p->q = static_cast<const bf16*>(q);
  p->T = T, p->F = F, p->E = E, p->K = K;
  p->nt = (T + MH_ROWS - 1) / MH_ROWS;
  p->nunits = B * p->nt;
  p->npairs = (p->nunits + MH_CONSUMERS - 1) / MH_CONSUMERS;
  p->items = p->ntiles * p->npairs;
  return true;
}

// One block per SM, at most one per item.
inline int mh_grid(const MhPlan& p) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(1, std::min(p.items, sms));
}

// Element offset of (row, inner) in a K-major 128-byte-swizzled slice of
// 64 inner elements a row (bf16).
__host__ __device__ __forceinline__ int sw128(int row, int inner) {
  return row * MH_KS + ((((inner >> 3) ^ row) & 7) << 3) + (inner & 7);
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// Bulk copy (tensor memory accelerator) of `bytes` contiguous bytes, counted
// on `bar` by its transaction bytes.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// Tensor-map copy (tensor memory accelerator) of the box at (c0, c1, c2),
// innermost first, counted on `bar` by its transaction bytes; elements out
// of bounds land as zeros and count too.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)) : "memory");
}

// Order this thread's plain stores to shared memory (generic proxy) before
// later wgmma reads of them (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Move registers between warpgroups: the producer's go to the consumers.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
      MH_PRODUCER_REGS));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      MH_CONSUMER_REGS));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the point where the asynchronous products are known to be done.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major, 128-byte-swizzled operand at `p` (1024-byte
// aligned atoms of 8 rows x 128 bytes; the stride between 8-row groups is
// 1024 bytes). Adding 2 advances it by 16 inner elements (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x 256, f32) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 256), both
// bf16 in shared memory.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16, f32) = (scale_d ? d : 0) + A (64 x 16, bf16 in registers, the
// m64k16 fragment) . B (16 x 16, bf16 in shared memory).
__device__ __forceinline__ void wgmma_n16_rs(float (&d)[8], const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- the ring -----------------------------------------------------------------

// The epilogue's inputs (bias, queries, K6's de), staged per item into one
// of two buffers by the producer warpgroup's other three warps, a buffer
// ahead of the consumers, so their global loads never hold up the tensor
// cores. `full` completes on the stagers' arrivals, `empty` on every
// consumer thread's.
constexpr int MH_STAGERS = 96;

struct MhEpiRing {
  uint64_t* full;   // [2]
  uint64_t* empty;  // [2]
  __device__ void init() {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], MH_STAGERS);
      mbar_init(&empty[i], MH_CONSUMER_THREADS);
    }
  }
};

// Shared memory of the ring: STAGES stages, then its 2 * STAGES barriers
// and the epilogue staging's 4.
template <int STAGES>
struct MhRing {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  MhEpiRing epi;
  static constexpr size_t BYTES =
      (size_t)STAGES * MH_STAGE_BYTES + (2 * STAGES + 4) * sizeof(uint64_t);

  __device__ MhRing(unsigned char* base)
      : stages(base),
        full(reinterpret_cast<uint64_t*>(base + (size_t)STAGES *
                                                    MH_STAGE_BYTES)),
        empty(full + STAGES),
        epi{empty + STAGES, empty + STAGES + 2} {}

  // One thread, before the block's first barrier: `full` completes on the
  // producer's expect_tx arrival and the bytes of its copies; `empty` on
  // every consumer thread.
  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MH_CONSUMER_THREADS);
    }
    epi.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The producer thread: every stage of items [it0, it1), in order.
template <int STAGES>
__device__ __forceinline__ void mh_produce(const MhPlan& p,
                                           const CUtensorMap* hmap,
                                           MhRing<STAGES> ring, int it0,
                                           int it1) {
  int stage = 0;
  uint32_t phase = 0;
  for (int it = it0; it < it1; ++it) {
    const int j = it / p.npairs, pair = it % p.npairs;
    const bf16* wtile = p.w + (size_t)j * p.nslices * MH_NC * MH_KS;
    int b[MH_CONSUMERS], t0[MH_CONSUMERS], live = 0;
#pragma unroll
    for (int u = 0; u < MH_CONSUMERS; ++u) {
      const int unit = MH_CONSUMERS * pair + u;
      b[u] = unit / p.nt;
      t0[u] = unit % p.nt * MH_ROWS;
      live += unit < p.nunits;       // units past the batch are left stale
    }
    for (int s = 0; s < p.nslices; ++s) {
      mbar_wait(&ring.empty[stage], phase ^ 1);
      unsigned char* st = ring.stages + (size_t)stage * MH_STAGE_BYTES;
      mbar_arrive_expect_tx(&ring.full[stage],
                            MH_W_BYTES + live * MH_A_BYTES);
      bulk_g2s(st, wtile + (size_t)s * MH_NC * MH_KS, MH_W_BYTES,
               &ring.full[stage]);
      for (int u = 0; u < live; ++u)
        tma_load_3d(st + MH_W_BYTES + u * MH_A_BYTES, hmap, s * MH_KS, t0[u],
                    b[u], &ring.full[stage]);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
  }
}

// The map of h (B, T, D) bf16 for the producer's copies: boxes of 64 time
// rows by 64 inner elements, 128-byte swizzled. False when the driver's
// encoder cannot be reached or refuses the shape.
inline bool mh_encode_h(CUtensorMap* map, const void* h, int B, int T,
                        int D) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {MH_KS, MH_ROWS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(h), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The stagers: fill(buffer, item, thread 0..95) for items [it0, it1).
template <typename Fill>
__device__ __forceinline__ void mh_stage(MhEpiRing epi, int it0, int it1,
                                         Fill fill) {
  const int tid = threadIdx.x - (MH_CONSUMER_THREADS + 32);
  int buf = 0;
  uint32_t phase = 0;
  for (int it = it0; it < it1; ++it) {
    mbar_wait(&epi.empty[buf], phase ^ 1);
    fill(buf, it, tid);
    mbar_arrive(&epi.full[buf]);
    if (++buf == 2) buf = 0, phase ^= 1;
  }
}

// A consumer warpgroup: acc = its unit's 64 rows of h . the item's column
// tile of W, over every stage of one item. `stage` and `phase` carry over
// from item to item, as in the producer.
template <int STAGES>
__device__ __forceinline__ void mh_consume(float (&acc)[128],
                                           MhRing<STAGES> ring, int nslices,
                                           int wg, int& stage,
                                           uint32_t& phase) {
  int prev = -1;
  for (int s = 0; s < nslices; ++s) {
    mbar_wait(&ring.full[stage], phase);
    unsigned char* st = ring.stages + (size_t)stage * MH_STAGE_BYTES;
    const uint64_t db = sw128_desc(st);
    const uint64_t da = sw128_desc(st + MH_W_BYTES + wg * MH_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MH_KS / 16; ++kk)
      wgmma_n256(acc, da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();          // the stage before this one is read: free it
    if (prev >= 0) mbar_arrive(&ring.empty[prev]);
    prev = stage;
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(&ring.empty[prev]);
}

// The item's place: column tile, its first group and column, the groups and
// columns it owns, and the unit of consumer warpgroup `wg`.
struct MhItem {
  int j, f0, c0, fn, nc, unit, b, t0, live;
};

__device__ __forceinline__ MhItem mh_item(const MhPlan& p, int it, int wg) {
  MhItem m;
  m.j = it / p.npairs;
  m.f0 = m.j * p.ft;
  m.c0 = m.f0 * p.E;
  m.fn = min(p.ft, p.F - m.f0);
  m.nc = m.fn * p.E;
  m.unit = MH_CONSUMERS * (it % p.npairs) + wg;
  m.live = m.unit < p.nunits;
  m.b = m.live ? m.unit / p.nt : 0;
  m.t0 = m.unit % p.nt * MH_ROWS;
  return m;
}

// One epilogue buffer starts with the item's bias over the tile's columns
// (NC, f32), then per unit q_k repeated over them (MAX_K, NC, bf16), zero
// past the tile; K6 appends de.
constexpr size_t MH_EPI_Q_OFF = MH_NC * 4;
constexpr size_t MH_EPI_Q_ELEMS = (size_t)MH_MAX_K * MH_NC;
constexpr size_t MH_EPI_BYTES =
    MH_EPI_Q_OFF + MH_CONSUMERS * MH_EPI_Q_ELEMS * 2;

// The stagers' common part of one item: the bias and q_k of each live unit.
__device__ __forceinline__ void mh_fill_bias_q(const MhPlan& p,
                                               unsigned char* e, int it,
                                               int tid) {
  float* bias_s = reinterpret_cast<float*>(e);
  const MhItem m0 = mh_item(p, it, 0);
  for (int c = tid; c < MH_NC; c += MH_STAGERS)
    bias_s[c] = c < m0.nc ? p.bias[m0.c0 + c] : 0.0f;
#pragma unroll
  for (int u = 0; u < MH_CONSUMERS; ++u) {
    const MhItem m = mh_item(p, it, u);
    if (!m.live) continue;
    const bf16* qb = p.q + (size_t)m.b * p.K * p.E;
    bf16* qu = reinterpret_cast<bf16*>(e + MH_EPI_Q_OFF) + u * MH_EPI_Q_ELEMS;
    for (int c = tid; c < MH_NC; c += MH_STAGERS) {
      const int ec = c % p.E;
      for (int k = 0; k < p.K; ++k)
        qu[k * MH_NC + c] =
            c < m.nc ? qb[k * p.E + ec] : __float2bfloat16_rn(0.0f);
    }
  }
}

// This block's items [it0, it1): a contiguous run.
__device__ __forceinline__ void mh_items(const MhPlan& p, int* it0,
                                         int* it1) {
  *it0 = (int)((long long)p.items * blockIdx.x / gridDim.x);
  *it1 = (int)((long long)p.items * (blockIdx.x + 1) / gridDim.x);
}

// A refused launch leaves the runtime's last error set: clear it, so that the
// next kernel call does not report it.
inline cudaError_t mh_reported(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// bf16(lo), bf16(hi) in one register, lo in the low half: two elements of a
// wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 1024-byte aligned start of the dynamic shared memory (the swizzle
// atoms need it); the kernels ask for 1 KB more than they use.
__device__ __forceinline__ unsigned char* mh_smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

}  // namespace
