// K6 — fused mask head backward: recompute g, then the gradients that stay
// inside the E-contraction.
//
// Replaces dl4ss_tpu/ops/pallas_maskhead.py::_bwd_kernel (the Pallas body of
// fused_dot_masks' VJP, _bwd_vjp). With the forward's saved masks m and the
// incoming dout, per (utterance b, time t, frequency f, embedding e):
//   g      = tanh(h[b,t,:].W[:, f*E+e] + bias[f*E+e])       recomputed, f32
//   de_k   = bf16(dout_k * m_k * (1 - m_k))                 (B, K, T, F)
//   dg     = sum_k de_k[t,f] * q_k[e]
//   dacc   = bf16(dg * (1 - g^2))                          -> (B, T, F*E)
//   dq_k[e] = sum over time tiles of sum_f bf16(sum_{t in tile} g * de_k)
//   db     = sum over (b, t) of dacc, in f32
// h, W, q, the masks and dout enter as bf16; the time tile is 64 rows, as
// the JAX kernel's default `bwd_tile`, so the column sums behind dq round to
// bf16 at the same points (pallas_maskhead.py:237-241). The 0/1 S and R
// matrices of the TPU kernel only route the broadcast over E and the fold to
// E through its matrix unit; here both are index arithmetic on shared
// memory. dW = h^T dacc and dh = dacc W^T are plain matrix products outside,
// as in JAX (ops/maskhead_kernels.py); db comes from this kernel's partials.
//
// Bound on the H100: operations, barely. At B=16, T=313, 2H=600,
// F*E=6450 the recomputed projection is 38.8 GFLOP, ~39 us at the dense
// bf16 tensor-core rate; dacc is 64.6 MB of bf16, ~19 us at 3.35 TB/s.
//
// Design: K3's wgmma main loop (maskhead_tile.cuh) on the W that K3 packed
// for the same weight version, BWD_STAGES stages. The producer warpgroup's
// stagers put de_k for each unit's rows and the tile's groups, q_k and the
// bias in shared memory an item ahead of the consumers. The epilogue works
// on the accumulator in registers: tanh; per k the column
// sums of g * de_k over the unit's 64 rows (the two rows a thread holds,
// then a butterfly over the 8 lanes of a column that halves the values each
// step, then the 4 warps in a fixed order), rounded to bf16 and folded to
// E; dacc, parked per warp in shared memory and written a row at a time
// (the rows of F*E bf16 are only 4-byte aligned, so no wider store and no
// tensor map fits them); the column sums of the bf16 dacc in f32, by the
// same reduction.
// Each unit writes its dq and db partials; a second kernel sums them in a
// fixed order, so dq and db are deterministic (no atomics) and two calls are
// bit-equal. The kernel is built for 1..4 queries, so its loops over k
// unroll. The epilogue does not overlap the block's next products: the
// accumulator holds g until the last column is done.
#include "maskhead_tile.cuh"

namespace {

constexpr int BWD_STAGES = 3;
constexpr size_t BWD_G_OFF =
    (MhRing<BWD_STAGES>::BYTES + 1023) / 1024 * 1024;
constexpr size_t BWD_G_BYTES = MH_NC * sizeof(short);      // group of a column
// two epilogue buffers, each the bias and q_k of maskhead_tile.cuh, then
// per unit de (MAX_K, ROWS, MAX_GROUPS) in bf16 (de rounds to it)
constexpr size_t BWD_EPI_OFF = BWD_G_OFF + BWD_G_BYTES;
constexpr size_t BWD_DE_ELEMS = (size_t)MH_MAX_K * MH_ROWS * MH_MAX_GROUPS;
constexpr size_t BWD_DE_OFF = MH_EPI_BYTES;                 // in a buffer
constexpr size_t BWD_EPI_BYTES =
    BWD_DE_OFF + MH_CONSUMERS * BWD_DE_ELEMS * 2;
// per consumer warpgroup: each warp's column sums for each k (MAX_K, 4,
// NC), f32; later, in the same bytes, each warp's 16 rows of half the
// tile's dacc on their way out (16, BWD_OUT_LD words of two bf16)
constexpr int BWD_OUT_LD = MH_NC / 4 + 4;   // 8 rows x 4 lanes: 32 banks
constexpr size_t BWD_OUT_WARP_BYTES = 16 * BWD_OUT_LD * 4;
constexpr size_t BWD_RED_OFF = BWD_EPI_OFF + 2 * BWD_EPI_BYTES;
constexpr size_t BWD_RED_BYTES =
    std::max((size_t)MH_MAX_K * 4 * MH_NC * 4, 4 * BWD_OUT_WARP_BYTES);
constexpr size_t BWD_SMEM =
    BWD_RED_OFF + MH_CONSUMERS * BWD_RED_BYTES + 1024;     // + alignment
static_assert(BWD_SMEM <= 232448, "a block's shared memory on the H100");

// The stagers' part of one item: bias and q_k (maskhead_tile.cuh), and
// de_k = bf16(dout_k m_k (1 - m_k)) for each unit's rows (zero past T) and
// the tile's groups. Groups past the tile keep what an earlier item left
// there (zeros at first): only columns with q = 0 and g = 0 read them.
template <int KQ>
__device__ __forceinline__ void bwd_fill(const MhPlan& p,
                                         const bf16* __restrict__ masks,
                                         const bf16* __restrict__ dout,
                                         unsigned char* e, int it, int tid) {
  mh_fill_bias_q(p, e, it, tid);
  const MhItem m0 = mh_item(p, it, 0);
  // de for both units: each (unit, row, group) reads KQ masks and dout
  // values, two of them at a time so that their loads are in flight
  // together
  static_assert(MH_CONSUMERS == 2, "two units an item");
  const MhItem m1 = mh_item(p, it, 1);
  const int fn = m0.fn, n = MH_ROWS * fn;
  const size_t plane = (size_t)p.T * p.F;            // one (b, k) of masks
  bf16* de_s = reinterpret_cast<bf16*>(e + BWD_DE_OFF);
#pragma unroll 2
  for (int i = tid; i < MH_CONSUMERS * n; i += MH_STAGERS) {
    const int u = i >= n, r = (i - u * n) / fn, gi = i - u * n - r * fn;
    const int t = (u ? m1.t0 : m0.t0) + r;
    const bool in = (u ? m1.live : m0.live) && t < p.T;
    const size_t o =
        ((size_t)(u ? m1.b : m0.b) * KQ * p.T + t) * p.F + m0.f0 + gi;
    float mk[KQ], dk[KQ];
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      mk[k] = in ? __bfloat162float(masks[o + k * plane]) : 0.0f;
      dk[k] = in ? __bfloat162float(dout[o + k * plane]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < KQ; ++k)
      de_s[u * BWD_DE_ELEMS + (k * MH_ROWS + r) * MH_MAX_GROUPS + gi] =
          __float2bfloat16_rn(dk[k] * mk[k] * (1.0f - mk[k]));
  }
}

// One step of the butterfly: the lane keeps half of its first N values
// (the half its lane bit BIT names) and adds its partner's copy of that
// half.
template <int N, int BIT>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool hi = lane & BIT;
#pragma unroll
  for (int m = 0; m < N / 2; ++m) {
    const float send = hi ? v[m] : v[m + N / 2];
    const float keep = hi ? v[m + N / 2] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

// v[m] (m < 8) is a column's value summed over a thread's two rows, for
// the columns j = j0 + m of the accumulator's order (column
// 8 * (j / 2) + cq + j % 2). Sum each over the warp's 16 rows (the 8 lanes
// with the same lane & 3): after the three steps the lane holds the sum for
// j = j0 + b2 + 2 * b3 + 4 * b4 (its lane bits b2..b4), written to red[col].
// Halving each step costs 7 shuffles for 8 columns.
__device__ __forceinline__ void column_sums(float (&v)[8], int lane, int j0,
                                            int cq, float* red) {
  halve<8, 16>(v, lane);
  halve<4, 8>(v, lane);
  halve<2, 4>(v, lane);
  const int j = j0 + (lane >> 2 & 1) + (lane >> 3 & 1) * 2 +
                (lane >> 4 & 1) * 4;
  red[(j >> 1) * 8 + cq + (j & 1)] = v[0];
}

template <int KQ>
__global__ void __launch_bounds__(MH_THREADS, 1) maskhead_bwd_kernel(
    const MhPlan p, const __grid_constant__ CUtensorMap hmap,
    const bf16* __restrict__ masks,  // (B, K, T, F) saved forward masks
    const bf16* __restrict__ dout,   // (B, K, T, F)
    bf16* __restrict__ dacc,         // (B, T, F*E)
    float* __restrict__ dq_part,     // (nunits, ntiles, K, E)
    float* __restrict__ db_part) {   // (nunits, F*E)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mh_smem_base(smem_raw);
  MhRing<BWD_STAGES> ring(smem);
  short* g_s = reinterpret_cast<short*>(smem + BWD_G_OFF);
  unsigned char* epi = smem + BWD_EPI_OFF;
  if (threadIdx.x == 0) ring.init();
  for (int c = threadIdx.x; c < MH_NC; c += MH_THREADS)
    g_s[c] = (short)min(c / p.E, MH_MAX_GROUPS - 1);
  for (int buf = 0; buf < 2; ++buf) {        // de of groups no item fills
    bf16* de0 = reinterpret_cast<bf16*>(epi + buf * BWD_EPI_BYTES +
                                        BWD_DE_OFF);
    for (int i = threadIdx.x; i < (int)(MH_CONSUMERS * BWD_DE_ELEMS);
         i += MH_THREADS)
      de0[i] = __float2bfloat16_rn(0.0f);
  }
  __syncthreads();
  int it0, it1;
  mh_items(p, &it0, &it1);
  if (threadIdx.x >= MH_CONSUMER_THREADS) {    // the producer warpgroup
    producer_regs();
    if (threadIdx.x == MH_CONSUMER_THREADS)
      mh_produce(p, &hmap, ring, it0, it1);
    else if (threadIdx.x >= MH_CONSUMER_THREADS + 32)
      mh_stage(ring.epi, it0, it1, [&](int buf, int it, int tid) {
        bwd_fill<KQ>(p, masks, dout, epi + buf * BWD_EPI_BYTES, it, tid);
      });
    return;
  }
  consumer_regs();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;       // rows r0 and r0 + 8
  const int cq = (lane & 3) * 2;             // columns 8i + cq, 8i + cq + 1
  float* red = reinterpret_cast<float*>(smem + BWD_RED_OFF +
                                        wg * BWD_RED_BYTES);   // (K, 4, NC)
  const size_t fe = (size_t)p.F * p.E;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int stage = 0, ebuf = 0;
  uint32_t phase = 0, ephase = 0;
  for (int it = it0; it < it1; ++it) {
    const MhItem m = mh_item(p, it, wg);
    mh_consume(acc, ring, p.nslices, wg, stage, phase);
    mbar_wait(&ring.epi.full[ebuf], ephase);
    const unsigned char* staged = epi + ebuf * BWD_EPI_BYTES;
    const float* bias_s = reinterpret_cast<const float*>(staged);
    const bf16* q_s =
        reinterpret_cast<const bf16*>(staged + MH_EPI_Q_OFF) +
        wg * MH_EPI_Q_ELEMS;
    const bf16* de_s =
        reinterpret_cast<const bf16*>(staged + BWD_DE_OFF) + wg * BWD_DE_ELEMS;
    // the last item's sums are read: red is free
    named_sync(1 + wg, 128);
    if (m.live) {                   // else a whole warpgroup past the batch
      // acc[4i + 2h + x] is (row r0 + 8h, column 8i + cq + x): g in place
#pragma unroll
      for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float bv = bias_s[8 * i + cq + x];
          acc[4 * i + x] = tanhf(acc[4 * i + x] + bv);
          acc[4 * i + 2 + x] = tanhf(acc[4 * i + 2 + x] + bv);
        }
      // one pass over the columns, 8 at a time: per k the column sums of
      // g * de_k behind dq, and dacc = bf16(sum_k de_k q_k * (1 - g^2)),
      // which replaces g in acc
#pragma unroll
      for (int blk = 0; blk < 8; ++blk) {
        float v[KQ][8];
#pragma unroll
        for (int mm = 0; mm < 8; ++mm) {
          const int i = 4 * blk + mm / 2, x = mm % 2, c = 8 * i + cq + x;
          const int gi = g_s[c];
          const float g0 = acc[4 * i + x], g1 = acc[4 * i + 2 + x];
          float dg0 = 0.0f, dg1 = 0.0f;
#pragma unroll
          for (int k = 0; k < KQ; ++k) {
            const bf16* dk = de_s + (k * MH_ROWS + r0) * MH_MAX_GROUPS + gi;
            const float d0 = __bfloat162float(dk[0]);
            const float d1 = __bfloat162float(dk[8 * MH_MAX_GROUPS]);
            const float qv = __bfloat162float(q_s[k * MH_NC + c]);
            v[k][mm] = g0 * d0 + g1 * d1;
            dg0 += d0 * qv;
            dg1 += d1 * qv;
          }
          acc[4 * i + x] =
              __bfloat162float(__float2bfloat16_rn(dg0 * (1.0f - g0 * g0)));
          acc[4 * i + 2 + x] =
              __bfloat162float(__float2bfloat16_rn(dg1 * (1.0f - g1 * g1)));
        }
#pragma unroll
        for (int k = 0; k < KQ; ++k)
          column_sums(v[k], lane, 8 * blk, cq, red + (k * 4 + warp) * MH_NC);
      }
    }
    mbar_arrive(&ring.epi.empty[ebuf]);   // done with the staged inputs
    if (++ebuf == 2) ebuf = 0, ephase ^= 1;
    if (!m.live) continue;

    // dq: the 4 warps' column sums in a fixed order, rounded to bf16 (the
    // reference's `col`), into warp 0's row; then folded over the groups
    named_sync(1 + wg, 128);
    for (int i = tid; i < KQ * MH_NC; i += 128) {
      float* r = red + (i / MH_NC * 4) * MH_NC + i % MH_NC;
      r[0] = __bfloat162float(__float2bfloat16_rn(
          r[0] + r[MH_NC] + r[2 * MH_NC] + r[3 * MH_NC]));
    }
    named_sync(1 + wg, 128);
    float* dq_out = dq_part + ((size_t)m.unit * p.ntiles + m.j) * KQ * p.E;
    for (int i = tid; i < KQ * p.E; i += 128) {
      const float* r = red + (i / p.E * 4) * MH_NC + i % p.E;
      float s = 0.0f;
      for (int gi = 0; gi < m.fn; ++gi) s += r[gi * p.E];
      dq_out[i] = s;
    }
    named_sync(1 + wg, 128);
    // dacc out, half the tile at a time: each warp parks its 16 rows in
    // shared memory, then writes each row as contiguous words (128 bytes a
    // warp instruction; the accumulator's layout would scatter 16-byte
    // pieces over 8 rows)
    const bool pairs = ((m.c0 | (int)fe) & 1) == 0;
    uint32_t* park = reinterpret_cast<uint32_t*>(
        reinterpret_cast<unsigned char*>(red) + warp * BWD_OUT_WARP_BYTES);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = 16 * half; i < 16 * half + 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[4 * i + 2 * h],
                                                    acc[4 * i + 2 * h + 1]);
          park[(lane / 4 + 8 * h) * BWD_OUT_LD + (8 * i + cq) / 2 -
               MH_NC / 4 * half] = *reinterpret_cast<uint32_t*>(&v2);
        }
      __syncwarp();
      const int c0 = MH_NC / 2 * half;          // first column of the half
      for (int r = 0; r < 16; ++r) {
        const int t = m.t0 + warp * 16 + r;
        if (t >= p.T) break;
        bf16* row = dacc + ((size_t)m.b * p.T + t) * fe + m.c0 + c0;
        const uint32_t* src = park + r * BWD_OUT_LD;
#pragma unroll
        for (int w = lane; w < MH_NC / 4; w += 32) {
          const int c = c0 + 2 * w;
          if (pairs && c + 1 < m.nc) {
            reinterpret_cast<uint32_t*>(row)[w] = src[w];
          } else {
            const __nv_bfloat162 v2 =
                *reinterpret_cast<const __nv_bfloat162*>(&src[w]);
            if (c < m.nc) row[2 * w] = v2.x;
            if (c + 1 < m.nc) row[2 * w + 1] = v2.y;
          }
        }
      }
      __syncwarp();
    }
    named_sync(1 + wg, 128);
    // db: the column sums of the bf16 dacc over the unit's rows, in f32
#pragma unroll
    for (int blk = 0; blk < 8; ++blk) {
      float v[8];
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        const int i = 4 * blk + mm / 2, x = mm % 2;
        v[mm] = acc[4 * i + x] + acc[4 * i + 2 + x];
      }
      column_sums(v, lane, 8 * blk, cq, red + warp * MH_NC);
    }
    named_sync(1 + wg, 128);
    float* db_out = db_part + (size_t)m.unit * fe + m.c0;
    for (int c = tid; c < m.nc; c += 128)
      db_out[c] = red[c] + red[MH_NC + c] + red[2 * MH_NC + c] +
                  red[3 * MH_NC + c];
  }
}

// K6 for KQ queries an utterance (the kernel's loops over k unroll).
template <int KQ>
cudaError_t bwd_launch(const MhPlan& p, const CUtensorMap& hmap,
                       const void* masks, const void* dout, void* dacc,
                       float* dq_part, float* db_part, cudaStream_t s) {
  cudaError_t err = dl4ss::allow_smem(maskhead_bwd_kernel<KQ>, BWD_SMEM);
  if (err != cudaSuccess) return mh_reported(err);
  maskhead_bwd_kernel<KQ><<<mh_grid(p), MH_THREADS, BWD_SMEM, s>>>(
      p, hmap, static_cast<const bf16*>(masks), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dacc), dq_part, db_part);
  return cudaGetLastError();
}

// dq[b, k, e] = sum over the partials of utterance b, in a fixed order
// (time tile, then column tile); db[c] = sum over the units, in order.
__global__ void maskhead_sums_kernel(const float* __restrict__ dq_part,
                                     const float* __restrict__ db_part,
                                     float* __restrict__ dq,
                                     float* __restrict__ db, int B,
                                     int nparts, int KE, int nunits,
                                     int fe) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.0f;
  if (i < B * KE) {
    const float* p = dq_part + (size_t)(i / KE) * nparts * KE + i % KE;
    for (int j = 0; j < nparts; ++j) s += p[(size_t)j * KE];
    dq[i] = s;
  } else if (i < B * KE + fe) {
    const int c = i - B * KE;
    for (int u = 0; u < nunits; ++u) s += db_part[(size_t)u * fe + c];
    db[c] = s;
  }
}

}  // namespace

// Floats of the partials buffer (dq's, then db's) for these shapes, or -1
// for shapes the kernel does not take (E outside 1..256).
extern "C" long long dl4ss_maskhead_bwd_partials(int B, int T, int D, int F,
                                                 int E, int K) {
  int ft, ntiles, nslices;
  if (B < 1 || T < 1 || K < 1 ||
      !mh_geometry(D, F, E, &ft, &ntiles, &nslices))
    return -1;
  const long long nunits = (long long)B * ((T + MH_ROWS - 1) / MH_ROWS);
  return nunits * ntiles * K * E + nunits * F * E;
}

// h (B, T, D) bf16 (as for dl4ss_maskhead_fwd), q (B, K, E), masks and dout
// (B, K, T, F) in bf16; w packed by dl4ss_maskhead_pack; bias (F*E,) f32 ->
// dacc (B, T, F*E) bf16, dq (B, K, E) f32 and db (F*E,) f32, with part
// (dl4ss_maskhead_bwd_partials floats) as scratch.
extern "C" int dl4ss_maskhead_bwd(const void* h, const void* w,
                                  const void* bias, const void* q,
                                  const void* masks, const void* dout,
                                  void* dacc, void* part, void* dq, void* db,
                                  int B, int T, int D, int F, int E, int K,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  MhPlan p;
  if (!mh_plan(&p, h, w, bias, q, B, T, D, F, E, K))
    return cudaErrorInvalidValue;
  float* dq_part = static_cast<float*>(part);
  float* db_part = dq_part + (size_t)p.nunits * p.ntiles * K * E;
  CUtensorMap hmap;
  if (!mh_encode_h(&hmap, h, B, T, D)) return cudaErrorNotSupported;
  cudaError_t err = K == 1   ? bwd_launch<1>(p, hmap, masks, dout, dacc,
                                               dq_part, db_part, s)
                    : K == 2 ? bwd_launch<2>(p, hmap, masks, dout, dacc,
                                               dq_part, db_part, s)
                    : K == 3 ? bwd_launch<3>(p, hmap, masks, dout, dacc,
                                               dq_part, db_part, s)
                             : bwd_launch<4>(p, hmap, masks, dout, dacc,
                                               dq_part, db_part, s);
  if (err != cudaSuccess) return err;
  const int total = B * K * E + F * E;
  maskhead_sums_kernel<<<(total + 127) / 128, 128, 0, s>>>(
      dq_part, db_part, static_cast<float*>(dq), static_cast<float*>(db), B,
      p.nt * p.ntiles, K * E, p.nunits, F * E);
  return cudaGetLastError();
}
