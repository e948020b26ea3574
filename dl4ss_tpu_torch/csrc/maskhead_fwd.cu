// K3 — fused mask head forward: projection + tanh + dot attention + sigmoid.
//
// Replaces dl4ss_tpu/ops/pallas_maskhead.py::_kernel (the Pallas body of
// fused_dot_masks' forward). Per (utterance b, time t, frequency f):
//   g[f*E+e] = tanh(h[b,t,:].W[:, f*E+e] + bias[f*E+e])
//   mask[b,k,t,f] = sigmoid(sum_e bf16(g[f*E+e] * q[b,k,e]))
// with h, W and q in bf16, f32 accumulation, and the g*q product rounded to
// bf16 before the E-sum — the rounding points of the JAX kernel
// (pallas_maskhead.py:61-67). The (B, T, F*E) embedding grid never reaches
// device memory: only the (B, K, T, F) masks are written.
//
// Bound on the H100: operations. At B=16, T=313, 2H=600, F*E=6450 the
// projection is 38.8 GFLOP, ~39 us at the dense bf16 tensor-core rate; the
// bytes (h, W, masks: ~20 MB) take ~6 us. Behind that, the L2: every item
// stages its 64 x 256 tile of W for 128 rows of h, ~480 MB of L2 reads at
// B=16.
//
// Design: the wgmma main loop of maskhead_tile.cuh (a persistent block per
// SM; one producer thread feeds FWD_STAGES shared-memory stages through the
// tensor memory accelerator, three warps stage each item's bias and queries
// a buffer ahead; two consumer warpgroups, 64 rows each). The epilogue stays
// in registers: bias and tanh on the accumulator, then per query k the
// product bf16(g * q_k) is formed in place in the layout of a wgmma A
// fragment (the f32 accumulator of m64nNk16 converts to it element for
// element) and contracted over E by a second wgmma against the 0/1 block-sum
// matrix S (256 x 16, staged once): bf16 terms summed in f32 on the tensor
// cores, as the TPU kernel's `gk @ S`. The sigmoid of the (64 x fn) sums is
// stored. While the consumers run the epilogue, the producer is already
// filling the stages of the block's next item.
#include "maskhead_tile.cuh"

namespace {

constexpr int FWD_STAGES = 4;
constexpr size_t FWD_S_OFF =
    (MhRing<FWD_STAGES>::BYTES + 1023) / 1024 * 1024;
// S: MH_NC / MH_KS swizzle atoms of MH_MAX_GROUPS rows x MH_KS inner, bf16
constexpr size_t FWD_S_BYTES = (size_t)MH_NC * MH_MAX_GROUPS * 2;
// two epilogue buffers (maskhead_tile.cuh: bias and q_k)
constexpr size_t FWD_EPI_OFF = FWD_S_OFF + FWD_S_BYTES;
constexpr size_t FWD_EPI_BYTES = MH_EPI_BYTES;
constexpr size_t FWD_SMEM =
    FWD_EPI_OFF + 2 * FWD_EPI_BYTES + 1024;   // + alignment
static_assert(FWD_SMEM <= 232448, "a block's shared memory on the H100");

// W (D, F*E) -> the packed tiles, one block per (column tile j, stage s):
// the 64 x 256 slab is gathered row by row (coalesced over W's columns)
// into shared memory in its swizzled order, then written out in 16-byte
// vectors.
template <typename InT>
__global__ void __launch_bounds__(256) maskhead_pack_kernel(
    const InT* __restrict__ w, bf16* __restrict__ wt, int D, int fe,
    int nc_tile, int nslices) {
  __shared__ __align__(16) bf16 slab[MH_NC * MH_KS];
  const int j = blockIdx.x / nslices, s = blockIdx.x % nslices;
  for (int i = threadIdx.x; i < MH_NC * MH_KS; i += blockDim.x) {
    const int kk = i / MH_NC, c = i % MH_NC;
    const int k = s * MH_KS + kk, col = j * nc_tile + c;
    const bool live = k < D && c < nc_tile && col < fe;
    slab[sw128(c, kk)] = __float2bfloat16_rn(
        live ? dl4ss::to_f32(w[(size_t)k * fe + col]) : 0.0f);
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(wt + (size_t)blockIdx.x * MH_NC *
                                                 MH_KS);
  const uint4* src = reinterpret_cast<const uint4*>(slab);
  for (int i = threadIdx.x; i < MH_NC * MH_KS / 8; i += blockDim.x)
    dst[i] = src[i];
}

template <typename OutT>
__global__ void __launch_bounds__(MH_THREADS, 1) maskhead_fwd_kernel(
    const MhPlan p, const __grid_constant__ CUtensorMap hmap,
    OutT* __restrict__ out) {   // out (B, K, T, F)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mh_smem_base(smem_raw);
  MhRing<FWD_STAGES> ring(smem);
  bf16* sm = reinterpret_cast<bf16*>(smem + FWD_S_OFF);
  if (threadIdx.x == 0) ring.init();
  // S[n, c] = 1 where column c of a tile belongs to E-group n
  for (int i = threadIdx.x; i < MH_MAX_GROUPS * MH_NC; i += MH_THREADS) {
    const int n = i / MH_NC, c = i % MH_NC;
    sm[c / MH_KS * (MH_MAX_GROUPS * MH_KS) + sw128(n, c % MH_KS)] =
        __float2bfloat16_rn(c < p.ft * p.E && c / p.E == n ? 1.0f : 0.0f);
  }
  fence_proxy_async();
  __syncthreads();
  int it0, it1;
  mh_items(p, &it0, &it1);
  unsigned char* epi = smem + FWD_EPI_OFF;
  if (threadIdx.x >= MH_CONSUMER_THREADS) {    // the producer warpgroup
    producer_regs();
    if (threadIdx.x == MH_CONSUMER_THREADS)
      mh_produce(p, &hmap, ring, it0, it1);
    else if (threadIdx.x >= MH_CONSUMER_THREADS + 32)
      mh_stage(ring.epi, it0, it1, [&](int buf, int it, int tid) {
        mh_fill_bias_q(p, epi + buf * FWD_EPI_BYTES, it, tid);
      });
    return;
  }
  consumer_regs();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = tid / 32 * 16 + lane / 4;   // rows r0 and r0 + 8
  const int cq = (lane & 3) * 2;             // columns 8i + cq, 8i + cq + 1
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int stage = 0, ebuf = 0;
  uint32_t phase = 0, ephase = 0;
  for (int it = it0; it < it1; ++it) {
    const MhItem m = mh_item(p, it, wg);
    mh_consume(acc, ring, p.nslices, wg, stage, phase);
    mbar_wait(&ring.epi.full[ebuf], ephase);
    const unsigned char* staged = epi + ebuf * FWD_EPI_BYTES;
    const float* bias_s = reinterpret_cast<const float*>(staged);
    const bf16* q_s = reinterpret_cast<const bf16*>(staged + MH_EPI_Q_OFF) +
                      wg * MH_EPI_Q_ELEMS;                    // (K, NC)
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
      for (int k = 0; k < p.K; ++k) {
        const bf16* qk = q_s + k * MH_NC;
        float e[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = 0.0f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // inner step s covers columns 16s .. 16s + 15: accumulator chunks
          // 2s and 2s + 1 are its A fragment
          uint32_t a[8][4];
#pragma unroll
          for (int ss = 0; ss < 8; ++ss) {
            const int s = half * 8 + ss, cb = 16 * s + cq;
            const float qa = __bfloat162float(qk[cb]);
            const float qb = __bfloat162float(qk[cb + 1]);
            const float qc = __bfloat162float(qk[cb + 8]);
            const float qd = __bfloat162float(qk[cb + 9]);
            a[ss][0] = pack_bf16(acc[8 * s] * qa, acc[8 * s + 1] * qb);
            a[ss][1] = pack_bf16(acc[8 * s + 2] * qa, acc[8 * s + 3] * qb);
            a[ss][2] = pack_bf16(acc[8 * s + 4] * qc, acc[8 * s + 5] * qd);
            a[ss][3] = pack_bf16(acc[8 * s + 6] * qc, acc[8 * s + 7] * qd);
          }
          wgmma_fence();
#pragma unroll
          for (int ss = 0; ss < 8; ++ss) {
            const int s = half * 8 + ss;
            wgmma_n16_rs(e, a[ss],
                         sw128_desc(sm + s / 4 * (MH_MAX_GROUPS * MH_KS)) +
                             2 * (s % 4),
                         half > 0 || ss > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(e);
        }
        // e[x] is (row r0 + 8 * (x / 2 % 2), group 8 * (x / 4) + cq + x % 2)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int t = m.t0 + r0 + (x >> 1 & 1) * 8;
          const int gi = (x >> 2) * 8 + cq + (x & 1);
          if (gi < m.fn && t < p.T)
            dl4ss::store(out + (((size_t)m.b * p.K + k) * p.T + t) * p.F +
                             m.f0 + gi,
                         dl4ss::sigmoid(e[x]));
        }
      }
    }
    mbar_arrive(&ring.epi.empty[ebuf]);
    if (++ebuf == 2) ebuf = 0, ephase ^= 1;
  }
}

template <typename OutT>
cudaError_t run(const void* h, const void* w, const void* bias,
                const void* q, void* out, int B, int T, int D, int F, int E,
                int K, cudaStream_t stream) {
  MhPlan p;
  if (!mh_plan(&p, h, w, bias, q, B, T, D, F, E, K))
    return cudaErrorInvalidValue;
  cudaError_t err = dl4ss::allow_smem(maskhead_fwd_kernel<OutT>, FWD_SMEM);
  if (err != cudaSuccess) return mh_reported(err);
  CUtensorMap hmap;
  if (!mh_encode_h(&hmap, h, B, T, D)) return cudaErrorNotSupported;
  maskhead_fwd_kernel<OutT><<<mh_grid(p), MH_THREADS, FWD_SMEM, stream>>>(
      p, hmap, static_cast<OutT*>(out));
  return cudaGetLastError();
}

template <typename InT>
cudaError_t pack(const void* w, void* wt, int D, int F, int E,
                 cudaStream_t stream) {
  int ft, ntiles, nslices;
  if (!mh_geometry(D, F, E, &ft, &ntiles, &nslices) ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return cudaErrorInvalidValue;
  maskhead_pack_kernel<InT><<<ntiles * nslices, 256, 0, stream>>>(
      static_cast<const InT*>(w), static_cast<bf16*>(wt), D, F * E, ft * E,
      nslices);
  return cudaGetLastError();
}

}  // namespace

// Elements of the packed W (bf16) for W (D, F*E), or -1 when E is outside
// 1..256.
extern "C" long long dl4ss_maskhead_packed_size(int D, int F, int E) {
  return mh_packed_size(D, F, E);
}

// w (D, F*E) in f32 (w_f32 != 0) or bf16 -> wt, the packed bf16 tiles.
extern "C" int dl4ss_maskhead_pack(const void* w, void* wt, int D, int F,
                                   int E, int w_f32, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return w_f32 ? pack<float>(w, wt, D, F, E, s)
               : pack<bf16>(w, wt, D, F, E, s);
}

// h (B, T, D) bf16 with D a multiple of 8 and 16-byte aligned (W's D padded
// with zero columns where needed); w packed by dl4ss_maskhead_pack for W's
// own D <= this D; q (B, K, E) bf16 with K <= 4; bias (F*E,) f32; out
// (B, K, T, F) in f32, or bf16 when out_bf16 != 0.
extern "C" int dl4ss_maskhead_fwd(const void* h, const void* w,
                                  const void* bias, const void* q, void* out,
                                  int B, int T, int D, int F, int E, int K,
                                  int out_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? run<bf16>(h, w, bias, q, out, B, T, D, F, E, K, s)
                  : run<float>(h, w, bias, q, out, B, T, D, F, E, K, s);
}
