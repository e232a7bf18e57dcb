// Masked-softmax self-attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bwd_kernel` in
// wav2vec_contr_loss_tpu/ops/attention_pallas.py. From the forward's
// residuals (q, k, v, the fp32 (B, T) key bias, the row statistics
// (m, log l) and out_exact of attention_fwd.cu, the dropout seed) and the
// output cotangent g it recomputes p = exp(q . k^T + bias - m - log l) and
// the murmur dropout mask (dropout_mask.cuh), stores no probability, and
// computes, with bf16 operands and fp32 accumulation:
//   dv = bf16(p * mask)^T . g
//   dp = (g . v^T) * mask
//   ds = p * (dp - D),  D_i = rowsum(g_i * out_exact_i)
//   dq = bf16(ds) . k,   dk = bf16(ds)^T . q
// D is FlashAttention's identity, sum_j dp_ij p_ij = g_i . (p mask v)_i,
// where Pallas sums p * dp in fp32. out_exact is (p mask) . v with p in
// fp32, not rounded to bf16 as in out, so D carries one bf16 rounding of
// that row and none of p. From out itself D is off by ~2^-9 |p| |dp| per
// key, which at the training shape put a dq entry outside the tolerance
// against the plain version (0.079 on an entry of 0.28, in a clip with 10
// valid frames, on an H100).
//
// Bound on an H100 at the training shape (B=32, H=16, T=249): it moves
// q, k, v, g, dq, dk and dv once, 114 MB (34 us at 3.35 TB/s); its seven
// T x T x 64 products (s and dp for dq, s^T and dp^T for dk and dv, and
// the three gradients) are 29 GFLOP (29 us at the bf16 peak); per score
// it also takes two exps on the SFU and, with dropout, the murmur hash
// once (~12 integer operations at 64 a clock an SM: 27 us). Bytes,
// products and element work are of one size, so the design keeps the
// (T, T) panels in registers and overlaps loads with math across blocks.
//
// Design: two kernels, each one consumer warpgroup of 64 rows and one
// producer warp that loads 64-row tiles by TMA into an mbarrier ring, all
// products by wgmma with fp32 accumulators in registers, softmax
// arithmetic in registers (quads of lanes hold a row). No atomics: every
// output element is written once by one block, so two calls give the
// same bits.
//   1. dq kernel, grid (query tile, head, batch): D of its 64 rows from
//      g and out_exact (written out for kernel 2), then for each key tile
//      j s = q_i k_j^T and dp = g_i v_j^T, ds in registers, and
//      dq_i += bf16(ds) . k_j with ds as the register A operand. With
//      dropout it hashes the mask and hands it to kernel 2 as one bit a
//      score (4 MB at the training shape), so the hash runs once.
//   2. dk/dv kernel, grid (key tile, head, batch): k_j and v_j stay in
//      shared memory; for each query tile i (q_i, g_i, their row
//      statistics, D and the mask bits by TMA and bulk copies)
//      s^T = k_j q_i^T and dp^T = v_j g_i^T, then
//      dv_j += bf16(p^T * mask) . g_i and dk_j += bf16(ds^T) . q_i.
// Each block takes 82-87 KB of shared memory and at most 168 registers a
// thread, so two blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "dropout_mask.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 4;      // ring slots (a K/V or Q/G tile pair each)
constexpr int kThreads = 160;   // one consumer warpgroup + a producer warp

struct Strides {  // element strides (batch, head, row) of a (B, H, T, 64)
  long long b, h, t;
};

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// rows r_lo and r_lo + 8 of a (64 x 64) fp32 accumulator as bf16 into
// `dst` (rows below T only)
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, Strides s,
                                           int b, int h, int r_lo, int T,
                                           int c_lane, const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= T) continue;
    __nv_bfloat16* row = dst + b * s.b + h * s.h + r * s.t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + c_lane) =
          pack_bf16(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
}

// x = a . b^T and y = c . d^T over 64 x 64 K-major tiles, once the ring
// slot's loads (the phase of use t) have landed
__device__ __forceinline__ void score_pair(uint64_t* full, int t,
                                           float (&x)[32], const void* a,
                                           const void* b, float (&y)[32],
                                           const void* c, const void* d) {
  bar_wait(full, (t / kStages) & 1);
  wg_fence();
  tile_abt(x, a, b);
  tile_abt(y, c, d);
  wg_commit();
  wg_wait<0>();
  fence_regs(x);
  fence_regs(y);
}

// ---------------------------------------------------------------- dq ----

struct __align__(1024) DqSmem {
  __nv_bfloat16 q[kTile * 64], g[kTile * 64];
  __nv_bfloat16 k[kStages][kTile * 64], v[kStages][kTile * 64];
  uint64_t full[kStages], empty[kStages], qg_full;
};
constexpr size_t kDqSmem = sizeof(DqSmem) + 1024;

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
attention_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __nv_bfloat16* __restrict__ g, Strides gs,
                    const __nv_bfloat16* __restrict__ out_exact, Strides os,
                    const float* __restrict__ bias,
                    const float2* __restrict__ stats,
                    float* __restrict__ dbuf, uint32_t* __restrict__ keep_out,
                    __nv_bfloat16* __restrict__ dq, Strides dqs, int H, int T,
                    unsigned seed, unsigned seed_stride,
                    unsigned threshold, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (T + kTile - 1) / kTile;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], 128);
    }
    bar_init(&sm.qg_full, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer ----
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&gmap);
      bar_expect(&sm.qg_full, 2 * kTileBytes);
      tma_load(sm.q, &qmap, qt * kTile, h, b, &sm.qg_full);
      tma_load(sm.g, &gmap, qt * kTile, h, b, &sm.qg_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        bar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        bar_expect(&sm.full[s], 2 * kTileBytes);
        tma_load(sm.k[s], &kmap, t * kTile, h, b, &sm.full[s]);
        tma_load(sm.v[s], &vmap, t * kTile, h, b, &sm.full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);
  const int r_lo = qt * kTile + 16 * warp + (lane >> 2);
  const int c_lane = 2 * (lane & 3);
  const size_t bh_rows = (size_t)(b * H + h) * n_tiles * kTile;
  const float* brow = bias + (size_t)b * T;

  // D of rows r_lo, r_lo + 8: each lane of the quad sums 16 of the 64
  // (from device memory: the loads overlap the TMA of the Q and G tiles)
  float m2[2], l2[2], d_row[2];  // row max, log2 of the row sum, D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    float acc = 0.f;
    if (r < T) {
      const int c0 = 16 * (lane & 3);
      const uint4* gp = reinterpret_cast<const uint4*>(
          g + b * gs.b + h * gs.h + r * gs.t + c0);
      const uint4* op = reinterpret_cast<const uint4*>(
          out_exact + b * os.b + h * os.h + r * os.t + c0);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint4 gv = __ldg(gp + w), ov = __ldg(op + w);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(g2[e]);
          const float2 c = __bfloat1622float2(o2[e]);
          acc = fmaf(a.x, c.x, acc);
          acc = fmaf(a.y, c.y, acc);
        }
      }
    }
    d_row[i] = quad_sum(acc);
    if ((lane & 3) == 0) dbuf[bh_rows + r] = d_row[i];
    const float2 st = stats[bh_rows + r];
    m2[i] = st.x;
    l2[i] = st.y * kLog2e;
  }

  float dqa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  bar_wait(&sm.qg_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % kStages;
    float s[32], dp[32];  // s = q k_t^T, dp = g v_t^T
    score_pair(&sm.full[slot], t, s, sm.q, sm.k[slot], dp, sm.g, sm.v[slot]);
    // the mask of this thread's 32 elements, bit n for accumulator entry
    // n, handed to the dk/dv kernel (one word per thread and tile pair)
    uint32_t keep = 0;
    if (kDrop) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            keep |= (uint32_t)(mask((unsigned)(r_lo + 8 * i),
                                    (unsigned)(t * kTile + 8 * j + c_lane +
                                               e)) != 0.f)
                    << (4 * j + 2 * i + e);
      keep_out[((bh_rows / kTile + qt) * n_tiles + t) * 128 + tid] = keep;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t * kTile + 8 * j + c_lane + e;
        const float bv = col < T ? __ldg(brow + col) : -INFINITY;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          const float p =
              fast_exp2(fmaf((s[idx] + bv) - m2[i], kLog2e, -l2[i]));
          float dpv = dp[idx];
          if (kDrop) dpv = (keep >> idx) & 1u ? dpv * mask.scale : 0.f;
          s[idx] = p * (dpv - d_row[i]);
        }
      }
    uint32_t ds[16];
    to_operand(ds, s);
    wg_fence();
    tile_pb(dqa, ds, sm.k[slot]);
    wg_commit();
    wg_wait<0>();
    fence_regs(dqa);
    fence_regs(ds);
    bar_arrive(&sm.empty[slot]);
  }
  store_rows(dq, dqs, b, h, r_lo, T, c_lane, dqa);
}

// ------------------------------------------------------------- dk, dv ----

struct __align__(1024) DkvSmem {
  __nv_bfloat16 k[kTile * 64], v[kTile * 64];
  __nv_bfloat16 q[kStages][kTile * 64], g[kStages][kTile * 64];
  float2 stats[kStages][kTile];
  float d[kStages][kTile];
  uint32_t keep[kStages][128];  // the dq kernel's mask words of the tile pair
  uint64_t full[kStages], empty[kStages], kv_full;
};
constexpr size_t kDkvSmem = sizeof(DkvSmem) + 1024;

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
attention_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const float* __restrict__ bias,
                      const float2* __restrict__ stats,
                      const float* __restrict__ dbuf,
                      const uint32_t* __restrict__ keep_in,
                      __nv_bfloat16* __restrict__ dk, Strides dks,
                      __nv_bfloat16* __restrict__ dv, Strides dvs, int H,
                      int T, unsigned seed, unsigned seed_stride,
                      unsigned threshold, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (T + kTile - 1) / kTile;
  const size_t bh_rows = (size_t)(b * H + h) * n_tiles * kTile;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], 128);
    }
    bar_init(&sm.kv_full, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer ----
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&gmap);
      bar_expect(&sm.kv_full, 2 * kTileBytes);
      tma_load(sm.k, &kmap, kt * kTile, h, b, &sm.kv_full);
      tma_load(sm.v, &vmap, kt * kTile, h, b, &sm.kv_full);
      const uint32_t bytes = 2 * kTileBytes +
                             kTile * (sizeof(float2) + sizeof(float)) +
                             (kDrop ? 128 * sizeof(uint32_t) : 0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        bar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        bar_expect(&sm.full[s], bytes);
        tma_load(sm.q[s], &qmap, t * kTile, h, b, &sm.full[s]);
        tma_load(sm.g[s], &gmap, t * kTile, h, b, &sm.full[s]);
        bulk_load(sm.stats[s], stats + bh_rows + t * kTile,
                  kTile * sizeof(float2), &sm.full[s]);
        bulk_load(sm.d[s], dbuf + bh_rows + t * kTile, kTile * sizeof(float),
                  &sm.full[s]);
        if (kDrop)
          bulk_load(sm.keep[s],
                    keep_in + ((bh_rows / kTile + t) * n_tiles + kt) * 128,
                    128 * sizeof(uint32_t), &sm.full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 key rows ----
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);
  const int r_lo = kt * kTile + 16 * warp + (lane >> 2);  // key rows
  const int c_lane = 2 * (lane & 3);
  float kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    kb[i] = r < T ? __ldg(bias + (size_t)b * T + r) : -INFINITY;
  }

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  bar_wait(&sm.kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % kStages;
    // s^T = k q_t^T and dp^T = v g_t^T: rows keys, columns queries
    float st[32], dpt[32];
    score_pair(&sm.full[slot], t, st, sm.k, sm.q[slot], dpt, sm.v,
               sm.g[slot]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cq = 8 * j + c_lane + e;  // query within the tile
        const int qi = t * kTile + cq;
        const float2 rs = sm.stats[slot][cq];
        const float ll2 = rs.y * kLog2e;
        const float dq_row = sm.d[slot][cq];
        const bool valid = qi < T;
        // element (query cq, key row) sits in the dq kernel's thread
        // 32 (j / 2) + 4 (cq % 8) + (key % 8) / 2, at bit
        // 4 (key % 64 / 8) + 2 (j % 2) + key % 2
        const uint32_t word =
            kDrop ? sm.keep[slot][32 * (j / 2) + 4 * (c_lane + e) + (lane >> 3)]
                  : 0u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          float p = fast_exp2(fmaf((st[idx] + kb[i]) - rs.x, kLog2e, -ll2));
          p = valid ? p : 0.f;
          float dpv = dpt[idx], pd = p;
          if (kDrop) {
            const int bit = 4 * (2 * warp + i) + 2 * (j % 2) + ((lane >> 2) & 1);
            const float mv = (word >> bit) & 1u ? mask.scale : 0.f;
            dpv *= mv;
            pd *= mv;
          }
          st[idx] = pd;
          dpt[idx] = p * (dpv - dq_row);
        }
      }
    uint32_t pf[16], dsf[16];
    to_operand(pf, st);
    to_operand(dsf, dpt);
    wg_fence();
    tile_pb(dva, pf, sm.g[slot]);
    tile_pb(dka, dsf, sm.q[slot]);
    wg_commit();
    wg_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pf);
    fence_regs(dsf);
    bar_arrive(&sm.empty[slot]);
  }
  store_rows(dk, dks, b, h, r_lo, T, c_lane, dka);
  store_rows(dv, dvs, b, h, r_lo, T, c_lane, dva);
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <bool kDrop>
cudaError_t launch(const CUtensorMap* maps, const void* g, const long long* gs,
                   const void* out_exact, const long long* os,
                   const float* bias,
                   const float2* stats, float* dbuf, uint32_t* keep, void* dq,
                   const long long* dqs, void* dk, const long long* dks,
                   void* dv, const long long* dvs, int B, int H, int T,
                   unsigned seed, unsigned seed_stride, unsigned threshold,
                   float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_dq_kernel<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_dkdv_kernel<kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  attention_dq_kernel<kDrop><<<grid, kThreads, kDqSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3],
      static_cast<const __nv_bfloat16*>(g), strides_of(gs),
      static_cast<const __nv_bfloat16*>(out_exact), strides_of(os), bias, stats,
      dbuf, keep, static_cast<__nv_bfloat16*>(dq), strides_of(dqs), H, T, seed,
      seed_stride, threshold, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_dkdv_kernel<kDrop><<<grid, kThreads, kDkvSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, stats, dbuf, keep,
      static_cast<__nv_bfloat16*>(dk), strides_of(dks),
      static_cast<__nv_bfloat16*>(dv), strides_of(dvs), H, T, seed,
      seed_stride, threshold, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, g, out_exact, dq, dk, dv: (B, H, T, 64) bf16 with element
// strides (batch, head, row) in the matching *s array (out_exact: the
// forward's output with p unrounded); bias (B, T) fp32; stats the
// forward's (B, H, Tp, 2) row statistics; dbuf an fp32 (B, H, Tp) scratch
// that takes D (Tp = T rounded up to 64); keep a uint32 scratch of
// B * H * (Tp / 64)^2 * 128 words for the dropout mask (may be null at
// threshold 0); seed, seed_stride, threshold and scale as for
// attention_fwd. Launches
// the dq kernel, then the dk/dv kernel.
int attention_bwd(const void* q, const void* k, const void* v, const void* g,
                  const void* out_exact, const void* bias,
                  const void* stats, void* dbuf, void* keep, void* dq,
                  void* dk, void* dv,
                  const long long* qs, const long long* ks,
                  const long long* vs, const long long* gs,
                  const long long* os, const long long* dqs,
                  const long long* dks, const long long* dvs, int B, int H,
                  int T, int D, unsigned seed, unsigned seed_stride,
                  unsigned threshold, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* src[4] = {q, k, v, g};
  const long long* st[4] = {qs, ks, vs, gs};
  cudaError_t err = bind_device();
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = make_map(&maps[i], src[i], B, H, T, st[i][0], st[i][1], st[i][2]);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  const auto* sp = static_cast<const float2*>(stats);
  auto* d = static_cast<float*>(dbuf);
  auto* kp = static_cast<uint32_t*>(keep);
  if (threshold != 0u && kp == nullptr) return (int)cudaErrorInvalidValue;
  return (int)(threshold != 0u
                   ? launch<true>(maps, g, gs, out_exact, os, b, sp, d, kp, dq,
                                  dqs, dk, dks, dv, dvs, B, H, T, seed,
                                  seed_stride, threshold, scale, s)
                   : launch<false>(maps, g, gs, out_exact, os, b, sp, d, kp, dq,
                                   dqs, dk, dks, dv, dvs, B, H, T, seed,
                                   seed_stride, threshold, scale, s));
}

}  // extern "C"
