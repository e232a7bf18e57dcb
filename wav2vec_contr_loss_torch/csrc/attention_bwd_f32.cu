// Masked-softmax self-attention, backward, in fp32, for Hopper (sm_90a).
//
// The fp32 counterpart of attention_bwd.cu, which replaces the Pallas
// kernel `_bwd_kernel` in wav2vec_contr_loss_tpu/ops/attention_pallas.py.
// From the residuals of attention_fwd_f32.cu (q, k, v, the fp32 (B, T)
// key bias, the row statistics (m, log l), the output `out`, the dropout
// seed) and the output cotangent g, all fp32, it recomputes
// p = exp(q . k^T + bias - m - log l) and the murmur dropout mask
// (dropout_mask.cuh), stores no probability, and computes with
// fp32-accurate products what autograd of the plain version computes
// (nothing rounded to bf16):
//   dv = (p * mask)^T . g
//   dp = (g . v^T) * mask
//   ds = p * (dp - D),  D_i = rowsum(g_i * out_i)
//   dq = ds . k,   dk = ds^T . q
// D is FlashAttention's identity, sum_j dp_ij p_ij = g_i . (p mask v)_i;
// in fp32 `out` is the bf16 kernel's out_exact.
//
// Bound on an H100 at the training shape (B=32, H=16, T=249): it moves
// q, k, v, g, out, dq, dk and dv once, 261 MB (0.078 ms at 3.35 TB/s);
// its five T x T x 64 products (s, dp, dv, dq, dk) are 20.3 GFLOP, 0.303
// ms at the 67 TFLOP/s fp32 FFMA peak, or three TF32 products each, 61.0
// GFLOP, 0.123 ms at the 494.7 TFLOP/s TF32 peak: bound by operations.
//
// Design: 3xTF32 on the tensor cores (f32_tiles.cuh; FFMA tiles took 1.003
// ms on the H100, slower than SDPA's fp32 backward), in two kernels of two
// warpgroups a block, each warpgroup 64 rows of its own. No atomics:
// every output element is written once by one block, so two calls give
// the same bits. Every product is wgmma (`abt3`): products over the head
// dim (s, dp) take natural hi/lo tiles, or registers for the operand a
// warpgroup keeps; products over keys or queries (dq, dv, dk) take the
// accumulator of ds or p as the register A operand and the other operand
// split transposed. Tiles land by TMA in two raw slots (128-byte swizzle,
// rows past T as zeros), each behind an mbarrier; each warpgroup splits
// one slot into the tiles both share and gives it back at once, so the
// next tile's loads run under the current tile's products. One block an
// SM (192 and 224 KB of shared memory), eight warps; with no other block
// to switch to, the key bias, the row statistics and D are loaded while
// the products run, not after their wait.
//   1. dq kernel, grid (pair of query tiles, head, batch): each
//      warpgroup's Q as registers and its G as a hi/lo tile, D of its rows
//      from G and `out` (written out for kernel 2); for each key tile
//      s = q k_t^T and dp = g v_t^T, ds = p (dp mask - D) in registers,
//      dq += ds . k_t.
//   2. dk/dv kernel, grid (pair of key tiles, head, batch): each
//      warpgroup's K as registers and its V as a hi/lo tile; for each
//      query tile s^T = k q_t^T and dp^T = v g_t^T, the row statistics
//      and D of those queries from device memory, p^T * mask and ds^T in
//      registers, dv += (p^T mask) . g_t and dk += ds^T . q_t. The mask is
//      hashed again here.
// Seven products where five would do (the scores and dp are formed in
// both kernels): the price of no atomics. The pair of warpgroups halves
// the splits of the shared tiles a row and doubles the warps an SM; one
// warpgroup a block ran slower on the H100 by about half.

#include <cuda.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "dropout_mask.cuh"
#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace f32;

constexpr int kBwdThreads = 2 * kThreads;  // two warpgroups a block

// dq kernel: 128 query rows a block, 64 a warpgroup w; its Q as registers
// (`a_frags`), its G tile as g[w]; the key tile's K, K transposed and V
// shared by both.
struct __align__(1024) DqSmem {
  float raw[2][kTileFloats];  // TMA: Q, G of warpgroup 0 / 1, then K / V
  float g_hi[2][kTileFloats], g_lo[2][kTileFloats];
  float k_hi[kTileFloats], k_lo[kTileFloats];
  float kt_hi[kTileFloats], kt_lo[kTileFloats];
  float v_hi[kTileFloats], v_lo[kTileFloats];
  uint64_t full[2];
};

// dk/dv kernel: 128 keys a block, 64 a warpgroup w; its K as registers,
// its V tile as v[w]; the query tile's Q and G, and both transposed,
// shared by both.
struct __align__(1024) DkvSmem {
  float raw[2][kTileFloats];  // TMA: K, V of warpgroup 0 / 1, then Q / G
  float v_hi[2][kTileFloats], v_lo[2][kTileFloats];
  float q_hi[kTileFloats], q_lo[kTileFloats];
  float qt_hi[kTileFloats], qt_lo[kTileFloats];
  float g_hi[kTileFloats], g_lo[kTileFloats];
  float gt_hi[kTileFloats], gt_lo[kTileFloats];
  uint64_t full[2];
};

template <class S>
__device__ __forceinline__ S& smem(unsigned char* raw) {
  return *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

template <class S>
__device__ __forceinline__ void init_bars(S& sm) {
  bar_init(&sm.full[0], 1);
  bar_init(&sm.full[1], 1);
  bar_init_fence();
}

// d += P . B, 3xTF32 by wgmma, waited for: P an accumulator tile (its
// register A operand by `p_frags`), B given transposed (`split_tile_t`)
__device__ __forceinline__ void pb_product(float (&d)[32], const float (&p)[32],
                                           const float* bt_hi,
                                           const float* bt_lo) {
  uint32_t p_hi[32], p_lo[32];
  p_frags(p, p_hi, p_lo);
  wg_fence();
  abt3(d, p_hi, p_lo, bt_hi, bt_lo, true);
  wg_commit();
  wg_wait<0>();
  fence_regs(d);
  fence_regs(p_hi);
  fence_regs(p_lo);
}

// ---------------------------------------------------------------- dq ----

template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 1)
attention_dq_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap gmap,
                        const float* __restrict__ out, Strides os,
                        const float* __restrict__ bias,
                        const float2* __restrict__ stats,
                        float* __restrict__ dbuf, float* __restrict__ dq,
                        Strides dqs, int H, int T, unsigned seed,
                        unsigned seed_stride, unsigned threshold,
                        float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = smem<DqSmem>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int n_tiles = (T + kTile - 1) / kTile, tp = n_tiles * kTile;
  const int b0 = 2 * kTile * blockIdx.x, q0 = b0 + kTile * wg;
  const int r_lo = 16 * warp + (lane >> 2), c_lane = 2 * (lane & 3);
  const size_t bh_rows = (size_t)(b * H + h) * tp;
  const float* brow = bias + (size_t)b * T;
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);
  // slot w holds warpgroup w's Q (use 0) and G (use 1), then slot 0 the K
  // tiles and slot 1 the V tiles (key tile t: use t + 2)
  if (tid == 0) {
    init_bars(sm);
    load_tile(sm.raw[0], &qmap, b0, h, b, &sm.full[0]);
    load_tile(sm.raw[1], &qmap, b0 + kTile, h, b, &sm.full[1]);
  }
  __syncthreads();
  uint32_t q_hi[32], q_lo[32];
  bar_wait(&sm.full[wg], 0);
  a_frags(sm.raw[wg], q_hi, q_lo, warp, lane);
  __syncthreads();  // both Q tiles read
  if (tid == 0) {
    fence_proxy_async();
    load_tile(sm.raw[0], &gmap, b0, h, b, &sm.full[0]);
    load_tile(sm.raw[1], &gmap, b0 + kTile, h, b, &sm.full[1]);
  }
  bar_wait(&sm.full[wg], 1);
  split_tile(sm.raw[wg], sm.g_hi[wg], sm.g_lo[wg], wtid);
  // D of rows r_lo and r_lo + 8 (0 past T, where g reads as zeros): the
  // 4 lanes of a quad take 16 columns each of G (raw) and out. Rows past
  // Tp (the second warpgroup of the last block) have no statistics.
  float d_row[2], m[2], ll[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    float acc = 0.f;
    if (q0 + r < T) {
      const float* orow = out + b * os.b + h * os.h + (q0 + r) * os.t;
#pragma unroll
      for (int c = 16 * (lane & 3); c < 16 * (lane & 3) + 16; c += 4) {
        const float4 gv = *reinterpret_cast<const float4*>(
            sm.raw[wg] + at(r, c));
        const float4 ov = __ldg(reinterpret_cast<const float4*>(orow + c));
        acc = fmaf(gv.x, ov.x, acc);
        acc = fmaf(gv.y, ov.y, acc);
        acc = fmaf(gv.z, ov.z, acc);
        acc = fmaf(gv.w, ov.w, acc);
      }
    }
    d_row[i] = quad_sum(acc);
    m[i] = ll[i] = 0.f;
    if (q0 + r < tp) {
      if ((lane & 3) == 0) dbuf[bh_rows + q0 + r] = d_row[i];
      const float2 st = stats[bh_rows + q0 + r];
      m[i] = st.x;
      ll[i] = st.y;
    }
  }
  fence_proxy_async();
  __syncthreads();  // the G tiles split, the raw slots read
  if (tid == 0) {
    load_tile(sm.raw[0], &kmap, 0, h, b, &sm.full[0]);
    load_tile(sm.raw[1], &vmap, 0, h, b, &sm.full[1]);
  }

  float dqa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTile;
    // warpgroup 0 splits K (and K transposed), warpgroup 1 V; the last
    // readers of the previous ones passed the barrier that ends the loop
    bar_wait(&sm.full[wg], t & 1);
    if (wg == 0) {
      split_tile(sm.raw[0], sm.k_hi, sm.k_lo, wtid);
      split_tile_t(sm.raw[0], sm.kt_hi, sm.kt_lo, wtid);
    } else {
      split_tile(sm.raw[1], sm.v_hi, sm.v_lo, wtid);
    }
    fence_proxy_async();  // wgmma reads the splits; TMA rewrites the slots
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) {
      load_tile(sm.raw[0], &kmap, c0 + kTile, h, b, &sm.full[0]);
      load_tile(sm.raw[1], &vmap, c0 + kTile, h, b, &sm.full[1]);
    }
    float s[32], dp[32], bv[16];
    wg_fence();
    abt3(s, q_hi, q_lo, sm.k_hi, sm.k_lo);
    abt3(dp, sm.g_hi[wg], sm.g_lo[wg], sm.v_hi, sm.v_lo);
    wg_commit();
    column_bias(bv, brow, c0, c_lane, T);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(q_hi);
    fence_regs(q_lo);
    // ds = p (dp mask - D) into dp
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + c_lane + e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 4 * j + 2 * i + e;
          const float p =
              fast_exp2(((s[k] + bv[2 * j + e]) - m[i] - ll[i]) * kLog2e);
          float dpv = dp[k];
          if (kDrop) dpv *= mask((unsigned)(q0 + r_lo + 8 * i), (unsigned)col);
          dp[k] = p * (dpv - d_row[i]);
        }
      }
    pb_product(dqa, dp, sm.kt_hi, sm.kt_lo);
    __syncthreads();  // every thread is done with this key tile
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dq, dqs, b, h, q0, T, warp, lane, dqa, one);
}

// ------------------------------------------------------------- dk, dv ----

template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 1)
attention_dkdv_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap gmap,
                          const float* __restrict__ bias,
                          const float2* __restrict__ stats,
                          const float* __restrict__ dbuf,
                          float* __restrict__ dk, Strides dks,
                          float* __restrict__ dv, Strides dvs, int H, int T,
                          unsigned seed, unsigned seed_stride,
                          unsigned threshold, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = smem<DkvSmem>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int b0 = 2 * kTile * blockIdx.x, k0 = b0 + kTile * wg;
  const int r_lo = 16 * warp + (lane >> 2), c_lane = 2 * (lane & 3);
  const size_t bh_rows = (size_t)(b * H + h) * n_tiles * kTile;
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);
  // slot w holds warpgroup w's K (use 0) and V (use 1), then slot 0 the Q
  // tiles and slot 1 the G tiles (query tile t: use t + 2)
  if (tid == 0) {
    init_bars(sm);
    load_tile(sm.raw[0], &kmap, b0, h, b, &sm.full[0]);
    load_tile(sm.raw[1], &kmap, b0 + kTile, h, b, &sm.full[1]);
  }
  __syncthreads();
  uint32_t k_hi[32], k_lo[32];
  bar_wait(&sm.full[wg], 0);
  a_frags(sm.raw[wg], k_hi, k_lo, warp, lane);
  __syncthreads();  // both K tiles read
  if (tid == 0) {
    fence_proxy_async();
    load_tile(sm.raw[0], &vmap, b0, h, b, &sm.full[0]);
    load_tile(sm.raw[1], &vmap, b0 + kTile, h, b, &sm.full[1]);
  }
  bar_wait(&sm.full[wg], 1);
  split_tile(sm.raw[wg], sm.v_hi[wg], sm.v_lo[wg], wtid);
  fence_proxy_async();
  __syncthreads();  // the V tiles split, the raw slots read
  if (tid == 0) {
    load_tile(sm.raw[0], &qmap, 0, h, b, &sm.full[0]);
    load_tile(sm.raw[1], &gmap, 0, h, b, &sm.full[1]);
  }
  float kb[2];  // the bias of key rows r_lo and r_lo + 8 (-inf past T)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + r_lo + 8 * i;
    kb[i] = r < T ? __ldg(bias + (size_t)b * T + r) : -INFINITY;
  }

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTile;
    // warpgroup 0 splits Q (and Q transposed), warpgroup 1 G (and G
    // transposed); the last readers of the previous ones passed the
    // barrier that ends the loop
    bar_wait(&sm.full[wg], t & 1);
    if (wg == 0) {
      split_tile(sm.raw[0], sm.q_hi, sm.q_lo, wtid);
      split_tile_t(sm.raw[0], sm.qt_hi, sm.qt_lo, wtid);
    } else {
      split_tile(sm.raw[1], sm.g_hi, sm.g_lo, wtid);
      split_tile_t(sm.raw[1], sm.gt_hi, sm.gt_lo, wtid);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) {
      load_tile(sm.raw[0], &qmap, c0 + kTile, h, b, &sm.full[0]);
      load_tile(sm.raw[1], &gmap, c0 + kTile, h, b, &sm.full[1]);
    }
    // rows: keys r_lo (+8); columns: queries 8j + c_lane (+1)
    // the row statistics and D of this thread's 16 query columns, loaded
    // while the products run
    float st[32], dpt[32], d_q[16];
    float2 rs[16];
    wg_fence();
    abt3(st, k_hi, k_lo, sm.q_hi, sm.q_lo);
    abt3(dpt, sm.v_hi[wg], sm.v_lo[wg], sm.g_hi, sm.g_lo);
    wg_commit();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const size_t qi = bh_rows + c0 + 8 * j + c_lane + e;
        rs[2 * j + e] = __ldg(stats + qi);
        d_q[2 * j + e] = __ldg(dbuf + qi);
      }
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(k_hi);
    fence_regs(k_lo);
    // p^T mask into st, ds^T into dpt
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = c0 + 8 * j + c_lane + e;
        const float2 r = rs[2 * j + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 4 * j + 2 * i + e;
          float p = fast_exp2(((st[k] + kb[i]) - r.x - r.y) * kLog2e);
          p = qi < T ? p : 0.f;
          const float mk =
              kDrop ? mask((unsigned)qi, (unsigned)(k0 + r_lo + 8 * i)) : 1.f;
          st[k] = p * mk;
          dpt[k] = p * (dpt[k] * mk - d_q[2 * j + e]);
        }
      }
    pb_product(dva, st, sm.gt_hi, sm.gt_lo);
    pb_product(dka, dpt, sm.qt_hi, sm.qt_lo);
    __syncthreads();  // every thread is done with this query tile
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dk, dks, b, h, k0, T, warp, lane, dka, one);
  store_rows(dv, dvs, b, h, k0, T, warp, lane, dva, one);
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

constexpr size_t kDqSmem = sizeof(DqSmem) + 1024;    // + base alignment
constexpr size_t kDkvSmem = sizeof(DkvSmem) + 1024;

template <bool kDrop>
cudaError_t launch(const CUtensorMap* maps, const float* out, Strides os,
                   const float* bias, const float2* stats, float* dbuf,
                   float* const* grads, const long long* const* gst, int B,
                   int H, int T, unsigned seed, unsigned seed_stride,
                   unsigned threshold, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_dq_f32_kernel<kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_dkdv_f32_kernel<kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kDkvSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (T + kTile - 1) / kTile;
  // maps: q, k, v, g; grads: dq, dk, dv
  attention_dq_f32_kernel<kDrop>
      <<<dim3((n_tiles + 1) / 2, H, B), kBwdThreads, kDqSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], out, os, bias, stats, dbuf,
      grads[0], strides_of(gst[0]), H, T, seed, seed_stride, threshold,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_dkdv_f32_kernel<kDrop>
      <<<dim3((n_tiles + 1) / 2, H, B), kBwdThreads, kDkvSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, stats, dbuf, grads[1],
      strides_of(gst[1]), grads[2], strides_of(gst[2]), H, T, seed,
      seed_stride, threshold, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, g, out, dq, dk, dv: (B, H, T, 64) fp32 with element strides
// (batch, head, row) in the matching *s array, each a positive multiple
// of 4 below 2^38, and 16-byte aligned data (out: the forward's output);
// bias (B, T) fp32; stats the forward's (B, H, Tp, 2) row statistics;
// dbuf an fp32 (B, H, Tp) scratch that takes D (Tp = T rounded up to 64);
// seed, seed_stride, threshold and scale as for attention_fwd. Launches
// the dq kernel, then the dk/dv kernel.
int attention_bwd_f32(const void* q, const void* k, const void* v,
                      const void* g, const void* out, const void* bias,
                      const void* stats, void* dbuf, void* dq, void* dk,
                      void* dv, const long long* qs, const long long* ks,
                      const long long* vs, const long long* gs,
                      const long long* os, const long long* dqs,
                      const long long* dks, const long long* dvs, int B,
                      int H, int T, int D, unsigned seed,
                      unsigned seed_stride, unsigned threshold, float scale,
                      void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* in[4] = {q, k, v, g};
  const long long* st[4] = {qs, ks, vs, gs};
  cudaError_t err = bind_device();
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = make_map(&maps[i], in[i], B, H, T, st[i][0], st[i][1], st[i][2],
                   true);
  if (err != cudaSuccess) return (int)err;
  float* grads[3] = {static_cast<float*>(dq), static_cast<float*>(dk),
                     static_cast<float*>(dv)};
  const long long* gst[3] = {dqs, dks, dvs};
  const auto* o = static_cast<const float*>(out);
  const auto* b = static_cast<const float*>(bias);
  const auto* sp = static_cast<const float2*>(stats);
  auto* d = static_cast<float*>(dbuf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(threshold != 0u
                   ? launch<true>(maps, o, strides_of(os), b, sp, d, grads,
                                  gst, B, H, T, seed, seed_stride, threshold,
                                  scale, s)
                   : launch<false>(maps, o, strides_of(os), b, sp, d, grads,
                                   gst, B, H, T, seed, seed_stride,
                                   threshold, scale, s));
}

}  // extern "C"
