// Masked-softmax self-attention, forward, in fp32, for Hopper (sm_90a).
//
// The fp32 counterpart of attention_fwd.cu, which replaces the forward
// body of the Pallas kernel `_fwd_kernel` in
// wav2vec_contr_loss_tpu/ops/attention_pallas.py. It computes what the
// port's plain version computes with fp32 q/k/v (ops/attention.py
// `fused_attention_plain`, and JAX's default XLA attention in fp32):
//   out = (p * mask) . v,  p = softmax(q . k^T + bias)
// with fp32-accurate products, fp32 softmax and an fp32 output; nothing
// is rounded to bf16 (the Pallas kernel rounds q, k, v and p to bf16
// before each product even under fp32 I/O; the port does not). q, k, v,
// out: (B, H, T, 64) fp32 given by element strides (the head dim
// contiguous, the other strides multiples of 4, 16-byte aligned), so the
// (B, H, T, 64) view of a (B, T, H, 64) projection output goes in without
// a copy. q arrives pre-scaled; bias is the fp32 (B, T) additive key mask
// (0 or -1e30), so a fully masked row comes out uniform, as in JAX.
//
// For the backward it writes the same row statistics as the bf16
// kernel: fp32 (B, H, Tp, 2), Tp = T rounded up to 64, the row max m and
// log l (l the sum of exp(s - m)), for every row of the last tile too.
// The bf16 kernel also writes out_exact, the output with p unrounded; in
// fp32 that is `out` itself, so this kernel writes no second output and
// the backward reads `out`.
//
// Bound on an H100 at the training shape (B=32, H=16, T=249): q, k, v
// and out are 130.6 MB (0.039 ms at 3.35 TB/s); the two products are
// 8.1 GFLOP, 0.121 ms at the 67 TFLOP/s fp32 FFMA peak, or three TF32
// products each, 24.4 GFLOP, 0.049 ms at the 494.7 TFLOP/s TF32 peak. So
// it is bound by operations, and by far less on the tensor cores.
//
// Design (3xTF32 on the tensor cores, f32_tiles.cuh; FFMA tiles running
// three products took 0.473 ms on the H100, slower than SDPA's fp32
// kernel, PERF.md):
//   * grid (query tile of 64 rows, head, batch), one warpgroup a block;
//     98 KB of shared memory and ~200 registers a thread, two blocks an
//     SM, so one block's products overlap the other's softmax and splits.
//   * one pass with an online softmax over 64-key tiles (no cap on T):
//     the running row max m and sum l, the accumulator rescaled by
//     exp(m_old - m_new) tile by tile; the murmur dropout mask
//     (dropout_mask.cuh, with the per-batch seed stride) multiplies the
//     unnormalized exp(s - m) before p . v, and the output is divided by
//     l once at the end: two products, where two passes take three. A
//     row's m is finite from the first tile on (key 0 is below T and the
//     bias finite), and m_old = -inf contributes exp(-inf) = 0.
//   * both products by wgmma (`abt3`, 24 m64n64k8 a tile, A in
//     registers): S = q . k^T with q split once into hi/lo registers and
//     K as hi/lo tiles; O += p . v with p, S's accumulator, split in
//     registers and V split transposed (tf32 wgmma takes no transposed
//     operand). p . v on mma.sync, reading V's tiles row by row instead,
//     ran slower on the H100: its loads and 255 registers the cost.
//   * K and V tiles land by TMA (128-byte swizzle, rows past T as zeros)
//     in two raw slots, one for K and one for V, each behind an mbarrier;
//     a slot is split into its hi/lo tiles and given back at once, so the
//     next tile's load runs under the current tile's products.

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

struct __align__(1024) Smem {
  float raw[2][kTileFloats];   // TMA: [0] the K tiles; [1] Q, then V tiles
  float k_hi[kTileFloats], k_lo[kTileFloats];
  float v_hi[kTileFloats], v_lo[kTileFloats];
  uint64_t full[2];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + base alignment

template <bool kDrop, bool kResid>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ bias,
                         float* __restrict__ out, Strides os,
                         float* __restrict__ stats, int H, int T,
                         unsigned seed, unsigned seed_stride,
                         unsigned threshold, float scale) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int q0 = qt * kTile;
  const int r_lo = 16 * warp + (lane >> 2);  // rows r_lo and r_lo + 8
  const int c_lane = 2 * (lane & 3);         // columns 8j + c_lane (+1)

  if (tid == 0) {
    bar_init(&sm.full[0], 1);
    bar_init(&sm.full[1], 1);
    bar_init_fence();
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    load_tile(sm.raw[1], &qmap, q0, h, b, &sm.full[1]);
    load_tile(sm.raw[0], &kmap, 0, h, b, &sm.full[0]);
  }
  __syncthreads();
  const float* brow = bias + (size_t)b * T;
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);

  uint32_t q_hi[32], q_lo[32];
  bar_wait(&sm.full[1], 0);
  a_frags(sm.raw[1], q_hi, q_lo, warp, lane);
  __syncthreads();  // every thread has read Q
  if (tid == 0) {
    fence_proxy_async();
    load_tile(sm.raw[1], &vmap, 0, h, b, &sm.full[1]);
  }

  float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTile;
    // K tile t into k_hi/k_lo; tile t-1's score product, their last
    // reader, finished in every thread before the barrier of its V split
    bar_wait(&sm.full[0], t & 1);
    split_tile(sm.raw[0], sm.k_hi, sm.k_lo, tid);
    fence_proxy_async();  // wgmma reads the split
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles)
      load_tile(sm.raw[0], &kmap, c0 + kTile, h, b, &sm.full[0]);

    float s[32], bv[16];
    wg_fence();
    abt3(s, q_hi, q_lo, sm.k_hi, sm.k_lo);
    wg_commit();
    column_bias(bv, brow, c0, c_lane, T);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(q_hi);
    fence_regs(q_lo);

    // online softmax: s + bias, the new row max, p = exp(s - m) in s,
    // l and o rescaled to it; then the dropout mask on p
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] += bv[2 * j + e];
        s[4 * j + 2 + e] += bv[2 * j + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      const float m_sub = m_new == -INFINITY ? 0.f : m_new;
      const float corr = fast_exp2((m[i] - m_sub) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = fast_exp2((x - m_sub) * kLog2e);
          sum += x;
          o[4 * j + 2 * i + e] *= corr;
          if (kDrop)
            x *= mask((unsigned)(q0 + r_lo + 8 * i),
                      (unsigned)(c0 + 8 * j + c_lane + e));
        }
      l[i] = l[i] * corr + quad_sum(sum);
      m[i] = m_new;
    }

    // V tile t, transposed, into v_hi/v_lo; tile t-1's p . v, their last
    // reader, finished in every thread before the barrier of this tile's
    // K split
    bar_wait(&sm.full[1], (t + 1) & 1);
    split_tile_t(sm.raw[1], sm.v_hi, sm.v_lo, tid);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles)
      load_tile(sm.raw[1], &vmap, c0 + kTile, h, b, &sm.full[1]);
    uint32_t p_hi[32], p_lo[32];
    p_frags(s, p_hi, p_lo);
    wg_fence();
    abt3(o, p_hi, p_lo, sm.v_hi, sm.v_lo, true);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
  }

  // out = o / l for the rows below T; the row statistics of every row of
  // the tile (rows past T too: the backward reads them)
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  store_rows(out, os, b, h, q0, T, warp, lane, o, inv_l);
  if (kResid && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      reinterpret_cast<float2*>(stats)[(size_t)(b * H + h) * n_tiles * kTile +
                                       q0 + r_lo + 8 * i] =
          make_float2(m[i], logf(l[i]));
  }
}

template <bool kDrop, bool kResid>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const float* bias, float* out,
                   Strides os, float* stats, int B, int H, int T,
                   unsigned seed, unsigned seed_stride, unsigned threshold,
                   float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_f32_kernel<kDrop, kResid>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  attention_fwd_f32_kernel<kDrop, kResid>
      <<<grid, kThreads, kSmemBytes, stream>>>(
      qm, km, vm, bias, out, os, stats, H, T, seed, seed_stride, threshold,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (B, H, T, 64) fp32 with element strides {q,k,v,o}s =
// (batch, head, row), each a positive multiple of 4 below 2^38, and
// 16-byte aligned data; bias (B, T) fp32 contiguous; stats: fp32
// (B, H, Tp, 2) contiguous, Tp = T rounded up to 64, or null (no backward
// residuals); seed, seed_stride, threshold and scale as for
// attention_fwd.
int attention_fwd_f32(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* stats,
                      const long long* qs, const long long* ks,
                      const long long* vs, const long long* os, int B, int H,
                      int T, int D, unsigned seed, unsigned seed_stride,
                      unsigned threshold, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  cudaError_t err = bind_device();
  if (err == cudaSuccess)
    err = make_map(&qm, q, B, H, T, qs[0], qs[1], qs[2], true);
  if (err == cudaSuccess)
    err = make_map(&km, k, B, H, T, ks[0], ks[1], ks[2], true);
  if (err == cudaSuccess)
    err = make_map(&vm, v, B, H, T, vs[0], vs[1], vs[2], true);
  if (err != cudaSuccess) return (int)err;
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* st = static_cast<float*>(stats);
  const Strides o{os[0], os[1], os[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u, resid = st != nullptr;
#define W2V_LAUNCH(D, R)                                                    \
  launch<D, R>(qm, km, vm, bp, op, o, st, B, H, T, seed, seed_stride,       \
               threshold, scale, s)
  return (int)(drop ? (resid ? W2V_LAUNCH(true, true) : W2V_LAUNCH(true, false))
                    : (resid ? W2V_LAUNCH(false, true)
                             : W2V_LAUNCH(false, false)));
#undef W2V_LAUNCH
}

}  // extern "C"
