// Masked-softmax self-attention, forward, for Hopper (sm_90a).
//
// Replaces the forward body of the Pallas kernel `_fwd_kernel` in
// wav2vec_contr_loss_tpu/ops/attention_pallas.py:
//   out = bf16(p * mask) . v,  p = softmax_fp32(q . k^T + bias)
// with bf16 q/k/v (B, H, T, D) given by element strides (the head dim
// contiguous, so a (B, T, H, D) projection output needs no copy), D = 64
// (XLS-R 300M, large-960h), 80 (XLS-R 1B) or 120 (XLS-R 2B), q
// pre-scaled by 1/sqrt(D), an fp32 (B, T) additive key bias (0 or
// -1e30), fp32 accumulation and a bf16 output written through its own
// strides. The max-subtracted softmax makes a fully masked row uniform,
// as in JAX. For the backward it also writes each row's softmax
// statistics, fp32 (B, H, Tp, 2) with Tp = T rounded up to 64: the row
// max m and log l (l the sum of exp(x - m)), whose sum is the row's
// log-sum-exp. The two are kept apart because the -1e30 bias of a clip
// with no valid key would absorb log l in one fp32 number. With them it
// writes out_exact = bf16((p mask) . v) with p not rounded to bf16 (p's
// lost bits go through a second product), so the backward's
// D = rowsum(g * out_exact) is Pallas' sum of p * dp up to one bf16
// rounding of the output, not one of every p.
//
// Bound on an H100 at the training shape (B=32, H=16, T=249): q, k, v
// and out are 65 MB (19.5 us at 3.35 TB/s); the two products 8.1 GFLOP
// (8.2 us at the bf16 peak). Per score it also takes an exp on the SFU
// (16 a clock an SM: 9 us for the 33 M scores; 1.75 of them here, below)
// and, with dropout, the murmur hash (~12 integer operations at 64 a
// clock an SM: 27 us). So bytes, exp and hash are of one size, and what
// the kernel must avoid is sending the (T, T) scores through device
// memory.
//
// Design (FlashAttention-3's shape, with Pallas' rounding):
//   * grid (query tile of 64 rows, head, batch); a block is one consumer
//     warpgroup (the 64 query rows) and one producer warp, 58 KB of
//     shared memory (the Q tile and a ring of 6 K/V tiles) and at most
//     128 registers a thread, so three blocks share an SM and one block's
//     loads and products overlap another's softmax. The variant that also
//     writes the backward's residuals carries a second accumulator and
//     runs two blocks an SM.
//   * the producer's lane 0 loads Q, then K and V tiles of 64 keys by TMA
//     (128-byte swizzle, rows past T read as zeros) into the ring, each
//     slot guarded by a full and an empty mbarrier.
//   * S = q . k^T by wgmma (m64n64k16, both operands in shared memory),
//     fp32 in registers, softmax in registers: a row lives in the 4 lanes
//     of a quad, max and sum by two shuffles, exp2 on the SFU.
//   * p is normalized exactly before the murmur mask (dropout_mask.cuh,
//     hashed in registers) and its bf16 rounding, as Pallas rounds it:
//     pass 1 takes the row statistics tile by tile; pass 2 forms p and
//     out += p . v by wgmma with p as the register A operand (the
//     accumulator of S turned into bf16 pairs in place) and V, MN-major,
//     from shared memory. The last key tile's exp(s) stays in registers
//     from pass 1; the other tiles' scores are computed again (at T =
//     249, 1.75 score products and exps per score). Holding 128 or all
//     256 keys of a 5 s clip in registers instead (64 or 128 a thread)
//     leaves two blocks an SM or spills, and ran slower on the H100 than
//     this recompute at three (PERF.md).
//   * D = 80 and 120 (hopper.cuh HeadDim): a row is two 64-column tiles,
//     q . k^T takes 5 / 8 k16 steps over them (at 120 the last one over
//     TMA's zeros past the row), p . v one m64n80 / m64n120 product a
//     step. Each tile is 16 KB and the O accumulators 40 / 60 registers a
//     thread, so a block has a ring of 5 tiles (98 KB) and two blocks
//     share an SM; at 120 with out_exact's accumulator (60 more) one block
//     an SM at up to 255 registers: at two (168 registers) it spilled
//     868 bytes a thread and took 0.257 ms at (32, 16, 249, 120) against
//     0.237 ms at one (H100, PERF.md).

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

constexpr int kThreads = 160;   // one consumer warpgroup + a producer warp

// K/V ring slots of one 64-key tile each
template <int D>
constexpr int kStages = D == 64 ? 6 : 5;

template <int D>
struct __align__(1024) Smem {
  __nv_bfloat16 q[HeadDim<D>::kElems];
  __nv_bfloat16 ring[kStages<D>][HeadDim<D>::kElems];
  uint64_t full[kStages<D>], empty[kStages<D>], q_full;
};
template <int D>
constexpr size_t kSmemBytes = sizeof(Smem<D>) + 1024;  // + base alignment

// blocks an SM: at D = 64 three, two with the residuals' accumulator; at
// 80 and 120 two (shared memory), one at 120 with the residuals'
// accumulator (registers)
template <int D, bool kResid>
constexpr int kBlocks =
    D == 64 ? (kResid ? 2 : 3) : (kResid && D == 120 ? 1 : 2);

// What a consumer thread carries through the key tiles of its query tile.
template <int D>
struct Ctx {
  Smem<D>* sm;
  const float* brow;  // the key bias of this batch element
  int T, r_lo, c_lane;
  int it;             // ring position: tiles consumed so far

  __device__ __forceinline__ int slot() const { return it % kStages<D>; }
  __device__ __forceinline__ void wait() {
    bar_wait(&sm->full[slot()], (it / kStages<D>) & 1);
  }
  __device__ __forceinline__ void release() {
    bar_arrive(&sm->empty[slot()]);
    ++it;
  }
};

// s = q . k^T + bias for key tile t (the K tile next in the ring)
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], Ctx<D>& cx, int t) {
  cx.wait();
  wg_fence();
  tile_abt_d<D>(s, cx.sm->q, cx.sm->ring[cx.slot()]);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  cx.release();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = t * kTile + 8 * j + cx.c_lane + e;
      const float bv = col < cx.T ? __ldg(cx.brow + col) : -INFINITY;
      s[4 * j + e] += bv;
      s[4 * j + 2 + e] += bv;
    }
}

// s <- exp(s - mx) per row (i = 0: row r_lo, i = 1: row r_lo + 8); the
// row sums of the tile into `sum`
__device__ __forceinline__ void tile_exp(float (&s)[32], const float (&mx)[2],
                                         float (&sum)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = fast_exp2((x - mx[i]) * kLog2e);
        l += x;
      }
    sum[i] = quad_sum(l);
  }
}

// o += bf16(s * scale * mask) . v for key tile t (the V tile next in the
// ring); with kResid also o_lo += (what that bf16 rounding dropped) . v,
// so o + o_lo is (s * scale * mask) . v with p unrounded
template <int D, bool kDrop, bool kResid>
__device__ __forceinline__ void accumulate_pv(float (&o)[HeadDim<D>::kAcc],
                                              float (&o_lo)[HeadDim<D>::kAcc],
                                              float (&s)[32], Ctx<D>& cx,
                                              int t, const float (&scale)[2],
                                              const DropoutMask& mask) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x *= scale[i];
        if (kDrop)
          x *= mask((unsigned)(cx.r_lo + 8 * i),
                    (unsigned)(t * kTile + 8 * j + cx.c_lane + e));
      }
  uint32_t p[16], p_lo[16];
  if (kResid)
    to_operand_split(p, p_lo, s);
  else
    to_operand(p, s);
  cx.wait();
  wg_fence();
  tile_pb_d<D>(o, p, cx.sm->ring[cx.slot()]);
  if (kResid) tile_pb_d<D>(o_lo, p_lo, cx.sm->ring[cx.slot()]);
  wg_commit();
  wg_wait<0>();
  fence_regs(o);
  fence_regs(p);
  if (kResid) {
    fence_regs(o_lo);
    fence_regs(p_lo);
  }
  cx.release();
}

// kResid: also write the backward's residuals (out_exact, stats); the extra
// accumulator takes the registers of the third block an SM
template <int D, bool kDrop, bool kResid>
__global__ void __launch_bounds__(kThreads, (kBlocks<D, kResid>))
attention_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ out_exact, long long osb,
                     long long osh, long long ost, float* __restrict__ stats,
                     int H, int T, unsigned seed, unsigned seed_stride,
                     unsigned threshold, float scale) {
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int last = n_tiles - 1;

  if (tid == 0) {
    for (int s = 0; s < kStages<D>; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], 128);
    }
    bar_init(&sm.q_full, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer ----
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      bar_expect(&sm.q_full, HeadDim<D>::kBytes);
      tma_load_d<D>(sm.q, &qmap, qt * kTile, h, b, &sm.q_full);
      int it = 0;
      auto push = [&](const CUtensorMap* map, int tile) {
        const int s = it % kStages<D>;
        bar_wait(&sm.empty[s], ((it / kStages<D>) & 1) ^ 1);
        bar_expect(&sm.full[s], HeadDim<D>::kBytes);
        tma_load_d<D>(sm.ring[s], map, tile * kTile, h, b, &sm.full[s]);
        ++it;
      };
      // the consumer's order: every K tile (pass 1), the last V tile, then
      // K and V of each other tile (pass 2)
      for (int t = 0; t < n_tiles; ++t) push(&kmap, t);
      push(&vmap, last);
      for (int t = 0; t < last; ++t) {
        push(&kmap, t);
        push(&vmap, t);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);
  Ctx<D> cx{&sm, bias + (size_t)b * T, T,
         qt * kTile + 16 * warp + (lane >> 2),  // rows r_lo and r_lo + 8
         2 * (lane & 3), 0};
  bar_wait(&sm.q_full, 0);

  // pass 1: row max m and sum l over every key tile, folded tile by
  // tile; the last tile's exp(s - mt) stays in s for pass 2
  float s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mt[2];
  for (int t = 0; t < n_tiles; ++t) {
    scores(s, cx, t);
    float lt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x = fmaxf(x, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mt[i] = quad_max(x);
    }
    tile_exp(s, mt, lt);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mt[i]);
      l[i] = l[i] * fast_exp2((m[i] - m_new) * kLog2e) +
             lt[i] * fast_exp2((mt[i] - m_new) * kLog2e);
      m[i] = m_new;
    }
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: p = exp(s - m) / l, then out += p . v; the last tile first,
  // from registers, then the others with their scores computed again
  float o[HeadDim<D>::kAcc], o_lo[HeadDim<D>::kAcc];
#pragma unroll
  for (int i = 0; i < HeadDim<D>::kAcc; ++i) o[i] = o_lo[i] = 0.f;
  const float kept[2] = {fast_exp2((mt[0] - m[0]) * kLog2e) * inv_l[0],
                         fast_exp2((mt[1] - m[1]) * kLog2e) * inv_l[1]};
  accumulate_pv<D, kDrop, kResid>(o, o_lo, s, cx, last, kept, mask);
  for (int t = 0; t < last; ++t) {
    float unused[2];
    scores(s, cx, t);
    tile_exp(s, m, unused);
    accumulate_pv<D, kDrop, kResid>(o, o_lo, s, cx, t, inv_l, mask);
  }

  // out rows r_lo and r_lo + 8 (those below T), the row statistics of
  // every row of the tile (rows past T too: the backward reads them)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = cx.r_lo + 8 * i;
    if (r < T) {
      const long long off = b * osb + h * osh + r * ost + cx.c_lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float x = o[4 * j + 2 * i], y = o[4 * j + 2 * i + 1];
        const uint32_t hi = pack_bf16(x, y);
        *reinterpret_cast<uint32_t*>(out + off + 8 * j) = hi;
        if (kResid)  // (p mask) . v with p unrounded
          *reinterpret_cast<uint32_t*>(out_exact + off + 8 * j) =
              pack_bf16(x + o_lo[4 * j + 2 * i], y + o_lo[4 * j + 2 * i + 1]);
      }
    }
    if (kResid && (lane & 3) == 0) {
      float2* st = reinterpret_cast<float2*>(stats) +
                   ((size_t)(b * H + h) * n_tiles * kTile + r);
      *st = make_float2(m[i], logf(l[i]));
    }
  }
}

template <int D, bool kDrop, bool kResid>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const float* bias,
                   __nv_bfloat16* out, __nv_bfloat16* out_exact,
                   const long long* os, float* stats,
                   int B, int H, int T, unsigned seed,
                   unsigned seed_stride, unsigned threshold, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<D, kDrop, kResid>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes<D>);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  attention_fwd_kernel<D, kDrop, kResid>
      <<<grid, kThreads, kSmemBytes<D>, stream>>>(
      qm, km, vm, bias, out, out_exact, os[0], os[1], os[2], stats, H, T, seed,
      seed_stride, threshold, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const float* b,
                __nv_bfloat16* o, __nv_bfloat16* ox, float* st,
                const long long* qs, const long long* ks, const long long* vs,
                const long long* os, int B, int H, int T, unsigned seed,
                unsigned seed_stride, unsigned threshold, float scale,
                cudaStream_t s) {
  CUtensorMap qm, km, vm;
  cudaError_t err = bind_device();
  if (err == cudaSuccess)
    err = make_map(&qm, q, B, H, T, qs[0], qs[1], qs[2], false, D);
  if (err == cudaSuccess)
    err = make_map(&km, k, B, H, T, ks[0], ks[1], ks[2], false, D);
  if (err == cudaSuccess)
    err = make_map(&vm, v, B, H, T, vs[0], vs[1], vs[2], false, D);
  if (err != cudaSuccess) return err;
  const bool drop = threshold != 0u, resid = st != nullptr;
#define W2V_LAUNCH(DR, R) \
  launch<D, DR, R>(qm, km, vm, b, o, ox, os, st, B, H, T, seed, seed_stride, \
                   threshold, scale, s)
  return drop ? (resid ? W2V_LAUNCH(true, true) : W2V_LAUNCH(true, false))
              : (resid ? W2V_LAUNCH(false, true) : W2V_LAUNCH(false, false));
#undef W2V_LAUNCH
}

}  // namespace

extern "C" {

// q, k, v, out: (B, H, T, D) bf16, D = 64, 80 or 120, with element
// strides {q,k,v,o}s =
// (batch, head, row); bias (B, T) fp32 contiguous; stats: fp32
// (B, H, Tp, 2) contiguous, Tp = T rounded up to 64, or null; out_exact:
// null with stats, or a bf16 tensor of out's strides that takes
// (p mask) . v with p unrounded (the backward's D reads it); seed and
// seed_stride: the dropout seed (the mask of (b, h) uses
// seed + b*seed_stride + h; seed_stride is H unless this call holds a
// shard of the heads or of the batch); threshold:
// min(rate * 2^32, 2^32 - 1), 0 for rate 0; scale: 1/(1-rate).
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* bias, void* out, void* out_exact, void* stats,
                  const long long* qs, const long long* ks,
                  const long long* vs, const long long* os, int B, int H,
                  int T, int D, unsigned seed, unsigned seed_stride,
                  unsigned threshold, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* ox = static_cast<__nv_bfloat16*>(out_exact);
  auto* st = static_cast<float*>(stats);
  if ((ox == nullptr) != (st == nullptr)) return (int)cudaErrorInvalidValue;
#define W2V_RUN(HD)                                                        \
  run<HD>(q, k, v, b, o, ox, st, qs, ks, vs, os, B, H, T, seed, seed_stride, \
          threshold, scale, s)
  switch (D) {
    case 64: return (int)W2V_RUN(64);
    case 80: return (int)W2V_RUN(80);
    case 120: return (int)W2V_RUN(120);
    default: return (int)cudaErrorInvalidValue;
  }
#undef W2V_RUN
}

}  // extern "C"
