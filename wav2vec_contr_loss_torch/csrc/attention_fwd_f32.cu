// Masked-softmax self-attention, forward, in fp32, for Hopper (sm_90a).
//
// The fp32 counterpart of attention_fwd.cu, which replaces the forward
// body of the Pallas kernel `_fwd_kernel` in
// wav2vec_contr_loss_tpu/ops/attention_pallas.py. It computes what the
// port's plain version computes with fp32 q/k/v (ops/attention.py
// `fused_attention_plain`, and JAX's default XLA attention in fp32):
//   out = (p * mask) . v,  p = softmax(q . k^T + bias)
// with fp32 products, fp32 softmax and an fp32 output; nothing is
// rounded to bf16 (the Pallas kernel rounds q, k, v and p to bf16 before
// each product even under fp32 I/O; the port does not). q, k, v, out:
// (B, H, T, 64) fp32 given by element strides (the head dim contiguous,
// the other strides multiples of 4, 16-byte aligned), so the (B, H, T,
// 64) view of a (B, T, H, 64) projection output goes in without a copy.
// q arrives pre-scaled; bias is the fp32 (B, T) additive key mask (0 or
// -1e30), so a fully masked row comes out uniform, as in JAX.
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
// 8.1 GFLOP, 0.121 ms at the 67 TFLOP/s fp32 FFMA peak. So it is bound
// by operations, and wgmma cannot help: the tensor cores take fp32 only
// as TF32.
//
// Design (a simple tiled kernel on FFMA, f32_tiles.cuh):
//   * grid (query tile of 64 rows, head, batch element), 256 threads, a
//     4 x 4 block of each 64 x 64 product a thread; the Q tile, one K or
//     V tile and one p tile in shared memory (52 KB), two blocks an SM
//     at up to 128 registers a thread.
//   * two passes, as the bf16 kernel: pass 1 takes each row's max and
//     sum of exp over every key tile (folded tile by tile); pass 2
//     computes the scores again, normalizes p exactly, applies the
//     murmur dropout mask (dropout_mask.cuh: the hash of the plain
//     version's `attention_dropout_mask`, with the per-batch seed
//     stride) and adds p . v. Three products where two would do: the
//     price of a simple kernel that keeps no (T, T) scores.
//   * tiles are loaded by all threads with 16-byte loads; blocks on the
//     same SM overlap one another's loads with their products.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "dropout_mask.cuh"
#include "f32_tiles.cuh"

namespace {

using namespace f32;

constexpr size_t kSmemBytes = 3 * kTileFloats * sizeof(float);

template <bool kDrop, bool kResid>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_f32_kernel(const float* __restrict__ q, Strides qs,
                         const float* __restrict__ k, Strides ks,
                         const float* __restrict__ v, Strides vs,
                         const float* __restrict__ bias,
                         float* __restrict__ out, Strides os,
                         float* __restrict__ stats, int H, int T,
                         unsigned seed, unsigned seed_stride,
                         unsigned threshold, float scale) {
  extern __shared__ float4 smem4[];
  float* qt_s = reinterpret_cast<float*>(smem4);
  float* kv_s = qt_s + kTileFloats;
  float* p_s = kv_s + kTileFloats;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int q0 = qt * kTile;
  const float* brow = bias + (size_t)b * T;
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);

  load_tile(qt_s, q, qs, b, h, q0, T);

  // s = q . k^T + bias for key tile t (-inf past T), K in kv_s
  auto scores = [&](float (&s)[4][4], int t) {
    __syncthreads();  // the last readers of kv_s are done
    load_tile(kv_s, k, ks, b, h, t * kTile, T);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    abt(s, qt_s, kv_s, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = t * kTile + tx + 16 * j;
      const float bv = col < T ? __ldg(brow + col) : -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] += bv;
    }
  };

  // pass 1: row max m and sum l of exp(s - m), folded tile by tile
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    float s[4][4];
    scores(s, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mt = row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                     fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mt);
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(e);
      m[i] = m_new;
    }
  }
  float inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv_l[i] = 1.f / l[i];

  // pass 2: p = exp(s - m) / l, masked, then out += p . v
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    float s[4][4];
    scores(s, t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] - m[i]) * inv_l[i];
        if (kDrop)
          p *= mask((unsigned)(q0 + 4 * ty + i), (unsigned)(t * kTile + c));
        p_s[(4 * ty + i) * kLd + c] = p;
      }
    __syncthreads();  // every thread is done with the K tile
    load_tile(kv_s, v, vs, b, h, t * kTile, T);
    __syncthreads();
    ab(o, p_s, kv_s, ty, tx);
  }
  store_rows(out, os, b, h, q0, T, ty, tx, o);
  if (kResid && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float2*>(stats)[(size_t)(b * H + h) * n_tiles * kTile +
                                       q0 + 4 * ty + i] =
          make_float2(m[i], logf(l[i]));
  }
}

template <bool kDrop, bool kResid>
cudaError_t launch(const float* q, Strides qs, const float* k, Strides ks,
                   const float* v, Strides vs, const float* bias, float* out,
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
      q, qs, k, ks, v, vs, bias, out, os, stats, H, T, seed, seed_stride,
      threshold, scale);
  return cudaGetLastError();
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

extern "C" {

// q, k, v, out: (B, H, T, 64) fp32 with element strides {q,k,v,o}s =
// (batch, head, row), each a multiple of 4, and 16-byte aligned data;
// bias (B, T) fp32 contiguous; stats: fp32 (B, H, Tp, 2) contiguous,
// Tp = T rounded up to 64, or null (no backward residuals); seed,
// seed_stride, threshold and scale as for attention_fwd.
int attention_fwd_f32(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* stats,
                      const long long* qs, const long long* ks,
                      const long long* vs, const long long* os, int B, int H,
                      int T, int D, unsigned seed, unsigned seed_stride,
                      unsigned threshold, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* st = static_cast<float*>(stats);
  const Strides a = strides_of(qs), c = strides_of(ks), e = strides_of(vs),
                o = strides_of(os);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u, resid = st != nullptr;
#define W2V_LAUNCH(D, R)                                                    \
  launch<D, R>(qp, a, kp, c, vp, e, bp, op, o, st, B, H, T, seed,           \
               seed_stride, threshold, scale, s)
  return (int)(drop ? (resid ? W2V_LAUNCH(true, true) : W2V_LAUNCH(true, false))
                    : (resid ? W2V_LAUNCH(false, true)
                             : W2V_LAUNCH(false, false)));
#undef W2V_LAUNCH
}

}  // extern "C"
