// Masked-softmax self-attention, backward, in fp32, for Hopper (sm_90a).
//
// The fp32 counterpart of attention_bwd.cu, which replaces the Pallas
// kernel `_bwd_kernel` in wav2vec_contr_loss_tpu/ops/attention_pallas.py.
// From the residuals of attention_fwd_f32.cu (q, k, v, the fp32 (B, T)
// key bias, the row statistics (m, log l), the output `out`, the dropout
// seed) and the output cotangent g, all fp32, it recomputes
// p = exp(q . k^T + bias - m - log l) and the murmur dropout mask
// (dropout_mask.cuh), stores no probability, and computes in fp32 what
// autograd of the plain version computes (nothing rounded to bf16):
//   dv = (p * mask)^T . g
//   dp = (g . v^T) * mask
//   ds = p * (dp - D),  D_i = rowsum(g_i * out_i)
//   dq = ds . k,   dk = ds^T . q
// D is FlashAttention's identity, sum_j dp_ij p_ij = g_i . (p mask v)_i;
// in fp32 `out` is the bf16 kernel's out_exact.
//
// Bound on an H100 at the training shape (B=32, H=16, T=249): it moves
// q, k, v, g, out, dq, dk and dv once, 261 MB (0.078 ms at 3.35 TB/s);
// its five T x T x 64 products (s, dp, dv, dq, dk) are 20.3 GFLOP,
// 0.303 ms at the 67 TFLOP/s fp32 FFMA peak: bound by operations.
//
// Design: two kernels on the fp32 tiles of f32_tiles.cuh (256 threads,
// a 4 x 4 block of every 64 x 64 product a thread, tiles loaded with
// 16-byte loads, two blocks an SM). No atomics: every output element is
// written once by one block, so two calls give the same bits.
//   1. dq kernel, grid (query tile, head, batch): D of its 64 rows from g
//      and out (written out for kernel 2), then for each key tile
//      s = q k_t^T and dp = g v_t^T, ds into shared memory and
//      dq += ds . k_t. Q, G, K, V and ds tiles: 87 KB.
//   2. dk/dv kernel, grid (key tile, head, batch): k and v of its 64 keys
//      stay in shared memory; for each query tile s^T = k q_t^T and
//      dp^T = v g_t^T, the row statistics and D of those queries from
//      device memory, p^T * mask and ds^T into shared memory, then
//      dv += (p^T mask) . g_t and dk += ds^T . q_t. 104 KB. The mask is
//      hashed again here (the bf16 kernel hands it over as bits).
// Seven products where five would do (the scores and dp are formed in
// both kernels): the price of no atomics.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "dropout_mask.cuh"
#include "f32_tiles.cuh"

namespace {

using namespace f32;

constexpr size_t kDqSmem = 5 * kTileFloats * sizeof(float);
constexpr size_t kDkvSmem = 6 * kTileFloats * sizeof(float);

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// ---------------------------------------------------------------- dq ----

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
attention_dq_f32_kernel(const float* __restrict__ q, Strides qs,
                        const float* __restrict__ k, Strides ks,
                        const float* __restrict__ v, Strides vs,
                        const float* __restrict__ g, Strides gs,
                        const float* __restrict__ out, Strides os,
                        const float* __restrict__ bias,
                        const float2* __restrict__ stats,
                        float* __restrict__ dbuf, float* __restrict__ dq,
                        Strides dqs, int H, int T, unsigned seed,
                        unsigned seed_stride, unsigned threshold,
                        float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* g_s = q_s + kTileFloats;
  float* k_s = g_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* ds_s = v_s + kTileFloats;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int q0 = qt * kTile;
  const size_t bh_rows = (size_t)(b * H + h) * n_tiles * kTile;
  const float* brow = bias + (size_t)b * T;
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);

  load_tile(q_s, q, qs, b, h, q0, T);
  load_tile(g_s, g, gs, b, h, q0, T);
  load_tile(ds_s, out, os, b, h, q0, T);  // out, for D
  __syncthreads();

  // D of rows 4ty + i (0 past T: g reads as zeros there), m and log l
  float d_row[4], m[4], ll[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc = fmaf(g_s[r * kLd + tx + 16 * j], ds_s[r * kLd + tx + 16 * j], acc);
    d_row[i] = row_sum(acc);
    if (tx == 0) dbuf[bh_rows + q0 + r] = d_row[i];
    const float2 st = stats[bh_rows + q0 + r];
    m[i] = st.x;
    ll[i] = st.y;
  }

  float dqa[4][4];
  zero(dqa);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the last readers of k_s, v_s and ds_s are done
    load_tile(k_s, k, ks, b, h, t * kTile, T);
    load_tile(v_s, v, vs, b, h, t * kTile, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    abt(s, q_s, k_s, ty, tx);
    abt(dp, g_s, v_s, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, col = t * kTile + c;
      const float bv = col < T ? __ldg(brow + col) : -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf((s[i][j] + bv) - m[i] - ll[i]);
        float dpv = dp[i][j];
        if (kDrop) dpv *= mask((unsigned)(q0 + 4 * ty + i), (unsigned)col);
        ds_s[(4 * ty + i) * kLd + c] = p * (dpv - d_row[i]);
      }
    }
    __syncthreads();
    ab(dqa, ds_s, k_s, ty, tx);
  }
  store_rows(dq, dqs, b, h, q0, T, ty, tx, dqa);
}

// ------------------------------------------------------------- dk, dv ----

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
attention_dkdv_f32_kernel(const float* __restrict__ q, Strides qs,
                          const float* __restrict__ k, Strides ks,
                          const float* __restrict__ v, Strides vs,
                          const float* __restrict__ g, Strides gs,
                          const float* __restrict__ bias,
                          const float2* __restrict__ stats,
                          const float* __restrict__ dbuf,
                          float* __restrict__ dk, Strides dks,
                          float* __restrict__ dv, Strides dvs, int H, int T,
                          unsigned seed, unsigned seed_stride,
                          unsigned threshold, float scale) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTileFloats;
  float* q_s = v_s + kTileFloats;
  float* g_s = q_s + kTileFloats;
  float* pt_s = g_s + kTileFloats;
  float* dst_s = pt_s + kTileFloats;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int k0 = kt * kTile;
  const size_t bh_rows = (size_t)(b * H + h) * n_tiles * kTile;
  const DropoutMask mask(seed + (unsigned)b * seed_stride + (unsigned)h,
                         threshold, scale);

  load_tile(k_s, k, ks, b, h, k0, T);
  load_tile(v_s, v, vs, b, h, k0, T);
  float kb[4];  // the bias of key rows 4ty + i (-inf past T)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    kb[i] = r < T ? __ldg(bias + (size_t)b * T + r) : -INFINITY;
  }

  float dka[4][4], dva[4][4];
  zero(dka);
  zero(dva);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the last readers of q_s, g_s, pt_s, dst_s are done
    load_tile(q_s, q, qs, b, h, t * kTile, T);
    load_tile(g_s, g, gs, b, h, t * kTile, T);
    __syncthreads();
    // rows: keys 4ty + i; columns: queries tx + 16j
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    abt(st, k_s, q_s, ty, tx);
    abt(dpt, v_s, g_s, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, qi = t * kTile + c;
      const float2 rs = __ldg(stats + bh_rows + qi);
      const float d_q = __ldg(dbuf + bh_rows + qi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = expf((st[i][j] + kb[i]) - rs.x - rs.y);
        p = qi < T ? p : 0.f;
        const float mk =
            kDrop ? mask((unsigned)qi, (unsigned)(k0 + 4 * ty + i)) : 1.f;
        pt_s[(4 * ty + i) * kLd + c] = p * mk;
        dst_s[(4 * ty + i) * kLd + c] = p * (dpt[i][j] * mk - d_q);
      }
    }
    __syncthreads();
    ab(dva, pt_s, g_s, ty, tx);
    ab(dka, dst_s, q_s, ty, tx);
  }
  store_rows(dk, dks, b, h, k0, T, ty, tx, dka);
  store_rows(dv, dvs, b, h, k0, T, ty, tx, dva);
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <bool kDrop>
cudaError_t launch(const float* const* in, const long long* const* st,
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
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  // in: q, k, v, g, out; grads: dq, dk, dv
  attention_dq_f32_kernel<kDrop><<<grid, kThreads, kDqSmem, stream>>>(
      in[0], strides_of(st[0]), in[1], strides_of(st[1]), in[2],
      strides_of(st[2]), in[3], strides_of(st[3]), in[4], strides_of(st[4]),
      bias, stats, dbuf, grads[0], strides_of(gst[0]), H, T, seed,
      seed_stride, threshold, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_dkdv_f32_kernel<kDrop><<<grid, kThreads, kDkvSmem, stream>>>(
      in[0], strides_of(st[0]), in[1], strides_of(st[1]), in[2],
      strides_of(st[2]), in[3], strides_of(st[3]), bias, stats, dbuf,
      grads[1], strides_of(gst[1]), grads[2], strides_of(gst[2]), H, T, seed,
      seed_stride, threshold, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, g, out, dq, dk, dv: (B, H, T, 64) fp32 with element strides
// (batch, head, row) in the matching *s array, each a multiple of 4, and
// 16-byte aligned data (out: the forward's output); bias (B, T) fp32;
// stats the forward's (B, H, Tp, 2) row statistics; dbuf an fp32
// (B, H, Tp) scratch that takes D (Tp = T rounded up to 64); seed,
// seed_stride, threshold and scale as for attention_fwd. Launches the dq
// kernel, then the dk/dv kernel.
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
  const float* in[5] = {static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(g),
                        static_cast<const float*>(out)};
  const long long* st[5] = {qs, ks, vs, gs, os};
  float* grads[3] = {static_cast<float*>(dq), static_cast<float*>(dk),
                     static_cast<float*>(dv)};
  const long long* gst[3] = {dqs, dks, dvs};
  const auto* b = static_cast<const float*>(bias);
  const auto* sp = static_cast<const float2*>(stats);
  auto* d = static_cast<float*>(dbuf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(threshold != 0u
                   ? launch<true>(in, st, b, sp, d, grads, gst, B, H, T, seed,
                                  seed_stride, threshold, scale, s)
                   : launch<false>(in, st, b, sp, d, grads, gst, B, H, T,
                                   seed, seed_stride, threshold, scale, s));
}

}  // extern "C"
