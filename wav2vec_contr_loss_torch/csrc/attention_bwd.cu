// Masked-softmax self-attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bwd_kernel` in
// wav2vec_contr_loss_tpu/ops/attention_pallas.py. From the forward's
// residuals (q, k, v, the fp32 (B, T) key bias and the dropout seed) and
// the output cotangent g it recomputes p = softmax_fp32(q . k^T + bias)
// and the murmur dropout mask (dropout_mask.cuh), stores no probability,
// and computes, with bf16 operands and fp32 accumulation:
//   dv = bf16(p * mask)^T . g
//   dp = (g . v^T) * mask
//   ds = p * (dp - rowsum(dp * p))
//   dq = bf16(ds) . k,   dk = bf16(ds)^T . q
//
// Bound on an H100 at the training shape (B=32, H=16, T=249, D=64): it
// moves q, k, v, g, dq, dk and dv once, 114 MB (34 us at 3.35 TB/s); its
// five T x T x D products are about 20 GFLOP (21 us at the bf16 tensor-core
// peak). So, like the forward, it is bound by bytes, and what it must
// avoid is sending the (T, T) scores through device memory.
//
// Design: one block of 8 warps per (head, batch element) owns all of
// dq, dk and dv for that pair, so no atomics are needed. Q, K, V and G of
// the pair are staged once in shared memory with cp.async (rows past T
// zero-filled up to a multiple of 32, their keys get a -inf bias): at
// T <= 256 that is 144 KB with padded rows, which leaves room for one
// 16 x 32 fp32 score panel, one dp panel and two bf16 operand panels per
// warp (57 KB for 8 warps) inside the 227 KB a block may use.
//   Phase 1, a warp per 16 query rows, walking the keys in chunks of 32:
//     pass 1: row max and sum of exp (as the forward's pass 1);
//     pass 2: D_i = sum_j dp_ij p_ij, with s and g . v^T recomputed;
//     pass 3: ds, rounded to bf16, then dq += ds . k on the tensor cores.
//     The row max, 1/sum and D go to shared memory.
//   Phase 2, a warp per 16 key rows, walking the queries in chunks of 32:
//     s^T = k . q^T and (g . v^T)^T = v . g^T on the tensor cores, p^T
//     from the stored row statistics, the mask at (query, key), then
//     dv += bf16(p * mask)^T . g and dk += bf16(ds)^T . q.
// Every product runs on the tensor cores (WMMA bf16 16x16x16, fp32
// accumulate); the scores are recomputed four times, which costs
// tensor-core time the kernel has spare and keeps shared memory inside
// one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stddef.h>

#include "common.cuh"
#include "dropout_mask.cuh"

namespace {

using namespace nvcuda;

constexpr int kD = 64;               // head dim
constexpr int kC = 32;               // keys (phase 1) / queries (phase 2) per panel
constexpr int kWarps = 8;
constexpr int kMaxT = 256;
constexpr int kLdk = kD + 8;         // staged Q/K/V/G row stride (bf16)
constexpr int kLdc = kC + 4;         // fp32 panel row stride
constexpr int kLdp = kC + 8;         // bf16 operand panel row stride
constexpr int kLdo = kD + 4;         // fp32 output staging row stride
constexpr int kDT = kD / 16;         // WMMA tiles along D
constexpr int kCT = kC / 16;         // WMMA tiles along a panel
// per warp: two fp32 panels (or one output staging tile) + two bf16 panels
constexpr int kWarpF32 = 16 * 2 * kLdc;
constexpr int kWarpBf16 = 2 * 16 * kLdp;
static_assert(16 * kLdo <= kWarpF32, "output staging fits the fp32 panels");

__host__ __device__ __forceinline__ int round_c(int x) {
  return (x + kC - 1) / kC * kC;
}

size_t smem_bytes(int T) {
  const size_t tp = round_c(T);
  return sizeof(__nv_bfloat16) * 4 * tp * kLdk   // Q, K, V, G
         + sizeof(float) * 4 * tp                 // bias, max, 1/sum, D
         + kWarps * (sizeof(float) * kWarpF32 + sizeof(__nv_bfloat16) * kWarpBf16);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// panel(16 x kC) = a_rows(16 x D) . src[c0 : c0 + kC]^T
__device__ __forceinline__ void rows_times_panel_t(
    float* panel, const FragA (&a)[kDT], const __nv_bfloat16* src, int c0) {
#pragma unroll
  for (int nt = 0; nt < kCT; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      FragBc b;
      wmma::load_matrix_sync(b, src + (c0 + nt * 16) * kLdk + kk * 16, kLdk);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(panel + nt * 16, acc, kLdc, wmma::mem_row_major);
  }
}

// acc(16 x D) += op(16 x kC, bf16) . src[c0 : c0 + kC]
__device__ __forceinline__ void accumulate_panel(
    FragC (&acc)[kDT], const __nv_bfloat16* op, const __nv_bfloat16* src,
    int c0) {
#pragma unroll
  for (int kt = 0; kt < kCT; ++kt) {
    FragA a;
    wmma::load_matrix_sync(a, op + kt * 16, kLdp);
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) {
      FragBr b;
      wmma::load_matrix_sync(b, src + (c0 + kt * 16) * kLdk + nt * 16, kLdk);
      wmma::mma_sync(acc[nt], a, b, acc[nt]);
    }
  }
}

// write rows [r0, r0 + 16) of a (T, D) bf16 output from fp32 fragments,
// staged through the warp's fp32 panels for coalesced stores
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const FragC (&acc)[kDT],
                                           float* stage, int r0, int T,
                                           int lane) {
#pragma unroll
  for (int nt = 0; nt < kDT; ++nt)
    wmma::store_matrix_sync(stage + nt * 16, acc[nt], kLdo,
                            wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * (kD / 2); i += 32) {
    const int r = i / (kD / 2), c = i - r * (kD / 2), t = r0 + r;
    if (t < T)
      reinterpret_cast<__nv_bfloat162*>(out + (size_t)t * kD)[c] =
          __floats2bfloat162_rn(stage[r * kLdo + 2 * c],
                                stage[r * kLdo + 2 * c + 1]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ g,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ dq,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int T,
                     unsigned seed, unsigned threshold, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y, h = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Tp = round_c(T);
  const DropoutMask mask(seed + (unsigned)(b * H + h), threshold, scale);

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + (size_t)Tp * kLdk;
  __nv_bfloat16* qs = vs + (size_t)Tp * kLdk;
  __nv_bfloat16* gs = qs + (size_t)Tp * kLdk;
  float* bs = reinterpret_cast<float*>(gs + (size_t)Tp * kLdk);
  float* row_max = bs + Tp;
  float* row_inv = row_max + Tp;
  float* row_d = row_inv + Tp;
  float* fpan = row_d + Tp + warp * kWarpF32;
  float* spanel = fpan;                 // scores (or s^T)
  float* dpanel = fpan + 16 * kLdc;     // g . v^T (or its transpose)
  __nv_bfloat16* pbuf = reinterpret_cast<__nv_bfloat16*>(
                            row_d + Tp + kWarps * kWarpF32) + warp * kWarpBf16;
  __nv_bfloat16* dsbuf = pbuf + 16 * kLdp;

  const size_t bh = ((size_t)b * H + h) * T * kD;
  constexpr int kVec = kD / 8;  // 16-byte vectors per row
  const __nv_bfloat16* srcs[4] = {k + bh, v + bh, q + bh, g + bh};
  __nv_bfloat16* dsts[4] = {ks, vs, qs, gs};
#pragma unroll
  for (int a = 0; a < 4; ++a)
    for (int i = tid; i < Tp * kVec; i += blockDim.x) {
      const int j = i / kVec, c = i - j * kVec;
      cp_async16(dsts[a] + j * kLdk + c * 8,
                 srcs[a] + (size_t)min(j, T - 1) * kD + c * 8, j < T);
    }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = tid; j < Tp; j += blockDim.x) {
    bs[j] = j < T ? bias[(size_t)b * T + j] : -INFINITY;
    row_max[j] = 0.f;
    row_inv[j] = 0.f;
    row_d[j] = 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // two lanes per panel row, each over half of the kC columns
  const int row = lane >> 1, half = lane & 1;
  constexpr int kHalf = kC / 2;
  const float* srow = spanel + row * kLdc + half * kHalf;
  const float* drow = dpanel + row * kLdc + half * kHalf;
  __nv_bfloat16* prow = pbuf + row * kLdp + half * kHalf;
  __nv_bfloat16* dsrow = dsbuf + row * kLdp + half * kHalf;
  const int n_chunks = Tp / kC;

  // ---- phase 1: a warp per 16 query rows -> row stats and dq ----
  for (int tile = warp; tile * 16 < T; tile += kWarps) {
    const int r0 = tile * 16;
    const unsigned qi = r0 + row;
    FragA qa[kDT], ga[kDT];
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      wmma::load_matrix_sync(qa[kk], qs + r0 * kLdk + kk * 16, kLdk);
      wmma::load_matrix_sync(ga[kk], gs + r0 * kLdk + kk * 16, kLdk);
    }
    // pass 1: row max and sum of exp over all keys
    float m_run = -INFINITY, l_run = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      rows_times_panel_t(spanel, qa, ks, c * kC);
      __syncwarp();
      const float* bc = bs + c * kC + half * kHalf;
      float mc = -INFINITY;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) mc = fmaxf(mc, srow[i] + bc[i]);
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      float lc = 0.f;
      if (mc != -INFINITY) {
#pragma unroll
        for (int i = 0; i < kHalf; ++i) lc += __expf(srow[i] + bc[i] - mc);
      }
      lc += __shfl_xor_sync(0xffffffffu, lc, 1);
      const float m_new = fmaxf(m_run, mc);
      if (m_new != -INFINITY) {
        l_run = l_run * expf(m_run - m_new) + lc * expf(mc - m_new);
        m_run = m_new;
      }
      __syncwarp();
    }
    const float inv_l = 1.f / l_run;
    // pass 2: D = sum_j dp_ij p_ij
    float d_acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      rows_times_panel_t(spanel, qa, ks, c * kC);
      rows_times_panel_t(dpanel, ga, vs, c * kC);
      __syncwarp();
      const float* bc = bs + c * kC + half * kHalf;
      const unsigned kc = c * kC + half * kHalf;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float p = __expf(srow[i] + bc[i] - m_run) * inv_l;
        d_acc += p * (drow[i] * mask(qi, kc + i));
      }
      __syncwarp();
    }
    d_acc += __shfl_xor_sync(0xffffffffu, d_acc, 1);
    // pass 3: ds in bf16, dq += ds . k
    FragC acc[kDT];
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) wmma::fill_fragment(acc[nt], 0.f);
    for (int c = 0; c < n_chunks; ++c) {
      rows_times_panel_t(spanel, qa, ks, c * kC);
      rows_times_panel_t(dpanel, ga, vs, c * kC);
      __syncwarp();
      const float* bc = bs + c * kC + half * kHalf;
      const unsigned kc = c * kC + half * kHalf;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float p = __expf(srow[i] + bc[i] - m_run) * inv_l;
        dsrow[i] = __float2bfloat16(p * (drow[i] * mask(qi, kc + i) - d_acc));
      }
      __syncwarp();
      accumulate_panel(acc, dsbuf, ks, c * kC);
      __syncwarp();
    }
    if (half == 0) {
      row_max[r0 + row] = m_run;
      row_inv[r0 + row] = inv_l;
      row_d[r0 + row] = d_acc;
    }
    store_rows(dq + bh, acc, fpan, r0, T, lane);
  }
  __syncthreads();  // row statistics of every query are in shared memory

  // ---- phase 2: a warp per 16 key rows -> dk and dv ----
  for (int tile = warp; tile * 16 < T; tile += kWarps) {
    const int j0 = tile * 16;
    const unsigned kj = j0 + row;
    const float bj = bs[j0 + row];
    FragA ka[kDT], va[kDT];
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      wmma::load_matrix_sync(ka[kk], ks + j0 * kLdk + kk * 16, kLdk);
      wmma::load_matrix_sync(va[kk], vs + j0 * kLdk + kk * 16, kLdk);
    }
    FragC dk_acc[kDT], dv_acc[kDT];
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) {
      wmma::fill_fragment(dk_acc[nt], 0.f);
      wmma::fill_fragment(dv_acc[nt], 0.f);
    }
    for (int c = 0; c < n_chunks; ++c) {
      rows_times_panel_t(spanel, ka, qs, c * kC);  // s^T
      rows_times_panel_t(dpanel, va, gs, c * kC);  // (g . v^T)^T
      __syncwarp();
      const int q0 = c * kC + half * kHalf;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int qi = q0 + i;
        const float p = __expf(srow[i] + bj - row_max[qi]) * row_inv[qi];
        const float mv = mask(qi, kj);
        const bool valid = qi < T;
        prow[i] = __float2bfloat16(valid ? p * mv : 0.f);
        dsrow[i] = __float2bfloat16(valid ? p * (drow[i] * mv - row_d[qi])
                                          : 0.f);
      }
      __syncwarp();
      accumulate_panel(dv_acc, pbuf, gs, c * kC);
      accumulate_panel(dk_acc, dsbuf, qs, c * kC);
      __syncwarp();
    }
    store_rows(dk + bh, dk_acc, fpan, j0, T, lane);
    store_rows(dv + bh, dv_acc, fpan, j0, T, lane);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper refuses shapes above the
// card's per-block limit before it launches.
long long attention_bwd_smem_bytes(int T) { return (long long)smem_bytes(T); }

// q, k, v, g, dq, dk, dv: (B, H, T, 64) bf16; bias (B, T) fp32; seed,
// threshold and scale as for attention_fwd.
int attention_bwd(const void* q, const void* k, const void* v, const void* g,
                  const void* bias, void* dq, void* dk, void* dv, int B,
                  int H, int T, int D, unsigned seed, unsigned threshold,
                  float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T > kMaxT || D != kD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<<<dim3(H, B), kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, T, seed, threshold, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
