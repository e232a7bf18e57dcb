// Masked-softmax self-attention, forward, for Hopper (sm_90a).
//
// Replaces the forward body of the Pallas kernel `_fwd_kernel` in
// wav2vec_contr_loss_tpu/ops/attention_pallas.py:
//   out = bf16(p * mask) . v,  p = softmax_fp32(q . k^T + bias)
// with bf16 q/k/v (B, H, T, D), q pre-scaled by 1/sqrt(D), an fp32 (B, T)
// additive key bias (0 or -1e30), fp32 accumulation and a bf16 output.
// The max-subtracted softmax makes a fully masked row uniform, as in JAX.
//
// Bound on an H100 at the serving shape (B=8, H=16, T=249, D=64): moving
// q, k, v and out once is 16.3 MB (4.9 us at 3.35 TB/s); the two products
// are 2.0 GFLOP (2.1 us at the bf16 tensor-core peak), so the kernel is
// bound by its bytes, and what it must avoid is sending the (T, T) scores
// through device memory. Design: one block per (query tile, head, batch
// element): 16 warps covering all queries of the (b, h) pair while
// T <= 256, so K and V are read once, else 8 warps per 128-row tile.
// K, V, the query tile and the key bias are
// staged in shared memory with cp.async (V in its own group, so its copy
// overlaps the first pass; keys past T are zero-filled up to a multiple
// of 64 and get a -inf bias). Each warp owns 16 query rows and walks the
// keys in chunks of 64, computing q . k^T on the tensor cores (WMMA bf16
// 16x16x16, fp32 accumulate) into a 16 x 64 fp32 panel of its own:
//   pass 1: running row max and sum of exp (two lanes per row),
//   pass 2: the same scores again, p = exp(s - max) / sum rounded to bf16
//           as the Pallas kernel rounds it (the fast exp2-based exp and
//           the reciprocal move p by a few fp32 ulps, far below that
//           rounding), then p . v on the tensor cores, accumulated in
//           registers across chunks.
// Recomputing q . k^T costs tensor-core time the kernel has spare and
// keeps shared memory per block small enough for T up to 512; no score
// leaves the SM. Dropout (rate > 0) multiplies the normalized fp32 p by
// the murmur mask of dropout_mask.cuh right before its bf16 rounding, in
// the order of `_fwd_kernel`; the backward kernel (attention_bwd.cu)
// regenerates the same mask from the same seed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stddef.h>

#include "common.cuh"
#include "dropout_mask.cuh"

namespace {

using namespace nvcuda;

constexpr int kChunk = 64;           // keys per score panel
constexpr int kMaxT = 512;
constexpr int kLdc = kChunk + 4;     // fp32 panel row stride
constexpr int kLdp = kChunk + 8;     // bf16 probability row stride

__host__ __device__ __forceinline__ int round_chunk(int x) {
  return (x + kChunk - 1) / kChunk * kChunk;
}

// warps per block (16 query rows each): the whole (b, h) in one block
// while T <= 256, so K and V are read once; 128-row tiles above that
int warps_for(int T) { return T <= 256 ? 16 : 8; }

size_t smem_bytes(int T, int D) {
  const size_t tp = round_chunk(T), rows = 16 * warps_for(T);
  return sizeof(__nv_bfloat16) * (2 * tp + rows) * (D + 8)  // K, V, Q
         + sizeof(float) * tp                                 // key bias
         + rows * (sizeof(float) * kLdc + sizeof(__nv_bfloat16) * kLdp);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int T,
                     unsigned seed, unsigned threshold, float scale) {
  static_assert(D % 16 == 0 && D + 4 <= kLdc, "head dim");
  constexpr int kQTile = 16 * kWarps;  // query rows per block
  constexpr int LDK = D + 8;   // staged K/V/Q row stride (bf16)
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  constexpr int kDT = D / 16;  // WMMA tiles along D
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Tp = round_chunk(T);
  const DropoutMask mask(seed + (unsigned)(b * H + h), threshold, scale);

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + (size_t)Tp * LDK;
  __nv_bfloat16* qs = vs + (size_t)Tp * LDK;
  float* bs = reinterpret_cast<float*>(qs + kQTile * LDK);
  float* panel = bs + Tp + warp * 16 * kLdc;
  __nv_bfloat16* pbuf = reinterpret_cast<__nv_bfloat16*>(bs + Tp + kWarps * 16 * kLdc)
                        + warp * 16 * kLdp;

  const size_t bh = ((size_t)b * H + h) * T * D;
  for (int i = tid; i < Tp * kVec; i += blockDim.x) {
    const int j = i / kVec, c = i - j * kVec;
    cp_async16(ks + j * LDK + c * 8, k + bh + (size_t)min(j, T - 1) * D + c * 8,
               j < T);
  }
  for (int i = tid; i < kQTile * kVec; i += blockDim.x) {
    const int r = i / kVec, c = i - r * kVec, t = q0 + r;
    cp_async16(qs + r * LDK + c * 8, q + bh + (size_t)min(t, T - 1) * D + c * 8,
               t < T);
  }
  cp_async_commit();
  for (int i = tid; i < Tp * kVec; i += blockDim.x) {
    const int j = i / kVec, c = i - j * kVec;
    cp_async16(vs + j * LDK + c * 8, v + bh + (size_t)min(j, T - 1) * D + c * 8,
               j < T);
  }
  cp_async_commit();
  for (int j = tid; j < Tp; j += blockDim.x)
    bs[j] = j < T ? bias[(size_t)b * T + j] : -INFINITY;
  cp_async_wait<1>();  // K and Q have landed; V may still be in flight
  __syncthreads();

  const int r0 = warp * 16;
  const bool active = q0 + r0 < T;
  // two lanes per query row, each over half of a 64-key chunk
  const int row = lane >> 1, half = lane & 1;
  const float* prow = panel + row * kLdc + half * 32;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[kDT];
  auto score_chunk = [&](int c) {  // panel = q_rows . k[c*64 : c*64+64]^T
#pragma unroll
    for (int nt = 0; nt < kChunk / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + (c * kChunk + nt * 16) * LDK + kk * 16,
                               LDK);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(panel + nt * 16, acc, kLdc, wmma::mem_row_major);
    }
    __syncwarp();
  };

  float m_run = -INFINITY, l_run = 0.f;
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk)
      wmma::load_matrix_sync(qa[kk], qs + r0 * LDK + kk * 16, LDK);
    // pass 1: row max and sum of exp over all keys, chunk by chunk
    for (int c = 0; c < Tp / kChunk; ++c) {
      score_chunk(c);
      const float* bc = bs + c * kChunk + half * 32;
      float mc = -INFINITY;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) mc = fmaxf(mc, prow[i] + bc[i]);
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      float lc = 0.f;
      if (mc != -INFINITY) {
#pragma unroll 8
        for (int i = 0; i < 32; ++i) lc += __expf(prow[i] + bc[i] - mc);
      }
      lc += __shfl_xor_sync(0xffffffffu, lc, 1);
      const float m_new = fmaxf(m_run, mc);
      if (m_new != -INFINITY) {
        l_run = l_run * expf(m_run - m_new) + lc * expf(mc - m_new);
        m_run = m_new;
      }
      __syncwarp();  // the panel is rewritten by the next chunk
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed
  if (!active) return;

  // pass 2: p in bf16, then out += p . v, chunk by chunk
  const float inv_l = 1.f / l_run;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kDT];
#pragma unroll
  for (int nt = 0; nt < kDT; ++nt) wmma::fill_fragment(oacc[nt], 0.f);
  for (int c = 0; c < Tp / kChunk; ++c) {
    score_chunk(c);
    const float* bc = bs + c * kChunk + half * 32;
    __nv_bfloat16* pr = pbuf + row * kLdp + half * 32;
    const unsigned qrow = q0 + r0 + row, kcol = c * kChunk + half * 32;
#pragma unroll 8
    for (int i = 0; i < 32; ++i)
      pr[i] = __float2bfloat16(__expf(prow[i] + bc[i] - m_run) * inv_l *
                               mask(qrow, kcol + i));
    __syncwarp();
#pragma unroll
    for (int kt = 0; kt < kChunk / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa;
      wmma::load_matrix_sync(pa, pbuf + kt * 16, kLdp);
#pragma unroll
      for (int nt = 0; nt < kDT; ++nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + (c * kChunk + kt * 16) * LDK + nt * 16,
                               LDK);
        wmma::mma_sync(oacc[nt], pa, vb, oacc[nt]);
      }
    }
    __syncwarp();  // pbuf and the panel are rewritten by the next chunk
  }

  // stage the fp32 output through the panel for coalesced bf16 stores
#pragma unroll
  for (int nt = 0; nt < kDT; ++nt)
    wmma::store_matrix_sync(panel + nt * 16, oacc[nt], kLdc,
                            wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), c = i - r * (D / 2), t = q0 + r0 + r;
    if (t < T)
      reinterpret_cast<__nv_bfloat162*>(out + bh + (size_t)t * D)[c] =
          __floats2bfloat162_rn(panel[r * kLdc + 2 * c],
                                panel[r * kLdc + 2 * c + 1]);
  }
}

template <int W>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int H, int T,
                   unsigned seed, unsigned threshold, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(T, 64);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<64, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = 16 * W;
  const dim3 grid((T + rows - 1) / rows, H, B);
  attention_fwd_kernel<64, W><<<grid, W * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, T, seed, threshold, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper refuses shapes above the
// card's per-block limit before it launches.
long long attention_fwd_smem_bytes(int T, int D) {
  return (long long)smem_bytes(T, D);
}

// seed: the dropout seed (the mask of (b, h) uses seed + b*H + h);
// threshold: min(rate * 2^32, 2^32 - 1), 0 for rate 0; scale: 1/(1-rate)
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* bias, void* out, int B, int H, int T, int D,
                  unsigned seed, unsigned threshold, float scale,
                  void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T > kMaxT || D != 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(warps_for(T) == 16
                   ? launch<16>(q, k, v, bias, out, B, H, T, seed, threshold,
                                scale, s)
                   : launch<8>(q, k, v, bias, out, B, H, T, seed, threshold,
                               scale, s));
}

}  // extern "C"
