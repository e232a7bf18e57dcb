// Fused binary SupCon loss with its analytic gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of
// wav2vec_contr_loss_tpu/ops/supcon_pallas.py, and the similarity remap
// that its wrapper computes outside the kernel (:172-183, only because
// Mosaic cannot lower arccos). In one launch, from z (B, D) fp32, the
// labels and alpha:
//   the Gram matrix; cosine similarity, or geodesic 2(1 - acos(c)/pi) - 1
//   with its clip-gated derivative; logits = sim / tau with the diagonal
//   masked; the masked log-sum-exp of the full term; the iterative top-k
//   of the negatives with first-occurrence argmax (:94-102); the masked
//   log-sum-exp of the mined term; the alpha blend and the degenerate
//   rules; the uniformity term; and the analytic gradient
//     dz = (G + G^T) z + lambda * 2c (rowsum(W) z - W z),
//     dL/dalpha = L_mined - L_full,
//   (the gradient math of supcon_pallas.py:15-23).
//
// Bound: at the training shape (B=32, D=256) the kernel reads 32 KB and
// writes 32 KB (19 ns at 3.35 TB/s); its three B x B x D products are
// 1.6 MFLOP of fp32 (24 ns at 67 TFLOP/s). Any launch takes longer than
// either, so the kernel is bound by its own latency: one block does the
// whole loss, with the (B, B) matrices in shared memory and nothing
// written to device memory but the loss, dz and dL/dalpha.
//
// Design: one block of 512 threads. Phase A: the Gram matrix, one thread
// per (i, j), into shared memory. Phase B: one warp per anchor row: masks,
// the row log-sum-exps, the top-k (each lane keeps its columns' candidates
// in registers; B <= 128 gives 4 a lane) and the per-row terms. Thread 0
// then adds the rows in order (deterministic). Phase C: one thread per
// (i, j) writes g_c = dL/dsim * dsim/dc, and, with a uniformity term,
// w_ij over the Gram matrix. Phase D: one thread per (i, d) computes dz.
// The largest batch is set by shared memory: two (B, B) fp32 matrices, a
// (B, B) byte matrix and the row terms, so B <= 128 (150 KB).

#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 128;
constexpr int kPerLane = kMaxB / 32;
constexpr float kNeg = -1e30f;
constexpr int kRowTerms = 11;  // per-row floats kept in shared memory

size_t smem_bytes(int B) {
  return sizeof(float) * (2 * (size_t)B * B + kRowTerms * (size_t)B + 8)
         + (size_t)B * B;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Sim {
  bool geodesic;
  // similarity of a Gram entry
  __device__ __forceinline__ float value(float dot) const {
    if (!geodesic) return dot;
    const float c = fminf(fmaxf(dot, -1.f + 1e-7f), 1.f - 1e-7f);
    return 2.f * (1.f - acosf(c) / 3.14159265358979323846f) - 1.f;
  }
  // d sim / d dot, zero where the clip is active
  __device__ __forceinline__ float grad(float dot) const {
    if (!geodesic) return 1.f;
    const float eps = 1e-7f;
    const float c = fminf(fmaxf(dot, -1.f + eps), 1.f - eps);
    return fabsf(dot) < 1.f - eps
               ? (2.f / 3.14159265358979323846f) *
                     rsqrtf(fmaxf(1.f - c * c, 1e-12f))
               : 0.f;
  }
};

__global__ void __launch_bounds__(kThreads)
supcon_kernel(const float* __restrict__ z, const int* __restrict__ labels,
              const float* __restrict__ alpha_ptr, float* __restrict__ loss,
              float* __restrict__ dz, float* __restrict__ dalpha, int B,
              int D, float inv_tau, int k, int geodesic, float lam,
              float tu) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gram = reinterpret_cast<float*>(smem);       // (B, B): Gram, then W
  float* gc = gram + B * B;                            // (B, B): g_c
  float* rows = gc + B * B;                            // kRowTerms x B
  float* m_all = rows, *s_all = rows + B, *m_m = rows + 2 * B,
       *s_m = rows + 3 * B, *inv_pos = rows + 4 * B, *has_pos = rows + 5 * B,
       *valid_m = rows + 6 * B, *term_full = rows + 7 * B,
       *term_mined = rows + 8 * B, *row_w = rows + 9 * B,
       *sq = rows + 10 * B;
  float* glob = rows + kRowTerms * B;                  // 8 block scalars
  unsigned char* sel = reinterpret_cast<unsigned char*>(glob + 8);  // (B, B)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Sim sim{geodesic != 0};
  const bool uniform = lam > 0.f && B > 1;

  // ---- phase A: Gram matrix and squared norms ----
  for (int e = tid; e < B * B; e += kThreads) {
    const int i = e / B, j = e - i * B;
    const float* zi = z + (size_t)i * D;
    const float* zj = z + (size_t)j * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(zi[d], zj[d], acc);
    gram[e] = acc;
    sel[e] = 0;
  }
  for (int i = tid; i < B; i += kThreads) {
    const float* zi = z + (size_t)i * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(zi[d], zi[d], acc);
    sq[i] = acc;
  }
  __syncthreads();

  // ---- phase B: one warp per anchor row ----
  for (int i = warp; i < B; i += kWarps) {
    const int li = labels[i];
    float lg[kPerLane], cand[kPerLane];
    bool pos[kPerLane];
    float n_pos = 0.f, n_neg = 0.f, sum_pos = 0.f, mx = kNeg;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = lane + 32 * u;
      const bool in = j < B, off = in && j != i;
      lg[u] = off ? sim.value(gram[i * B + j]) * inv_tau : kNeg;
      const bool same = in && labels[j] == li;
      pos[u] = off && same;
      const bool neg = off && !same;
      n_pos += pos[u];
      n_neg += neg;
      sum_pos += pos[u] ? lg[u] : 0.f;
      cand[u] = neg ? lg[u] : kNeg;
      if (off) mx = fmaxf(mx, lg[u]);
    }
    n_pos = warp_sum(n_pos);
    n_neg = warp_sum(n_neg);
    sum_pos = warp_sum(sum_pos);
    // full term: every non-self entry
    const float ma = fmaxf(warp_max(mx), -1e30f);
    float sa = 0.f;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = lane + 32 * u;
      if (j < B && j != i) sa += expf(lg[u] - ma);
    }
    sa = warp_sum(sa);
    // mined term: iterative top-k of the negatives, first-occurrence argmax
    bool chosen[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) chosen[u] = false;
    for (int it = 0; it < k; ++it) {
      float cm = kNeg;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) cm = fmaxf(cm, cand[u]);
      const float row_max = warp_max(cm);
      int arg = 1 << 30;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int j = lane + 32 * u;
        if (j < B && cand[u] == row_max) arg = min(arg, j);
      }
      arg = warp_min(arg);
      if (!(row_max > kNeg / 2)) break;  // no negative left: no more hits
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        if (lane + 32 * u == arg) {
          chosen[u] = true;
          cand[u] = kNeg;
        }
    }
    float mmx = kNeg;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = lane + 32 * u;
      if (j < B) sel[i * B + j] = chosen[u];
      if (pos[u] || chosen[u]) mmx = fmaxf(mmx, lg[u]);
    }
    const float mm = fmaxf(warp_max(mmx), -1e30f);
    float sm = 0.f;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u)
      if (pos[u] || chosen[u]) sm += expf(lg[u] - mm);
    sm = warp_sum(sm);
    if (lane == 0) {
      const float ip = 1.f / fmaxf(n_pos, 1.f);
      const float mean_pos = sum_pos * ip;
      m_all[i] = ma;
      s_all[i] = sa;
      m_m[i] = mm;
      s_m[i] = sm;
      inv_pos[i] = ip;
      has_pos[i] = n_pos > 0.f;
      valid_m[i] = (n_pos > 0.f && n_neg > 0.f);
      term_full[i] = ma + logf(fmaxf(sa, 1e-38f)) - mean_pos;
      term_mined[i] = mm + logf(fmaxf(sm, 1e-38f)) - mean_pos;
    }
  }
  __syncthreads();
  if (tid == 0) {  // rows in order: a deterministic sum
    float nf = 0.f, nm = 0.f, lf = 0.f, lm = 0.f;
    for (int i = 0; i < B; ++i) {
      nf += has_pos[i];
      nm += valid_m[i];
      if (has_pos[i] > 0.f) lf += term_full[i];
      if (valid_m[i] > 0.f) lm += term_mined[i];
    }
    const float alpha = *alpha_ptr;
    const float loss_full = lf / fmaxf(nf, 1.f);
    const float loss_mined = nm > 0.f ? lm / fmaxf(nm, 1.f) : loss_full;
    glob[0] = nf;
    glob[1] = nm;
    glob[2] = alpha;
    glob[3] = nf > 0.f ? (1.f - alpha) * loss_full + alpha * loss_mined : 0.f;
    *dalpha = nf > 0.f ? loss_mined - loss_full : 0.f;
  }
  __syncthreads();

  // ---- phase C: dL/dc per entry; the uniformity weights over the Gram ----
  {
    const float nf = glob[0], nm = glob[1], alpha = glob[2];
    const float c_full = (1.f - alpha) + alpha * (nm > 0.f ? 0.f : 1.f);
    const float c_mined = alpha * (nm > 0.f ? 1.f : 0.f);
    const float t_full = inv_tau / fmaxf(nf, 1.f);
    const float t_mined = inv_tau / fmaxf(nm, 1.f);
    for (int e = tid; e < B * B; e += kThreads) {
      const int i = e / B, j = e - i * B;
      float g = 0.f;
      if (nf > 0.f && i != j) {
        const float dot = gram[e];
        const float lg = sim.value(dot) * inv_tau;
        const float posf = labels[i] == labels[j] ? inv_pos[i] : 0.f;
        const float sm_all = expf(lg - m_all[i]) / fmaxf(s_all[i], 1e-38f);
        const bool denom = posf > 0.f || sel[e];
        const float sm_m =
            denom ? expf(lg - m_m[i]) / fmaxf(s_m[i], 1e-38f) : 0.f;
        const float gf = has_pos[i] > 0.f ? sm_all - posf : 0.f;
        const float gm = valid_m[i] > 0.f ? sm_m - posf : 0.f;
        g = (c_full * (t_full * gf) + c_mined * (t_mined * gm)) *
            sim.grad(dot);
      }
      gc[e] = g;
    }
    if (uniform) {
      __syncthreads();  // phase C read every Gram entry it needs
      for (int e = tid; e < B * B; e += kThreads) {
        const int i = e / B, j = e - i * B;
        const float d2 = fmaxf(sq[i] + sq[j] - 2.f * gram[e], 0.f);
        gram[e] = i == j ? 0.f : expf(-tu * d2);
      }
      __syncthreads();
      for (int i = warp; i < B; i += kWarps) {
        float acc = 0.f;
        for (int j = lane; j < B; j += 32) acc += gram[i * B + j];
        acc = warp_sum(acc);
        if (lane == 0) row_w[i] = acc;
      }
      __syncthreads();
      if (tid == 0) {
        float total = 0.f;
        for (int i = 0; i < B; ++i) total += row_w[i];
        const float n_pairs = (float)B * (float)(B - 1);
        const float mean_w = total / n_pairs;
        glob[3] += lam * logf(mean_w + 1e-8f);
        glob[4] = -2.f * tu / ((mean_w + 1e-8f) * n_pairs);  // coef
      }
    }
  }
  __syncthreads();
  if (tid == 0) *loss = glob[3];

  // ---- phase D: dz = (G + G^T) z + lambda * 2 coef (rowsum(W) z - W z) ----
  const float ucoef = uniform ? lam * 2.f * glob[4] : 0.f;
  for (int e = tid; e < B * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    float acc = 0.f, wz = 0.f;
    for (int j = 0; j < B; ++j) {
      const float zj = z[(size_t)j * D + d];
      acc = fmaf(gc[i * B + j] + gc[j * B + i], zj, acc);
      if (uniform) wz = fmaf(gram[i * B + j], zj, wz);
    }
    if (uniform) acc += ucoef * (row_w[i] * z[e] - wz);
    dz[e] = acc;
  }
}

}  // namespace

extern "C" {

int supcon_max_batch() { return kMaxB; }

// z (B, D) fp32; labels (B,) int32; alpha: one fp32 on the device; loss
// and dalpha: one fp32 each; dz (B, D) fp32. inv_tau = 1/temperature;
// k = max(1, min(topk, B - 1)); lam, tu: uniformity weight and t.
int supcon_fwd(const void* z, const void* labels, const void* alpha,
               void* loss, void* dz, void* dalpha, int B, int D,
               float inv_tau, int k, int geodesic, float lam, float tu,
               void* stream) {
  if (B <= 0 || B > kMaxB || D <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(
      supcon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  supcon_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int*>(labels),
      static_cast<const float*>(alpha), static_cast<float*>(loss),
      static_cast<float*>(dz), static_cast<float*>(dalpha), B, D, inv_tau, k,
      geodesic, lam, tu);
  return (int)cudaGetLastError();
}

}  // extern "C"
