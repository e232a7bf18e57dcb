// Fused binary SupCon loss with its analytic gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of
// wav2vec_contr_loss_tpu/ops/supcon_pallas.py, and the similarity remap
// that its wrapper computes outside the kernel (:172-183, only because
// Mosaic cannot lower arccos). From z (B, D) fp32, the labels and alpha:
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
// Bound: two B x B x D products, the Gram and A z, 4 B^2 D fp32
// operations (at B = 1024, D = 256: 1.07 GFLOP, 16 us at 67 TFLOP/s),
// against 2 B D x 4 bytes of z and dz. At the training shape (B = 32)
// both are tens of nanoseconds and two launches' latency is the floor.
// The products run on the fp32 pipes, not TF32: dz is held to rtol
// 5e-4, and 1/tau up to 14 would carry TF32's rounding past that.
//
// Design: two kernels, no atomics, every output written once, so two
// calls give the same bits.
//   supcon_rows_kernel, one block per kR anchor rows: streams z from L2
//     in float4 runs and forms the (kR, B) Gram stripe with register
//     tiles of kR x 4 fp32 FMAs a thread, the reduction over D split
//     across neighbouring lanes and added by a fixed warp butterfly (so
//     G[i, j] and G[j, i] are the same sums, bit for bit: the Gram is
//     symmetric). Then one warp an anchor row, over the stripe in shared
//     memory: the masks, the full log-sum-exp, the top-k of the
//     negatives as a threshold (the last pick in (value, then lower
//     index) order, which makes the selection the first-occurrence
//     argmax of the Pallas loop with no per-column state): up to B = 32,
//     one column a lane, each negative's rank among the others in one
//     step; above, a walk of k rounds, each taking the largest negative
//     below the last pick. Then the mined log-sum-exp and the row terms.
//     It writes the row terms, the selection as bits, and the stripe.
//   supcon_dz_kernel, one block per kR rows of dz: adds the B row terms
//     through a fixed tree (every block gets the same nf, nm, loss and
//     mean w; block 0 writes the loss and dL/dalpha), then rebuilds
//     A[i, j] = g_c[i, j] + g_c[j, i] - lambda 2c w_ij for its rows from
//     the symmetric Gram, both rows' terms and the selection bits, kChunk
//     columns at a time in shared memory (so its footprint does not grow
//     with B), and forms dz = A z + lambda 2c rowsum(W) z with the same
//     register tiles and butterfly, the reduction over j split across
//     neighbouring lanes. It is launched as a programmatic dependent
//     launch, so its blocks are scheduled while the rows kernel runs.
// What bounds the batch is the rows kernel's shared memory: its Gram
// stripe (kR x B fp32) and the squared norms of all B rows beside the
// anchors (D x kR), so B <= 4096 and D <= 1024 (184 KB at both
// limits). The (B, B) Gram scratch (64 MB at B = 4096) lives in
// device memory, allocated by the caller. At large B the rows kernel
// reads all of z once a block from L2 for kR x B x D FMAs, 2 FMAs a
// byte, so L2 and not the fp32 pipes bounds it there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 8;            // anchor rows (kernel 1) / dz rows (kernel 2)
constexpr int kMaxB = 4096;
constexpr int kMaxD = 1024;
constexpr int kTileSum = 36;     // a thread's 8 x 4 tile and 4 squared norms
// the anchors in shared memory, column quad dq at dq * kZaStride: 4 x kR
// values and 4 of padding, so float4 reads of neighbouring quads by
// neighbouring lanes fall in different banks
constexpr int kZaStride = 4 * kR + 4;
constexpr int kChunk = 512;      // columns of A a dz pass holds
constexpr float kNeg = -1e30f;

// row terms, one (B,) array each
enum Term {
  kMAll, kSAll, kMMined, kSMined, kInvPos, kHasPos, kValidM, kTermFull,
  kTermMined, kSq, kRowW, kTerms
};

size_t rows_smem(int B, int D) {
  return sizeof(float) * ((size_t)(D / 4) * kZaStride + (size_t)kR * B +
                          B) +
         sizeof(uint32_t) * kR * (size_t)((B + 31) / 32);
}

size_t dz_smem() {
  return sizeof(float) * ((size_t)kChunk * kR + (size_t)(kThreads / 32) * 5 +
                          (size_t)kTerms * kR) +
         sizeof(long long) * kR;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats as unsigned ints of the same order (no NaNs), so a warp's max
// is one redux.sync
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ float warp_max(float x) {
  return from_ordered(__reduce_max_sync(0xffffffffu, ordered(x)));
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

// threads of a tile pass: nq column quads x (256 / nq) reduction groups,
// nq the power of two that covers n/4 columns, at least 8 (so a quad's
// groups lie in one warp) and at most `most`
__device__ __forceinline__ int quads_for(int n, int most) {
  int nq = 8;
  while (nq < most && 4 * nq < n) nq <<= 1;
  return nq;
}

__global__ void __launch_bounds__(kThreads)
supcon_rows_kernel(const float* __restrict__ z, const long long* __restrict__ labels,
                   float* __restrict__ gram, float* __restrict__ terms,
                   uint32_t* __restrict__ sel, int B, int D, float inv_tau,
                   int k, int geodesic, float lam, float tu) {
  extern __shared__ __align__(16) float sm[];
  float* za = sm;                                  // (D / 4, kZaStride)
  float* stripe = za + (size_t)(D / 4) * kZaStride;   // (kR, B)
  float* sq = stripe + (size_t)kR * B;             // (B,)
  uint32_t* negbits = reinterpret_cast<uint32_t*>(sq + B);   // (kR, B/32)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * kR;
  const Sim sim{geodesic != 0};
  const bool uniform = lam > 0.f && B > 1;
  // the dz kernel may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int dquads = D / 4;
#pragma unroll 4
  for (int e = tid; e < kR * dquads; e += kThreads) {
    const int r = e / dquads, dq = e - r * dquads;
    const float4 v = i0 + r < B ? *reinterpret_cast<const float4*>(
                                      z + (size_t)(i0 + r) * D + 4 * dq)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    float* p = za + dq * kZaStride + r;
    p[0] = v.x;
    p[kR] = v.y;
    p[2 * kR] = v.z;
    p[3 * kR] = v.w;
  }
  __syncthreads();

  // ---- the Gram stripe, kR x 4 register tiles ----
  // the reduction groups are the fast index: a warp's lanes read
  // consecutive quads of the same rows of z
  const int nq = quads_for(B, 64), ks = kThreads / nq;
  const int g = tid % ks, q = tid / ks;
  for (int jb = 0; jb < B; jb += 4 * nq) {
    float acc[kR][4], sqa[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sqa[c] = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r][c] = 0.f;
    }
    const int j0 = jb + 4 * q;
#pragma unroll 2
    for (int dq = g; dq < dquads; dq += ks) {
      float4 zc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        zc[c] = j0 + c < B ? *reinterpret_cast<const float4*>(
                                 z + (size_t)(j0 + c) * D + 4 * dq)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* ap = za + dq * kZaStride + u * kR;
        const float4 a0 = *reinterpret_cast<const float4*>(ap);
        const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
        const float a[kR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float zj = u == 0 ? zc[c].x
                         : u == 1 ? zc[c].y
                         : u == 2 ? zc[c].z
                                  : zc[c].w;
          sqa[c] = fmaf(zj, zj, sqa[c]);
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r][c] = fmaf(a[r], zj, acc[r][c]);
        }
      }
    }
    // add the groups: a butterfly over the lanes that hold one quad (a
    // fixed tree, the same for G[i, j] and G[j, i])
    float part[kTileSum];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[4 * r + c] = acc[r][c];
#pragma unroll
    for (int c = 0; c < 4; ++c) part[32 + c] = sqa[c];
    for (int o = ks / 2; o > 0; o >>= 1)
#pragma unroll
      for (int v = 0; v < kTileSum; ++v)
        part[v] += __shfl_xor_sync(0xffffffffu, part[v], o);
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        if (j >= B) continue;
#pragma unroll
        for (int r = 0; r < kR; ++r) stripe[r * B + j] = part[4 * r + c];
        sq[j] = part[32 + c];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kR * B; e += kThreads) {
    const int r = e / B;
    if (i0 + r < B) gram[(size_t)(i0 + r) * B + (e - r * B)] = stripe[e];
  }
  __syncthreads();            // the warps overwrite their rows with logits

  // ---- one warp an anchor row ----
  const int i = i0 + warp;
  if (i >= B) return;
  float* row = stripe + (size_t)warp * B;
  const long long li = labels[i];
  const int words = (B + 31) / 32;
  const float sq_i = sq[i];
  float roww = 0.f;
  if (uniform) {
    for (int j = lane; j < B; j += 32)
      if (j != i)
        roww += expf(-tu * fmaxf(sq_i + sq[j] - 2.f * row[j], 0.f));
    roww = warp_sum(roww);
  }
  __syncwarp();
  // logits in place; this row's negatives as bits (one word a 32
  // columns, so later passes skip the labels); the counts, the full max
  uint32_t* negw = negbits + (size_t)warp * words;
  int n_pos_l = 0, n_neg_l = 0;
  float sum_pos = 0.f, mx = kNeg;
  for (int u = 0; u < words; ++u) {
    const int j = 32 * u + lane;
    bool neg = false;
    if (j < B) {
      const bool off = j != i;
      const float lg = off ? sim.value(row[j]) * inv_tau : kNeg;
      row[j] = lg;
      const bool same = __ldg(labels + j) == li;
      neg = off && !same;
      n_pos_l += off && same;
      n_neg_l += neg;
      sum_pos += off && same ? lg : 0.f;
      if (off) mx = fmaxf(mx, lg);
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, neg);
    if (lane == 0) negw[u] = bits;
  }
  __syncwarp();
  const float n_pos = (float)__reduce_add_sync(0xffffffffu, n_pos_l);
  const float n_neg = (float)__reduce_add_sync(0xffffffffu, n_neg_l);
  sum_pos = warp_sum(sum_pos);
  const float ma = fmaxf(warp_max(mx), -1e30f);
  float sa = 0.f;
  for (int j = lane; j < B; j += 32)
    if (j != i) sa += expf(row[j] - ma);
  sa = warp_sum(sa);
  // top-k of the negatives, as a threshold: the last pick (tv, tj) in
  // (value, then lower index) order
  float tv = __int_as_float(0x7f800000);   // +inf: every negative eligible
  int tj = -1, picked = 0;
  if (B <= 32) {
    // one column a lane: a negative is picked iff fewer than k negatives
    // come before it in that order, so the pick of rank k - 1 is the
    // threshold, with no serial rounds (at B = 32, k = 15 this takes the
    // two kernels from 0.0145 to 0.0128 ms on an H100)
    const uint32_t negs = negw[0];
    const bool neg = (negs >> lane) & 1u;
    const float v = lane < B ? row[lane] : kNeg;
    int rank = 0;
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      const float vo = __shfl_sync(0xffffffffu, v, o);
      rank += ((negs >> o) & 1u) && (vo > v || (vo == v && o < lane));
    }
    const uint32_t last = __ballot_sync(0xffffffffu, neg && rank == k - 1);
    if (last) {
      tj = __ffs(last) - 1;
      tv = __shfl_sync(0xffffffffu, v, tj);
      picked = k;
    }
  }
  for (; B > 32 && picked < k; ++picked) {
    // each round the largest negative below the last pick
    float bv = kNeg;
    int bj = 0x7fffffff;
#pragma unroll 4
    for (int u = 0; u < words; ++u) {
      if (!((negw[u] >> lane) & 1u)) continue;
      const int j = 32 * u + lane;
      const float lg = row[j];
      if ((lg < tv || (lg == tv && j > tj)) && lg > bv) {
        bv = lg;
        bj = j;
      }
    }
    // the warp's largest, and the lowest column that holds it
    const float wv = warp_max(bv);
    bj = (int)__reduce_min_sync(0xffffffffu,
                                bv == wv ? (uint32_t)bj : 0x7fffffffu);
    bv = wv;
    if (!(bv > kNeg / 2)) break;           // no negative left
    tv = bv;
    tj = bj;
  }
  if (picked < k) tv = -__int_as_float(0x7f800000);   // every negative
  // mined term over the positives and the picks; the picks as bits
  auto in_mined = [&](int j, float lg, uint32_t bits) {
    const bool neg = (bits >> (j & 31)) & 1u;
    return !neg || lg > tv || (lg == tv && j <= tj);
  };
  float mmx = kNeg;
  for (int u = 0; u < words; ++u) {
    const int j = 32 * u + lane;
    const uint32_t bits = negw[u];
    bool chosen = false;
    if (j < B && j != i) {
      const float lg = row[j];
      chosen = ((bits >> lane) & 1u) && in_mined(j, lg, bits);
      if (in_mined(j, lg, bits)) mmx = fmaxf(mmx, lg);
    }
    const uint32_t picks = __ballot_sync(0xffffffffu, chosen);
    if (lane == 0) sel[(size_t)i * words + u] = picks;
  }
  const float mm = fmaxf(warp_max(mmx), -1e30f);
  float smn = 0.f;
  for (int u = 0; u < words; ++u) {
    const int j = 32 * u + lane;
    if (j >= B || j == i) continue;
    const float lg = row[j];
    if (in_mined(j, lg, negw[u])) smn += expf(lg - mm);
  }
  smn = warp_sum(smn);
  if (lane == 0) {
    const float ip = 1.f / fmaxf(n_pos, 1.f);
    const float mean_pos = sum_pos * ip;
    terms[kMAll * B + i] = ma;
    terms[kSAll * B + i] = sa;
    terms[kMMined * B + i] = mm;
    terms[kSMined * B + i] = smn;
    terms[kInvPos * B + i] = ip;
    terms[kHasPos * B + i] = n_pos > 0.f;
    terms[kValidM * B + i] = n_pos > 0.f && n_neg > 0.f;
    terms[kTermFull * B + i] = ma + logf(fmaxf(sa, 1e-38f)) - mean_pos;
    terms[kTermMined * B + i] = mm + logf(fmaxf(smn, 1e-38f)) - mean_pos;
    terms[kSq * B + i] = sq_i;
    terms[kRowW * B + i] = roww;
  }
}

// the terms of one anchor row that dL/dc reads
struct RowTerms {
  float m_all, s_all, m_m, s_m, inv_pos, has_pos, valid_m;
};

struct Blend {
  float c_full, c_mined, t_full, t_mined;
  // dL/dsim of entry (a, b) seen from anchor row a
  __device__ __forceinline__ float g(const RowTerms& a, float lg, bool same,
                                     bool picked) const {
    const float posf = same ? a.inv_pos : 0.f;
    const float sm_all = expf(lg - a.m_all) / fmaxf(a.s_all, 1e-38f);
    const float sm_m = (posf > 0.f || picked)
                           ? expf(lg - a.m_m) / fmaxf(a.s_m, 1e-38f)
                           : 0.f;
    const float gf = a.has_pos > 0.f ? sm_all - posf : 0.f;
    const float gm = a.valid_m > 0.f ? sm_m - posf : 0.f;
    return c_full * (t_full * gf) + c_mined * (t_mined * gm);
  }
};

__device__ __forceinline__ RowTerms row_terms(const float* t, int B, int i) {
  return {t[kMAll * B + i],   t[kSAll * B + i],   t[kMMined * B + i],
          t[kSMined * B + i], t[kInvPos * B + i], t[kHasPos * B + i],
          t[kValidM * B + i]};
}

__global__ void __launch_bounds__(kThreads)
supcon_dz_kernel(const float* __restrict__ z, const long long* __restrict__ labels,
                 const float* __restrict__ alpha_ptr,
                 const float* __restrict__ gram,
                 const float* __restrict__ terms,
                 const uint32_t* __restrict__ sel, float* __restrict__ loss,
                 float* __restrict__ dz, float* __restrict__ dalpha, int B,
                 int D, float inv_tau, int geodesic, float lam, float tu) {
  extern __shared__ __align__(16) float sm[];
  float* at = sm;                                  // (kR, kChunk): A
  float* red = at + (size_t)kChunk * kR;           // (8 warps, 5)
  float* mine = red + (size_t)(kThreads / 32) * 5;    // (kTerms, kR)
  long long* lab_i =
      reinterpret_cast<long long*>(mine + kTerms * kR);     // (kR,)

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kR;
  const Sim sim{geodesic != 0};
  const bool uniform = lam > 0.f && B > 1;
  const int words = (B + 31) / 32;
  // launched early behind the rows kernel (programmatic dependent
  // launch): wait here until its writes are complete and visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // ---- global sums: strided partials, a butterfly in each warp, the
  // warps' sums in warp order (a fixed tree: every block gets the same
  // bits) ----
  {
    const int lane = tid & 31, warp = tid >> 5;
    float nf = 0.f, nm = 0.f, lf = 0.f, lm = 0.f, tw = 0.f;
    for (int i = tid; i < B; i += kThreads) {
      const float hp = terms[kHasPos * B + i], vm = terms[kValidM * B + i];
      nf += hp;
      nm += vm;
      if (hp > 0.f) lf += terms[kTermFull * B + i];
      if (vm > 0.f) lm += terms[kTermMined * B + i];
      tw += terms[kRowW * B + i];
    }
    nf = warp_sum(nf);
    nm = warp_sum(nm);
    lf = warp_sum(lf);
    lm = warp_sum(lm);
    tw = warp_sum(tw);
    if (lane == 0) {
      float* p = red + warp * 5;
      p[0] = nf; p[1] = nm; p[2] = lf; p[3] = lm; p[4] = tw;
    }
  }
  for (int e = tid; e < kTerms * kR; e += kThreads) {
    const int f = e / kR, r = e - f * kR;
    mine[e] = i0 + r < B ? terms[f * B + i0 + r] : 0.f;
  }
  if (tid < kR) lab_i[tid] = i0 + tid < B ? labels[i0 + tid] : 0;
  __syncthreads();
  float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int w = 0; w < kThreads / 32; ++w)            // warps in order
#pragma unroll
    for (int v = 0; v < 5; ++v) sums[v] += red[w * 5 + v];
  const float nf = sums[0], nm = sums[1], lf = sums[2], lm = sums[3],
              tw = sums[4];
  const float alpha = *alpha_ptr;
  const float loss_full = lf / fmaxf(nf, 1.f);
  const float loss_mined = nm > 0.f ? lm / fmaxf(nm, 1.f) : loss_full;
  float total = nf > 0.f ? (1.f - alpha) * loss_full + alpha * loss_mined : 0.f;
  float ucoef = 0.f;
  if (uniform) {
    const float n_pairs = (float)B * (float)(B - 1);
    const float mean_w = tw / n_pairs;
    total += lam * logf(mean_w + 1e-8f);
    ucoef = lam * 2.f * (-2.f * tu / ((mean_w + 1e-8f) * n_pairs));
  }
  if (blockIdx.x == 0 && tid == 0) {
    *loss = total;
    *dalpha = nf > 0.f ? loss_mined - loss_full : 0.f;
  }
  const Blend blend{(1.f - alpha) + alpha * (nm > 0.f ? 0.f : 1.f),
                    alpha * (nm > 0.f ? 1.f : 0.f), inv_tau / fmaxf(nf, 1.f),
                    inv_tau / fmaxf(nm, 1.f)};
  __syncthreads();                 // every thread has read the tree's root

  // ---- dz = A z + ucoef rowsum(W) z over chunks of kChunk columns of
  // A: each chunk is built in shared memory, then multiplied with kR x 4
  // register tiles that persist over the chunks (thread (q, g): column
  // quad q of dz, rows j = g, g + ks, ... of z, in order) ----
  const int dquads = D / 4;
  const int nq = quads_for(D, kMaxD / 4);
  // the reduction groups are the fast index, as in the rows kernel
  const int ks = kThreads / nq, g = tid % ks, q = tid / ks;
  float acc[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int j0 = 0; j0 < B; j0 += kChunk) {
    const int jn = min(kChunk, B - j0);
    // one entry (r, j) a thread: consecutive threads, consecutive j
#pragma unroll 2
    for (int e = tid; e < kR * jn; e += kThreads) {
      const int r = e / jn, jj = e - r * jn, i = i0 + r, j = j0 + jj;
      float a = 0.f;
      if (i < B && i != j) {
        const float dot = gram[(size_t)i * B + j];
        const uint32_t w_ij = sel[(size_t)i * words + (j >> 5)];
        const uint32_t w_ji = sel[(size_t)j * words + (i >> 5)];
        const RowTerms tjr = row_terms(terms, B, j);
        const float sq_j = terms[kSq * B + j];
        const long long lj = labels[j];
        if (nf > 0.f) {
          const RowTerms tir = {mine[kMAll * kR + r],   mine[kSAll * kR + r],
                                mine[kMMined * kR + r], mine[kSMined * kR + r],
                                mine[kInvPos * kR + r], mine[kHasPos * kR + r],
                                mine[kValidM * kR + r]};
          const float lg = sim.value(dot) * inv_tau, dg = sim.grad(dot);
          const bool same = lab_i[r] == lj;
          a = blend.g(tir, lg, same, (w_ij >> (j & 31)) & 1u) * dg +
              blend.g(tjr, lg, same, (w_ji >> (i & 31)) & 1u) * dg;
        }
        if (uniform)
          a -= ucoef * expf(-tu * fmaxf(mine[kSq * kR + r] + sq_j -
                                           2.f * dot, 0.f));
      }
      at[r * kChunk + jj] = a;
    }
    __syncthreads();
    if (q < dquads) {
#pragma unroll 4
      for (int jj = g; jj < jn; jj += ks) {
        float a[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) a[r] = at[r * kChunk + jj];
        const float4 zz = *reinterpret_cast<const float4*>(
            z + (size_t)(j0 + jj) * D + 4 * q);
        const float zv[4] = {zz.x, zz.y, zz.z, zz.w};
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], zv[c], acc[r][c]);
      }
    }
    __syncthreads();                       // the chunk of A is free
  }
  // add the groups: a butterfly over the lanes that hold one quad
  for (int o = ks / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
  if (g != 0 || q >= dquads) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r;
    if (i >= B) break;
    float4 zi = make_float4(0.f, 0.f, 0.f, 0.f);
    if (uniform)
      zi = *reinterpret_cast<const float4*>(z + (size_t)i * D + 4 * q);
    const float u = ucoef * mine[kRowW * kR + r];
    *reinterpret_cast<float4*>(dz + (size_t)i * D + 4 * q) =
        make_float4(acc[r][0] + u * zi.x, acc[r][1] + u * zi.y,
                    acc[r][2] + u * zi.z, acc[r][3] + u * zi.w);
  }
}

// The shared-memory attributes, set once per process and device for the
// largest batch and width the kernels take.
cudaError_t set_attributes() {
  static OncePerDevice once;
  return once([](int) {
    cudaError_t e = cudaFuncSetAttribute(
        supcon_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rows_smem(kMaxB, kMaxD));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(supcon_dz_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dz_smem());
    return e;
  });
}

}  // namespace

extern "C" {

int supcon_max_batch() { return kMaxB; }
int supcon_max_dim() { return kMaxD; }
int supcon_row_terms() { return kTerms; }

// z (B, D) fp32, 16-byte aligned, D a multiple of 4; labels (B,) int64;
// alpha: one fp32 on the device; loss and dalpha: one fp32 each; dz
// (B, D) fp32. Scratch: gram (B, B) fp32, terms (supcon_row_terms(), B)
// fp32, sel (B, ceil(B / 32)) uint32. inv_tau = 1/temperature;
// k = max(1, min(topk, B - 1)); lam, tu: uniformity weight and t.
int supcon_fwd(const void* z, const void* labels, const void* alpha,
               void* loss, void* dz, void* dalpha, void* gram, void* terms,
               void* sel, int B, int D, float inv_tau, int k, int geodesic,
               float lam, float tu, void* stream) {
  if (B <= 0 || B > kMaxB || D <= 0 || D > kMaxD || D % 4 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kR - 1) / kR;
  supcon_rows_kernel<<<blocks, kThreads, rows_smem(B, D), s>>>(
      static_cast<const float*>(z), static_cast<const long long*>(labels),
      static_cast<float*>(gram), static_cast<float*>(terms),
      static_cast<uint32_t*>(sel), B, D, inv_tau, k, geodesic, lam, tu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the dz kernel's blocks are scheduled
  // while the rows kernel runs and wait for it in griddepcontrol.wait,
  // which hides the second launch's latency
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dz_smem();
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, supcon_dz_kernel, static_cast<const float*>(z),
      static_cast<const long long*>(labels), static_cast<const float*>(alpha),
      static_cast<const float*>(gram), static_cast<const float*>(terms),
      static_cast<const uint32_t*>(sel), static_cast<float*>(loss),
      static_cast<float*>(dz), static_cast<float*>(dalpha), B, D, inv_tau,
      geodesic, lam, tu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
