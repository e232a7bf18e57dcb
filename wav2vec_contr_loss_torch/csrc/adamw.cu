// AdamW over a whole optimizer group in one pass: for every element of
// every parameter, the clip's scale on its gradient, both moment updates,
// the bias-corrected step with weight decay, and the moments rounded back
// to their storage dtype. One launch takes a table of up to kCapacity
// tensors (train/optim.py `launch_tables` splits a group into tables).
//
// It replaces no Pallas kernel: the JAX package's update
// (wav2vec_contr_loss_tpu/ops/adam_bf16nu.py `_scale_by_adam_storage`) is
// jnp that XLA fuses. In PyTorch the same arithmetic ran as 16 eager
// operations a parameter (train/optim.py `adamw_plain`), ~6,700 device
// operations and ~140 bytes of traffic a parameter a step at XLS-R 300M.
// This kernel is that fusion, done by hand.
//
// Bound: bytes. p (fp32) read and written, g (fp32) read, mu and nu read
// and written in their storage dtype: 20 bytes a parameter with bf16
// moments, 6.3 GB and 1.9 ms at 3.35 TB/s for XLS-R 300M's 315M
// parameters. Design: a block takes kChunk elements of one tensor; it
// finds its tensor by a binary search over the table's first blocks
// (the table is a __grid_constant__ parameter, read in place from the
// constant bank, never copied). Each thread keeps kUnroll vectors of each
// array in flight before it computes: 16-byte loads and stores of p and
// g, 8-byte ones of bf16 moments (16-byte of fp32). A tensor whose
// pointers are not aligned for those vectors takes scalar loads; the
// ragged end of a tensor (fewer than 4 elements) takes a scalar tail.
//
// The arithmetic is the plain loop's, operation by operation, in fp32,
// each step rounded where PyTorch's CUDA kernel rounds it:
//
//   g  = g * scale                       (when a clip's scale is given)
//   m  = fma(1 - b1, g, mu * b1)          add_(g, alpha) is one fma
//   v  = fma(1 - b2, g * g, nu * b2)      addcmul_: the product, then fma
//   u  = (m * 1/bc1) / (sqrt(v * 1/bc2) + eps)
//                                         a tensor divided by a Python
//                                         scalar is a multiply by its fp32
//                                         reciprocal on CUDA
//   u  = fma(wd, p, u) * -lr
//   p  = p + u
//   mu, nu = round-to-nearest of m and v into their storage dtype
//
// The __f*_rn intrinsics keep the compiler from contracting a product
// and a sum that PyTorch rounds apart. The scalars come from the caller
// already cast to fp32 as PyTorch casts them. A null gradient is read as
// zeros (a parameter that got none); a null scale means no clip. The
// kernel runs on the caller's stream, allocates nothing and never
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;     // elements a vector: 16 bytes of fp32
constexpr int kUnroll = 4;  // vectors of each array a thread keeps in flight
constexpr int kChunk = kThreads * kVec * kUnroll;  // elements a block
// tensors a launch: the table below (28,216 bytes) stays inside the
// 32,764 bytes of kernel parameters that CUDA 12.1 and later take
constexpr int kCapacity = 640;

struct Table {
  float* p[kCapacity];
  const float* g[kCapacity];  // null: no gradient, read as zeros
  void* mu[kCapacity];
  void* nu[kCapacity];
  long long n[kCapacity];
  unsigned first[kCapacity];  // the first block of each tensor
  int count;
  const float* scale;  // the clip's 0-d fp32 factor on the device, or null
  float b1, a1, b2, a2, inv_bc1, inv_bc2, eps, wd, neg_lr;
};
static_assert(sizeof(Table) <= 32764, "kernel parameters over CUDA's limit");

struct Bf16 {
  using Raw = unsigned short;
  using Vec = uint2;  // 4 elements
  __device__ static float load(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ static Raw store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F32 {
  using Raw = float;
  using Vec = uint4;
  __device__ static float load(Raw r) { return r; }
  __device__ static Raw store(float f) { return f; }
};

template <class D>
union Moments {
  typename D::Vec v;
  typename D::Raw e[kVec];
};

union Floats {
  float4 v;
  float e[kVec];
};

__device__ __forceinline__ void update(const Table& t, float& p, float g,
                                       float& m, float& v) {
  m = __fmaf_rn(t.a1, g, __fmul_rn(m, t.b1));
  v = __fmaf_rn(t.a2, __fmul_rn(g, g), __fmul_rn(v, t.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, t.inv_bc2)), t.eps);
  float u = __fdiv_rn(__fmul_rn(m, t.inv_bc1), den);
  u = __fmul_rn(__fmaf_rn(t.wd, p, u), t.neg_lr);
  p = __fadd_rn(p, u);
}

template <class M, class N>
__device__ __forceinline__ void scalar(const Table& t, float* p,
                                       const float* g, typename M::Raw* mu,
                                       typename N::Raw* nu, long long i,
                                       bool scaled, float s) {
  float gi = g ? g[i] : 0.0f;
  if (scaled) gi = __fmul_rn(gi, s);
  float pi = p[i], m = M::load(mu[i]), v = N::load(nu[i]);
  update(t, pi, gi, m, v);
  p[i] = pi;
  mu[i] = M::store(m);
  nu[i] = N::store(v);
}

template <class M, class N>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ Table t) {
  using MR = typename M::Raw;
  using NR = typename N::Raw;
  // the tensor of this block: the last whose first block is <= it
  const unsigned b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  float* __restrict__ p = t.p[lo];
  const float* __restrict__ g = t.g[lo];
  MR* __restrict__ mu = static_cast<MR*>(t.mu[lo]);
  NR* __restrict__ nu = static_cast<NR*>(t.nu[lo]);
  const long long n = t.n[lo];
  const long long start = static_cast<long long>(b - t.first[lo]) * kChunk;
  const long long end = start + kChunk < n ? start + kChunk : n;
  const bool scaled = t.scale != nullptr;
  const float s = scaled ? *t.scale : 1.0f;

  const uintptr_t a16 = reinterpret_cast<uintptr_t>(p) |
                        reinterpret_cast<uintptr_t>(g);
  const bool vec =
      a16 % 16 == 0 &&
      reinterpret_cast<uintptr_t>(mu) % sizeof(typename M::Vec) == 0 &&
      reinterpret_cast<uintptr_t>(nu) % sizeof(typename N::Vec) == 0;
  if (!vec) {
    for (long long i = start + threadIdx.x; i < end; i += kThreads)
      scalar<M, N>(t, p, g, mu, nu, i, scaled, s);
    return;
  }

  // whole vectors: every load of the thread in flight before any update
  const long long vend = start + (end - start) / kVec * kVec;
  Floats pv[kUnroll], gv[kUnroll];
  Moments<M> mv[kUnroll];
  Moments<N> nv[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = start + (k * kThreads + threadIdx.x) * kVec;
    if (i < vend) {
      pv[k].v = *reinterpret_cast<const float4*>(p + i);
      if (g)
        gv[k].v = __ldg(reinterpret_cast<const float4*>(g + i));
      else
        gv[k].v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      mv[k].v = *reinterpret_cast<const typename M::Vec*>(mu + i);
      nv[k].v = *reinterpret_cast<const typename N::Vec*>(nu + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = start + (k * kThreads + threadIdx.x) * kVec;
    if (i < vend) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float gj = gv[k].e[j];
        if (scaled) gj = __fmul_rn(gj, s);
        float m = M::load(mv[k].e[j]), v = N::load(nv[k].e[j]);
        update(t, pv[k].e[j], gj, m, v);
        mv[k].e[j] = M::store(m);
        nv[k].e[j] = N::store(v);
      }
      *reinterpret_cast<float4*>(p + i) = pv[k].v;
      *reinterpret_cast<typename M::Vec*>(mu + i) = mv[k].v;
      *reinterpret_cast<typename N::Vec*>(nu + i) = nv[k].v;
    }
  }
  // the tensor's ragged end: fewer than kVec elements
  if (vend + threadIdx.x < end)
    scalar<M, N>(t, p, g, mu, nu, vend + threadIdx.x, scaled, s);
}

template <class M, class N>
cudaError_t launch(const Table& t, unsigned blocks, cudaStream_t stream) {
  adamw_kernel<M, N><<<blocks, kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

// The kernel's fixed sizes: tensors a launch, elements a block.
extern "C" void adamw_limits(int* capacity, int* chunk) {
  *capacity = kCapacity;
  *chunk = kChunk;
}

// One launch over `count` (1..kCapacity) non-empty tensors: fp32
// parameters p[i] and gradients g[i] (null: none), moments mu[i] and
// nu[i] in fp32 where mu_f32 / nu_f32 are nonzero, else bf16, of n[i]
// elements each, the four of one i each a dense block of memory with its
// elements in one order (the update is elementwise, so any one layout
// does); first[i] the first of tensor i's blocks and `blocks` their
// total, each block kChunk elements of one tensor. `scale`: the clip's
// fp32 factor on the device, or null. `scalars`: b1, 1 - b1, b2, 1 - b2,
// 1 / bc1, 1 / bc2, eps, weight decay, -lr, each in fp32. Returns a
// cudaError_t.
extern "C" int adamw(int mu_f32, int nu_f32, int count, void* const* p,
                     void* const* g, void* const* mu, void* const* nu,
                     const long long* n, const unsigned* first,
                     unsigned blocks, const void* scale,
                     const float* scalars, void* stream) {
  if (count < 1 || count > kCapacity || blocks < 1)
    return cudaErrorInvalidValue;
  Table t;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1 || p[i] == nullptr) return cudaErrorInvalidValue;
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.mu[i] = mu[i];
    t.nu[i] = nu[i];
    t.n[i] = n[i];
    t.first[i] = first[i];
  }
  t.count = count;
  t.scale = static_cast<const float*>(scale);
  t.b1 = scalars[0];
  t.a1 = scalars[1];
  t.b2 = scalars[2];
  t.a2 = scalars[3];
  t.inv_bc1 = scalars[4];
  t.inv_bc2 = scalars[5];
  t.eps = scalars[6];
  t.wd = scalars[7];
  t.neg_lr = scalars[8];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_f32)
    return nu_f32 ? launch<F32, F32>(t, blocks, s)
                  : launch<F32, Bf16>(t, blocks, s);
  return nu_f32 ? launch<Bf16, F32>(t, blocks, s)
                : launch<Bf16, Bf16>(t, blocks, s);
}
