// Murmur dropout in one pass: for each element the murmur3-finalizer
// bits of its coordinates and the seed, compared with the rate's
// threshold, then x / (1 - rate) written where they reach it and 0 where
// they do not. The bits are `murmur_bits` of ops/dropout.py, the port of
// wav2vec_contr_loss_tpu/ops/fast_dropout.py:46:
//
//   h  = seed * 0x9E3779B9 + 0x85EBCA6B
//   h ^= (index_a + offset_a) * kAxisMults[a]   for every axis a
//   bits = fmix32(h)                            all in uint32
//
// It replaces no Pallas kernel: fast_dropout.py is jnp that XLA fuses into
// one elementwise pass. In PyTorch the same hash ran as ~47 eager int64
// operations a call, ~21 of them over the whole activation, ~100 ms of
// device time and ~4,650 host dispatches a stage-1 step at B = 32
// (PERF.md §5): this kernel is that fusion, done by hand.
//
// Bound: bytes. One read of x and one write of the output, 2 * numel *
// itemsize; at (32, 249, 1024) bf16 32.6 MB, 9.7 us at 3.35 TB/s. The
// hash is ~12 integer operations an element in registers. Design: each
// thread takes 16 bytes along the innermost (contiguous) axis (8 bf16 or
// 4 fp32) as one vector load and one vector store, in two rows at a time
// (both loads in flight before the hashing: 78 % of the bound at that
// shape against 73 % a row at a time, H100), builds each row's term from
// the leading coordinates once and each column's term once, and masks a
// ragged tail (an innermost size that is no multiple of the
// vector, or a misaligned base, takes the scalar loads of the same
// layout). Unit leading axes are folded into the seed's term on the host,
// so the kernel divides only by the sizes that index something. The
// backward is this kernel on the incoming gradient: the mask is recomputed
// from the seed, and none is stored.
//
// The scale is the caller's fp32 multiplier. PyTorch's CUDA `x / s` for
// a Python scalar s multiplies by the fp32 reciprocal of s and rounds to
// x's dtype once; the caller passes that reciprocal, so the output equals
// `torch.where(keep, x / (1 - rate), 0)` bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxLead = kMaxDims - 1;
constexpr int kThreads = 256;
constexpr unsigned kRows = 2;  // rows a thread takes at a time
constexpr unsigned kMaxGridY = 65535;
// distinct odd multipliers per axis (fast_dropout.py:42)
constexpr unsigned kAxisMults[kMaxDims] = {
    2654435761u, 2246822519u, 3266489917u, 668265263u,
    374761393u,  2554388019u, 2869860233u, 179424673u};

struct Params {
  const void* x;
  void* out;
  unsigned rows;    // product of the leading sizes
  unsigned inner;   // innermost size
  unsigned chunks;  // vectors a row: ceil(inner / elements a vector)
  int n_lead;       // leading axes of size > 1
  unsigned lead_size[kMaxLead];
  unsigned lead_off[kMaxLead];
  unsigned lead_mult[kMaxLead];
  unsigned col_off, col_mult;
  unsigned h0;  // the seed's term ^ the terms of unit leading axes
  unsigned threshold;
  float scale;
};

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

struct Bf16 {
  using Raw = unsigned short;
  __device__ static float load(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ static Raw store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F32 {
  using Raw = float;
  __device__ static float load(Raw r) { return r; }
  __device__ static Raw store(float f) { return f; }
};

template <class D, bool kVec>
__global__ void __launch_bounds__(kThreads)
    murmur_dropout_kernel(const Params p) {
  using Raw = typename D::Raw;
  constexpr unsigned kN = 16 / sizeof(Raw);
  const unsigned chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= p.chunks) return;
  const unsigned col0 = chunk * kN;
  unsigned cterm[kN];
#pragma unroll
  for (unsigned j = 0; j < kN; ++j)
    cterm[j] = (col0 + j + p.col_off) * p.col_mult;
  const Raw* __restrict__ x = static_cast<const Raw*>(p.x);
  Raw* __restrict__ out = static_cast<Raw*>(p.out);
  union Vec {
    uint4 u;
    Raw e[kN];
  };

  for (unsigned row0 = (blockIdx.y * blockDim.y + threadIdx.y) * kRows;
       row0 < p.rows; row0 += gridDim.y * blockDim.y * kRows) {
    // both rows' loads in flight before either is hashed
    Vec v[kRows];
    unsigned h[kRows];
#pragma unroll
    for (unsigned q = 0; q < kRows; ++q) {
      const unsigned row = row0 + q;
      if (row >= p.rows) continue;
      unsigned r = row;
      h[q] = p.h0;
#pragma unroll
      for (int a = kMaxLead - 1; a >= 0; --a) {
        if (a < p.n_lead) {
          const unsigned i = r % p.lead_size[a];
          r /= p.lead_size[a];
          h[q] ^= (i + p.lead_off[a]) * p.lead_mult[a];
        }
      }
      const size_t base = static_cast<size_t>(row) * p.inner + col0;
      if (kVec) {
        v[q].u = __ldg(reinterpret_cast<const uint4*>(x + base));
      } else {
#pragma unroll
        for (unsigned j = 0; j < kN; ++j)
          v[q].e[j] = col0 + j < p.inner ? x[base + j] : Raw(0);
      }
    }
#pragma unroll
    for (unsigned q = 0; q < kRows; ++q) {
      const unsigned row = row0 + q;
      if (row >= p.rows) continue;
#pragma unroll
      for (unsigned j = 0; j < kN; ++j)
        v[q].e[j] = fmix32(h[q] ^ cterm[j]) >= p.threshold
                        ? D::store(D::load(v[q].e[j]) * p.scale)
                        : Raw(0);
      const size_t base = static_cast<size_t>(row) * p.inner + col0;
      if (kVec) {
        *reinterpret_cast<uint4*>(out + base) = v[q].u;
      } else {
#pragma unroll
        for (unsigned j = 0; j < kN; ++j)
          if (col0 + j < p.inner) out[base + j] = v[q].e[j];
      }
    }
  }
}

template <class D>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  unsigned bx = 1;
  while (bx < p.chunks && bx < kThreads) bx *= 2;
  const unsigned by = kThreads / bx;
  const unsigned gy = (p.rows + by * kRows - 1) / (by * kRows);
  const dim3 grid((p.chunks + bx - 1) / bx, gy < kMaxGridY ? gy : kMaxGridY);
  const dim3 block(bx, by);
  if (vec)
    murmur_dropout_kernel<D, true><<<grid, block, 0, stream>>>(p);
  else
    murmur_dropout_kernel<D, false><<<grid, block, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// out = murmur dropout of x, both contiguous of `shape` (ndim 1-8), x's
// element at coordinates i taking the bits of i + offsets; f32 nonzero
// for fp32, else bf16. `seed` is the seed mod 2^32, `threshold` the
// rate's (keep where bits >= it), `scale` the fp32 multiplier of a kept
// element. Returns a cudaError_t.
extern "C" int murmur_dropout(const void* x, void* out, int f32, int ndim,
                              const long long* shape,
                              const long long* offsets, unsigned seed,
                              unsigned threshold, float scale,
                              void* stream) {
  if (ndim < 1 || ndim > kMaxDims) return cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.out = out;
  p.h0 = seed * 0x9E3779B9u + 0x85EBCA6Bu;
  unsigned long long rows = 1;
  for (int a = 0; a < ndim - 1; ++a) {
    const unsigned off = static_cast<unsigned>(offsets[a]);
    if (shape[a] == 1) {
      p.h0 ^= off * kAxisMults[a];
      continue;
    }
    p.lead_size[p.n_lead] = static_cast<unsigned>(shape[a]);
    p.lead_off[p.n_lead] = off;
    p.lead_mult[p.n_lead] = kAxisMults[a];
    ++p.n_lead;
    rows *= static_cast<unsigned long long>(shape[a]);
  }
  const long long inner = shape[ndim - 1];
  if (inner <= 0 || rows >= (1ull << 31) || inner >= (1ll << 31))
    return cudaErrorInvalidValue;
  p.rows = static_cast<unsigned>(rows);
  p.inner = static_cast<unsigned>(inner);
  p.col_off = static_cast<unsigned>(offsets[ndim - 1]);
  p.col_mult = kAxisMults[ndim - 1];
  p.threshold = threshold;
  p.scale = scale;
  const unsigned width = f32 ? 4 : 8;
  p.chunks = (p.inner + width - 1) / width;
  const bool aligned = reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(out) % 16 == 0;
  const bool vec = aligned && p.inner % width == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<F32>(p, vec, s) : launch<Bf16>(p, vec, s);
}
