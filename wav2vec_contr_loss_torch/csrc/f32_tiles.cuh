// fp32 tiles of the fp32 attention kernels (attention_fwd_f32.cu,
// attention_bwd_f32.cu): 64 rows x 64 fp32 in shared memory, row-major,
// and the two 64 x 64 x 64 products they are built of, on FFMA (the
// tensor cores take fp32 only as TF32, which keeps 10 mantissa bits).
//
// A block is 256 threads; thread (ty, tx) = (tid / 16, tid % 16) holds
// rows 4ty .. 4ty + 3 of a 64 x 64 result. In `abt` (a . b^T: scores) its
// columns are tx + 16j, j < 4, so a row's 64 columns lie in the 16 lanes
// of one half-warp (row reductions are 4 shuffles) and a stored score row
// is written by consecutive lanes; in `ab` (p . v: outputs) its columns
// are 4tx .. 4tx + 3, one 16-byte store to device memory.
//
// Rows are kLd = 68 floats apart: 16-byte aligned, and the 16-byte reads
// of rows tx + 16j by the 8 threads of one shared-memory phase fall on
// distinct banks (68 = 4 mod 32). Each product reads two 16-byte words
// for every 8 FMAs (the a rows are broadcast in a half-warp).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace f32 {

constexpr int kTile = 64;
constexpr int kLd = 68;
constexpr int kThreads = 256;
constexpr int kTileFloats = kTile * kLd;

struct Strides {  // element strides (batch, head, row) of a (B, H, T, 64)
  long long b, h, t;
};

// rows [r0, r0 + 64) of (b, h) of a (B, H, T, 64) fp32 tensor whose head
// dim is contiguous into tile t; rows past T as zeros. 16 threads a row,
// a 16-byte load each.
__device__ __forceinline__ void load_tile(float* t, const float* src,
                                          Strides s, int b, int h, int r0,
                                          int T) {
  const float* base = src + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < kTile * 16; i += kThreads) {
    const int r = i >> 4, c4 = i & 15;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      v = __ldg(reinterpret_cast<const float4*>(base + (r0 + r) * s.t) + c4);
    *reinterpret_cast<float4*>(t + r * kLd + 4 * c4) = v;
  }
}

// acc[i][j] += sum_d a[4ty + i][d] * b[tx + 16j][d]
__device__ __forceinline__ void abt(float (&acc)[4][4], const float* a,
                                    const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < 64; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        acc[i][j] = x;
      }
  }
}

// acc[i][e] += sum_c p[4ty + i][c] * v[c][4tx + e]
__device__ __forceinline__ void ab(float (&acc)[4][4], const float* p,
                                   const float* v, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < 64; c += 4) {
    float4 pv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (4 * ty + i) * kLd + c);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      vv[k] = *reinterpret_cast<const float4*>(v + (c + k) * kLd + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pk[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][0] = fmaf(pk[k], vv[k].x, acc[i][0]);
        acc[i][1] = fmaf(pk[k], vv[k].y, acc[i][1]);
        acc[i][2] = fmaf(pk[k], vv[k].z, acc[i][2]);
        acc[i][3] = fmaf(pk[k], vv[k].w, acc[i][3]);
      }
    }
  }
}

// rows 4ty + i (those below T) of a 64 x 64 `ab` result into rows
// r0 + 4ty + i of (b, h) of dst
__device__ __forceinline__ void store_rows(float* dst, Strides s, int b,
                                           int h, int r0, int T, int ty,
                                           int tx, const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r < T)
      *reinterpret_cast<float4*>(dst + b * s.b + h * s.h + r * s.t + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// sum and max over the 16 lanes of a half-warp (one row's columns)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace f32
