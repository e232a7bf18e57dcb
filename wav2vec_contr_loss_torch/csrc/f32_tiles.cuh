// fp32 tiles of the fp32 attention kernels (attention_fwd_f32.cu,
// attention_bwd_f32.cu) and their 3xTF32 products on the tensor cores.
//
// The tensor cores take fp32 only as TF32 (10 mantissa bits). 3xTF32, as
// CUTLASS's OpMultiplyAddFastF32: every operand x is split into hi =
// tf32(x) and lo = tf32(x - hi) (cvt.rna: to nearest, ties away from
// zero), and a . b is lo.hi + hi.lo + hi.hi, accumulated in fp32, the two
// small terms first. Only lo.lo (~2^-22 of the product) is left out, so
// the product is about as accurate as fp32, at three TF32 products:
// ~165 TFLOP/s of fp32-accurate work on an H100 against 67 on FFMA. One
// TF32 product alone (hi.hi) lands ~5e-4 away on the forward's outputs
// and ~4e-3 on dq (tests/test_torch_attention_f32_tiles.py), outside the
// 1e-4 the kernels are held to.
//
// A tile is 64 rows x 64 fp32 in shared memory, as TMA writes it with the
// 128-byte swizzle: two panels (columns 0-31 and 32-63) of 64 rows of 128
// bytes, the 16-byte chunk c of row r at chunk c ^ (r % 8). wgmma reads
// such a panel as a K-major operand; `at` finds an element for ordinary
// loads. A TMA tile lands raw and is split once into hi/lo tiles of the
// same layout (`split_tile`) or transposed (`split_tile_t`), or into a
// thread's register A operand (`a_frags`). Every product is `abt3`, d =
// A . B^T over the 64 columns of both (24 wgmma m64n64k8), because tf32
// wgmma takes its operands K-major only (no transpose bits):
//   * products over the head dim (scores, g . v^T) take the natural tiles;
//   * products over keys or queries (p . v, ds . k, p^T . g, ds^T . q)
//     take A = P, an accumulator tile in registers (`p_frags`), and B
//     transposed. P's entries (r, 8j + 2t) and (r, 8j + 2t + 1) serve as
//     k-step j's columns t and t + 4 (the register A layout), so the
//     transposed tile orders each group of 8 keys or queries 0, 2, 4, 6,
//     1, 3, 5, 7: the reduction runs in another order, with no shuffle.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace f32 {

using hopper::kTile;

constexpr int kThreads = 128;                   // one warpgroup
constexpr int kTileFloats = kTile * 64;         // two 8 KB panels
constexpr uint32_t kTileBytes = kTileFloats * 4;

struct Strides {  // element strides (batch, head, row) of a (B, H, T, 64)
  long long b, h, t;
};

// the float index of element (r, c) of a tile
__device__ __forceinline__ int at(int r, int c) {
  return ((c >> 5) << 11) + (r << 5) + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
         (c & 3);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = hopper::to_tf32(x);
  lo = hopper::to_tf32(x - __uint_as_float(hi));
}

// rows [t0, t0 + 64) of (b, h) into `dst` by TMA (rows past T as zeros);
// one thread calls it, and `bar` completes when the tile has landed
__device__ __forceinline__ void load_tile(float* dst, const CUtensorMap* map,
                                          int t0, int h, int b,
                                          uint64_t* bar) {
  hopper::bar_expect(bar, kTileBytes);
  hopper::tma_load_at(dst, map, 0, t0, h, b, bar);
  hopper::tma_load_at(dst + kTileFloats / 2, map, 32, t0, h, b, bar);
}

// hi and lo of every element of a raw tile, in the same layout; all 128
// threads, 16 bytes each a step
__device__ __forceinline__ void split_tile(const float* raw, float* hi,
                                           float* lo, int tid) {
#pragma unroll
  for (int k = 0; k < kTileFloats / 4 / kThreads; ++k) {
    const int i = tid + kThreads * k;
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// hi and lo of a raw tile R, transposed: T[c][8j + p] = R[8j + p'][c],
// p' = 2p for p < 4 and 2(p - 4) + 1 above (the key or query order of
// `p_frags`). A warp reads 32 columns of one row of R (no bank conflict)
// and writes a 16-byte chunk of 32 rows of T (four phases, the least).
__device__ __forceinline__ void split_tile_t(const float* raw, float* hi,
                                             float* lo, int tid) {
  const int warp = tid >> 5, c = 32 * (warp & 1) + (tid & 31);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = 8 * (warp >> 1) + k;      // T's columns 4q..4q+3
    const int r = 8 * (q >> 1) + (q & 1);   // R's rows r, r+2, r+4, r+6
    uint4 h, l;
    split(raw[at(r, c)], h.x, l.x);
    split(raw[at(r + 2, c)], h.y, l.y);
    split(raw[at(r + 4, c)], h.z, l.z);
    split(raw[at(r + 6, c)], h.w, l.w);
    const int i = at(c, 4 * q) >> 2;
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// this thread's register A operand (hi and lo) of every k-step of a raw
// tile whose columns are the reduction (hopper.cuh, TF32 products)
__device__ __forceinline__ void a_frags(const float* raw, uint32_t (&hi)[32],
                                        uint32_t (&lo)[32], int warp,
                                        int lane) {
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(raw[at(r + 8 * (e & 1), 8 * s + t + 4 * (e >> 1))],
            hi[4 * s + e], lo[4 * s + e]);
}

// the register A operand (hi and lo) of a wgmma accumulator tile P: its
// entries (r, 8j + 2t) and (r, 8j + 2t + 1) as k-step j's columns t and
// t + 4, so the B operand is a `split_tile_t` tile
__device__ __forceinline__ void p_frags(const float (&p)[32],
                                        uint32_t (&hi)[32],
                                        uint32_t (&lo)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split(p[4 * j], hi[4 * j], lo[4 * j]);
    split(p[4 * j + 2], hi[4 * j + 1], lo[4 * j + 1]);
    split(p[4 * j + 1], hi[4 * j + 2], lo[4 * j + 2]);
    split(p[4 * j + 3], hi[4 * j + 3], lo[4 * j + 3]);
  }
}

// descriptor of k-step s (columns 8s..8s+7) of a tile: panel s / 4, 32
// bytes a step inside it
__device__ __forceinline__ uint64_t kstep(uint64_t tile_desc, int s) {
  return tile_desc + ((uint64_t)(s >> 2) << 9) + ((s & 3) << 1);
}

// d = A . B^T over the 64 columns, 3xTF32 (24 wgmma): A and B hi/lo tiles
// in shared memory. Call between wg_fence and wg_commit.
__device__ __forceinline__ void abt3(float (&d)[32], const float* a_hi,
                                     const float* a_lo, const float* b_hi,
                                     const float* b_lo) {
  const uint64_t ah = hopper::desc<false>(a_hi), al = hopper::desc<false>(a_lo),
                 bh = hopper::desc<false>(b_hi), bl = hopper::desc<false>(b_lo);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    hopper::mma_tf32_ss(d, kstep(al, s), kstep(bh, s), s > 0);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    hopper::mma_tf32_ss(d, kstep(ah, s), kstep(bl, s), 1);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    hopper::mma_tf32_ss(d, kstep(ah, s), kstep(bh, s), 1);
}

// the same with A as registers (`a_frags`, `p_frags`); with `accumulate`,
// d += A . B^T
__device__ __forceinline__ void abt3(float (&d)[32], const uint32_t (&a_hi)[32],
                                     const uint32_t (&a_lo)[32],
                                     const float* b_hi, const float* b_lo,
                                     bool accumulate = false) {
  const uint64_t bh = hopper::desc<false>(b_hi), bl = hopper::desc<false>(b_lo);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    hopper::mma_tf32_rs(d, a_lo + 4 * s, kstep(bh, s), accumulate || s > 0);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    hopper::mma_tf32_rs(d, a_hi + 4 * s, kstep(bl, s), 1);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    hopper::mma_tf32_rs(d, a_hi + 4 * s, kstep(bh, s), 1);
}

// the key bias of this thread's 16 accumulator columns c0 + 8j + 2t + e
// (-inf past T), as bv[2j + e]; loaded while a product runs, so their
// latency hides behind it
__device__ __forceinline__ void column_bias(float (&bv)[16], const float* brow,
                                            int c0, int c_lane, int T) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + c_lane + e;
      bv[2 * j + e] = col < T ? __ldg(brow + col) : -INFINITY;
    }
}

// rows r0 + 16w + l/4 + 8i (those below T) of an accumulator tile, each
// row times scale[i], into (b, h) of dst
__device__ __forceinline__ void store_rows(float* dst, Strides s, int b,
                                           int h, int r0, int T, int warp,
                                           int lane, const float (&acc)[32],
                                           const float (&scale)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * i;
    if (r >= T) continue;
    float* row = dst + b * s.b + h * s.h + r * s.t + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * i] * scale[i],
                      acc[4 * j + 2 * i + 1] * scale[i]);
  }
}

}  // namespace f32
