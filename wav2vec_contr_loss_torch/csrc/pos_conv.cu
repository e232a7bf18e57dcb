// The encoder's positional conv on Hopper (sm_90a): a grouped conv1d at
// stride 1 (XLS-R 2B: 16 groups of 120 channels, kernel 128, padding 64;
// XLS-R 1B: groups of 80), its input gradient and its weight gradient, in
// bf16 with fp32 accumulation.
//
// Replaces no Pallas kernel: the JAX package leaves this conv to XLA
// (wav2vec_contr_loss_tpu/models/wav2vec2.py, `feature_group_count`). On
// the card cuDNN ran it on the tensor cores only with each group padded to
// 128 channels, and its weight gradient on a SIMT kernel (34 ms of a 400 ms
// step at 2B); these kernels take the groups at their own width.
//
// Bound on an H100 at the training shape (B 32, T 249, D 1920, C 120,
// K 128): one conv is 2 B T D C K = 470 GFLOP (0.475 ms at the bf16 peak)
// and moves ~120 MB (36 us), so each of the three products is bound by the
// tensor cores and what matters is keeping them fed from shared memory.
//
// Layouts. Every operand sits in shared memory in wgmma's non-swizzled
// ("interleave") layout, as columns of 8 channels (16 bytes) over rows of
// frames: [chunk][row][8]. A core matrix is 8 consecutive rows of one
// chunk, so an operand may start at ANY row: the tap k of the implicit
// GEMM is a shift of the start address by k rows (16 bytes a row), with no
// copy and no swizzle phase to match. Channels past the group width up to
// the k16 depth (120 -> 128) are a chunk of zeros written once.
//
//   * conv_kernel (forward, and the input gradient): a block owns (256
//     output frames, group g, batch b). Its window of the input, 256 + K - 1
//     frames from frame t0 - pad (TMA's out-of-bounds zeros are the
//     padding), is loaded once; a producer warp streams the weight tap by tap
//     through a ring (one bulk copy of C x C bf16 a tap, stored tap-major by
//     the wrapper as (G, K, C/8, C, 8)); two consumer warpgroups each own
//     128 output frames (two m64nC accumulators) and for tap k multiply the
//     window rows shifted by k with the tap's C x C block. The input
//     gradient is the same conv of the output gradient against each group's
//     weight transposed and flipped in time, padded K - 1 - pad: the kernel
//     reads tap K - 1 - k of the same tap-major weight as an MN-major
//     operand (the transpose is a descriptor bit), so nothing is
//     materialized.
//   * wgrad_kernel: dW[o, i, k] = sum over (b, t) of gy[b, t, o] x[b, t + k -
//     pad, i], a reduction over all B T' frames for each (group, tap). A block
//     owns (4 taps, 64 output channels, group g) and keeps the 4 taps'
//     64 x C accumulators in registers (two taps a consumer warpgroup); the
//     producer streams 128 input frames a stage of x (C channels) and the
//     131 frames of gy (64 channels) that the 4 taps pair with them, each
//     tap's gy operand the same rows shifted by the tap. It reads both from
//     chunk-major copies (B, D/8, T, 8) that the wrapper makes, so that a
//     TMA box is 32 frames of a chunk, 512 contiguous bytes (boxes 16
//     bytes wide, a request a frame, held it to 29 % of its bound at 2B
//     on the H100, where these reach 46 %, the copies included). Each
//     weight is written once, by one block, in a fixed order of products:
//     no atomics, the same bits on every run. dW is fp32, the gradient of
//     the fp32 parameter.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 32; // and a producer warp

template <int C>
struct Width {
  static_assert(C == 80 || C == 120, "group width 80 or 120");
  static constexpr int kSteps = (C + 15) / 16;  // k16 steps over C
  static constexpr int kChunks = 2 * kSteps;    // 8-channel chunks, zeros last
  static constexpr int kReal = C / 8;           // chunks read from memory
  static constexpr int kAcc = C / 2;            // floats of an m64nC tile
};

// ---- wgmma on non-swizzled operands ----

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// The descriptor's byte offsets in the non-swizzled layout (PTX ISA,
// "Matrix Descriptor"; CUTLASS's canonical GMMA layouts), core matrices
// of 8 rows x 16 bytes: K-major, LBO steps along K (between chunks) and
// SBO along M or N (8 rows); MN-major, SBO steps along M or N (between
// chunks) and LBO along K (8 rows).
// An operand whose channels (the reduction) are contiguous: rows at 16
// bytes, chunk columns `chunk` bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, uint32_t chunk) {
  return desc(addr, chunk, 128);
}
// An operand whose channels are the M or N side and whose rows (frames or
// output channels) are the reduction.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t chunk) {
  return desc(addr, 128, chunk);
}

#define PC_D40 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"\
  " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"\
  " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"\
  " %36, %37, %38, %39}"
#define PC_D40_OPS(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define PC_D60 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"\
  " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"\
  " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"\
  " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"\
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}"
#define PC_D60_OPS(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])

// d += A . B, one k16 step of m64nNk16 (N = 2 x the accumulator's floats),
// both operands in shared memory; kTA / kTB: 0 K-major, 1 MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void mma(float (&d)[40], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " PC_D40
      ", %40, %41, p, 1, 1, %43, %44;\n}\n"
      : PC_D40_OPS(d)
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}
template <int kTA, int kTB>
__device__ __forceinline__ void mma(float (&d)[60], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 " PC_D60
      ", %60, %61, p, 1, 1, %63, %64;\n}\n"
      : PC_D60_OPS(d)
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

#undef PC_D40
#undef PC_D40_OPS
#undef PC_D60
#undef PC_D60_OPS

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the two consumer warpgroups alone (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// zero `bytes` (a multiple of 16) of shared memory from `p`, by the block
// (a fence_proxy_async() after it shows the zeros to wgmma's reads)
__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

// ---- forward (and input gradient) ----

constexpr int kRows = 256;      // output frames of a block
constexpr int kHalf = 192;      // frames of one window box
constexpr int kWinRows = 2 * kHalf;
constexpr int kMaxTaps = kWinRows - kRows + 1;  // 129
constexpr int kConvStages = 4;

template <int C>
struct __align__(1024) ConvSmem {
  __nv_bfloat16 win[Width<C>::kChunks * kWinRows * 8];  // [chunk][row][8]
  __nv_bfloat16 ring[kConvStages][Width<C>::kChunks * C * 8];
  uint64_t full[kConvStages], empty[kConvStages], win_full;
};
template <int C>
constexpr size_t kConvSmem = sizeof(ConvSmem<C>) + 1024;

// y[b, t, gC + o] = bias[gC + o] + sum over k, i of x[b, t + k - pad, gC + i]
// W[k][o][i], W tap-major (G, K, C/8, C, 8). kDx: the input gradient, W
// read at tap K - 1 - k as [i][o] (MN-major), no bias.
template <int C, bool kDx>
__global__ void __launch_bounds__(kThreads, 1)
conv_kernel(const __grid_constant__ CUtensorMap xmap,
            const __nv_bfloat16* __restrict__ wt,
            const __nv_bfloat16* __restrict__ bias,
            __nv_bfloat16* __restrict__ y, int T_out, int D, int K, int pad) {
  using W = Width<C>;
  extern __shared__ unsigned char smem_raw[];
  ConvSmem<C>& sm = *reinterpret_cast<ConvSmem<C>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tile = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr uint32_t kTapBytes = C * C * 2;
  constexpr uint32_t kChunkRows = kWinRows * 16;  // bytes of a window chunk

  if (W::kChunks > W::kReal) {  // the zero chunk past the group's channels
    zero_smem(sm.win + W::kReal * kWinRows * 8, kChunkRows);
    for (int s = 0; s < kConvStages; ++s)
      zero_smem(sm.ring[s] + W::kReal * C * 8, C * 16);
    fence_proxy_async();
  }
  if (tid == 0) {
    for (int s = 0; s < kConvStages; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], kConsumers);
    }
    bar_init(&sm.win_full, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ---- producer ----
    if (lane == 0) {
      prefetch_map(&xmap);
      bar_expect(&sm.win_full, W::kReal * kWinRows * 16);
      const int r0 = tile * kRows - pad;
      for (int c = 0; c < W::kReal; ++c)
        for (int h = 0; h < 2; ++h)
          tma_load_3d(sm.win + (c * kWinRows + h * kHalf) * 8, &xmap,
                      g * C + 8 * c, r0 + h * kHalf, b, &sm.win_full);
      for (int k = 0; k < K; ++k) {
        const int s = k % kConvStages;
        bar_wait(&sm.empty[s], ((k / kConvStages) & 1) ^ 1);
        bar_expect(&sm.full[s], kTapBytes);
        const int tap = kDx ? K - 1 - k : k;
        bulk_load(sm.ring[s], wt + ((size_t)g * K + tap) * C * C, kTapBytes,
                  &sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns output rows 128 w .. 128 w + 127 ----
  const int w = warp >> 2;
  float acc[2][W::kAcc];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < W::kAcc; ++i) acc[m][i] = 0.f;
  const uint32_t win = smem_addr(sm.win);
  bar_wait(&sm.win_full, 0);
  for (int k = 0; k < K; ++k) {
    const int s = k % kConvStages;
    bar_wait(&sm.full[s], (k / kConvStages) & 1);
    const uint32_t st = smem_addr(sm.ring[s]);
    wg_fence();
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t a0 = win + (uint32_t)((2 * w + m) * 64 + k) * 16;
#pragma unroll
      for (int q = 0; q < W::kSteps; ++q) {
        const uint64_t da = desc_k(a0 + 2 * q * kChunkRows, kChunkRows);
        if (kDx)   // rows of the tap block are the reduction (o), chunks n (i)
          mma<0, 1>(acc[m], da, desc_mn(st + q * 256, C * 16));
        else       // rows are n (o), chunks the reduction (i)
          mma<0, 0>(acc[m], da, desc_k(st + 2 * q * C * 16, C * 16));
      }
    }
    wg_commit();
    wg_wait<1>();  // tap k - 1's products are done: its slot is free
    if (k > 0) bar_arrive(&sm.empty[(k - 1) % kConvStages]);
  }
  wg_wait<0>();
#pragma unroll
  for (int m = 0; m < 2; ++m) fence_regs(acc[m]);

  // rows 16 (warp % 4) + lane / 4 + 8 i of each 64-row tile, columns
  // 8 j + 2 (lane % 4) + {0, 1}
  const int c_lane = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = tile * kRows + (2 * w + m) * 64 + 16 * (warp & 3) +
                    (lane >> 2) + 8 * i;
      if (t >= T_out) continue;
      __nv_bfloat16* out = y + ((size_t)b * T_out + t) * D + g * C;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int col = 8 * j + c_lane;
        float v0 = acc[m][4 * j + 2 * i], v1 = acc[m][4 * j + 2 * i + 1];
        if (!kDx && bias != nullptr) {
          v0 += __bfloat162float(bias[g * C + col]);
          v1 += __bfloat162float(bias[g * C + col + 1]);
        }
        *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(v0, v1);
      }
    }
}

// ---- weight gradient ----

constexpr int kFrames = 128;            // x frames of a stage
constexpr int kTaps = 4;                // taps of a block, two a warpgroup
constexpr int kBoxRows = 32;            // rows of a 256-element TMA box
constexpr int kGyRows = 160;            // gy rows a stage: kFrames + 3, to 32
constexpr int kGradStages = 4;
constexpr int kGyBytes = 8 * kGyRows * 16;  // 64 output channels

template <int C>
constexpr int kXBytes = kFrames * Width<C>::kReal * 16;
template <int C>
constexpr int kStageBytes = kGyBytes + kXBytes<C>;

template <int C>
struct __align__(1024) GradSmem {
  // a stage: gy [8][kGyRows][8], then x [kFrames / 32][kReal][32][8]
  unsigned char ring[kGradStages][kStageBytes<C>];
  uint64_t full[kGradStages], empty[kGradStages];
};
template <int C>
constexpr size_t kGradSmem = sizeof(GradSmem<C>) + 1024;
static_assert(64 * 120 * kTaps * 4 <= kGradStages * kStageBytes<120>,
              "the epilogue's staging fits in the ring");

// dW[gC + o, i, k] = sum over b, s < T_in of gy[b, s - k + pad, gC + o]
// x[b, s, gC + i] (the conv's sum, indexed by the input frame), gy and x
// chunk-major (B, D/8, T, 8) read as (8 T, D/8, B): a box of 256
// elements is 32 frames of one or more chunks, whole rows of 512 bytes.
// A stage is 128 frames of x in four boxes of all C channels, [32-frame
// block][chunk][32][8], and 131 of gy (the block's 4 taps shift it by up
// to 3) in 5 boxes for each of its 8 chunks, [chunk][160][8]; tap j
// reads gy from row 3 - j. The block's taps are k0 .. k0 + 3, its output
// channels 64 ot .. 64 ot + 63.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap gmap,
             const __grid_constant__ CUtensorMap xmap,
             float* __restrict__ dw, int B, int T_in, int K, int pad) {
  using W = Width<C>;
  extern __shared__ unsigned char smem_raw[];
  GradSmem<C>& sm = *reinterpret_cast<GradSmem<C>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int k0 = blockIdx.x * kTaps, ot = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_st = (T_in + kFrames - 1) / kFrames;
  const int n = B * n_st;

  if (tid == 0) {
    for (int s = 0; s < kGradStages; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ---- producer ----
    if (lane == 0) {
      prefetch_map(&gmap);
      prefetch_map(&xmap);
      for (int it = 0; it < n; ++it) {
        const int s = it % kGradStages;
        const int bb = it / n_st, s0 = (it % n_st) * kFrames;
        unsigned char* gy = sm.ring[s];
        unsigned char* xs = gy + kGyBytes;
        bar_wait(&sm.empty[s], ((it / kGradStages) & 1) ^ 1);
        bar_expect(&sm.full[s], kStageBytes<C>);
        for (int q = 0; q < kFrames / kBoxRows; ++q)
          tma_load_3d(xs + q * W::kReal * kBoxRows * 16, &xmap,
                      8 * (s0 + q * kBoxRows), g * W::kReal, bb, &sm.full[s]);
        // chunks past the group's read its neighbour's (or out-of-bounds
        // zeros): they feed output rows past C, which are never stored
        const int r0 = s0 - k0 - (kTaps - 1) + pad;
        for (int c = 0; c < 8; ++c)
          for (int q = 0; q < kGyRows / kBoxRows; ++q)
            tma_load_3d(gy + (c * kGyRows + q * kBoxRows) * 16, &gmap,
                        8 * (r0 + q * kBoxRows), g * W::kReal + 8 * ot + c,
                        bb, &sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns taps k0 + 2 w and k0 + 2 w + 1 ----
  const int w = warp >> 2;
  float acc[2][W::kAcc];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < W::kAcc; ++i) acc[j][i] = 0.f;
  for (int it = 0; it < n; ++it) {
    const int s = it % kGradStages;
    bar_wait(&sm.full[s], (it / kGradStages) & 1);
    const uint32_t gy = smem_addr(sm.ring[s]), xs = gy + kGyBytes;
    wg_fence();
#pragma unroll
    for (int q = 0; q < kFrames / 16; ++q) {
      const uint64_t db = desc_mn(
          xs + (q / 2) * W::kReal * kBoxRows * 16 + (q % 2) * 256,
          kBoxRows * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma<1, 1>(acc[j],
                  desc_mn(gy + (kTaps - 1 - 2 * w - j + 16 * q) * 16,
                          kGyRows * 16),
                  db);
    }
    wg_commit();
    wg_wait<1>();
    if (it > 0) bar_arrive(&sm.empty[(it - 1) % kGradStages]);
  }
  wg_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) fence_regs(acc[j]);

  // every stage has been consumed and its products are done: the ring
  // holds the block's dW as [o][i][tap] fp32, written out tap-contiguous
  consumers_sync();
  float* stage = reinterpret_cast<float*>(sm.ring);
  const int c_lane = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = 16 * (warp & 3) + (lane >> 2) + 8 * i;
#pragma unroll
      for (int jj = 0; jj < C / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          stage[(o * C + 8 * jj + c_lane + e) * kTaps + 2 * w + j] =
              acc[j][4 * jj + 2 * i + e];
    }
  consumers_sync();
  for (int idx = tid; idx < 64 * C * kTaps; idx += kConsumers) {
    const int o = 64 * ot + idx / (C * kTaps);
    const int i = (idx / kTaps) % C, k = k0 + idx % kTaps;
    if (o < C && k < K)
      dw[((size_t)(g * C + o) * C + i) * K + k] = stage[idx];
  }
}

// ---- host ----

// a tensor map over bf16 with dims `dims` (the first contiguous) and byte
// strides of the others; box `box`, no swizzle, out-of-bounds zeros
template <int R>
cudaError_t encode_map(CUtensorMap* map, const void* base,
                     const cuuint64_t (&dims)[R],
                     const cuuint64_t (&strides)[R - 1],
                     const cuuint32_t (&box)[R]) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorSharedObjectSymbolNotFound;
  cuuint32_t elem[R];
  for (int i = 0; i < R; ++i) elem[i] = 1;
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidPitchValue;
}

template <int C, bool kDx>
cudaError_t launch_conv(const void* x, const __nv_bfloat16* wt,
                        const __nv_bfloat16* bias, __nv_bfloat16* y, int B,
                        int T_in, int T_out, int D, int K, int pad,
                        cudaStream_t stream) {
  CUtensorMap xm;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T_in, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)T_in * D * 2};
  const cuuint32_t box[3] = {8, kHalf, 1};
  cudaError_t err = encode_map<3>(&xm, x, dims, strides, box);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_kernel<C, kDx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kConvSmem<C>);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_out + kRows - 1) / kRows, D / C, B);
  conv_kernel<C, kDx><<<grid, kThreads, kConvSmem<C>, stream>>>(
      xm, wt, bias, y, T_out, D, K, pad);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_wgrad(const void* gy, const void* x, float* dw, int B,
                         int T_in, int T_out, int D, int K, int pad,
                         cudaStream_t stream) {
  // chunk-major (B, D/8, T, 8) as (8 T, D/8, B)
  CUtensorMap gm, xm;
  const cuuint64_t gdims[3] = {(cuuint64_t)T_out * 8, (cuuint64_t)D / 8,
                               (cuuint64_t)B};
  const cuuint64_t gstr[2] = {(cuuint64_t)T_out * 16,
                              (cuuint64_t)T_out * D * 2};
  const cuuint32_t gbox[3] = {8 * kBoxRows, 1, 1};
  const cuuint64_t xdims[3] = {(cuuint64_t)T_in * 8, (cuuint64_t)D / 8,
                               (cuuint64_t)B};
  const cuuint64_t xstr[2] = {(cuuint64_t)T_in * 16,
                              (cuuint64_t)T_in * D * 2};
  const cuuint32_t xbox[3] = {8 * kBoxRows, Width<C>::kReal, 1};
  cudaError_t err = encode_map<3>(&gm, gy, gdims, gstr, gbox);
  if (err == cudaSuccess) err = encode_map<3>(&xm, x, xdims, xstr, xbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wgrad_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGradSmem<C>);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + kTaps - 1) / kTaps, (C + 63) / 64, D / C);
  wgrad_kernel<C><<<grid, kThreads, kGradSmem<C>, stream>>>(
      gm, xm, dw, B, T_in, K, pad);
  return cudaGetLastError();
}

bool shapes_ok(int B, int T_in, int T_out, int D, int C, int K, int pad) {
  return B > 0 && T_in > 0 && T_out > 0 && K > 0 && K <= kMaxTaps &&
         pad >= 0 && C > 0 && D % C == 0 && D / C <= 65535 && B <= 65535 &&
         T_out == T_in + 2 * pad - K + 1;
}

}  // namespace

extern "C" {

// The conv y = x * W (+ bias), or with `dx` the input gradient dx = gy * W
// (each group's weight transposed and flipped in time, no bias), over
// (B, T_in, D) bf16 `x` contiguous into (B, T_out, D) bf16 `y`, T_out =
// T_in + 2 pad - K + 1 (with `dx`, pad is K - 1 - the forward's padding).
// `wt`: the bf16 weight tap-major (G, K, C/8, C, 8), [g, k, i / 8, o, i % 8]
// = W[g C + o, i, k]; `bias`: bf16 (D,) or null; C = D / G: 80 or 120;
// K <= 129. 16-byte aligned pointers.
int pos_conv_fwd(const void* x, const void* wt, const void* bias, void* y,
                 int B, int T_in, int T_out, int D, int C, int K, int pad,
                 int dx, void* stream) {
  if (!shapes_ok(B, T_in, T_out, D, C, K, pad) || (dx && bias))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = bind_device();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wt);
  const auto* bv = static_cast<const __nv_bfloat16*>(bias);
  auto* out = static_cast<__nv_bfloat16*>(y);
#define PC_CONV(CC)                                                          \
  (dx ? launch_conv<CC, true>(x, w, bv, out, B, T_in, T_out, D, K, pad, s)   \
      : launch_conv<CC, false>(x, w, bv, out, B, T_in, T_out, D, K, pad, s))
  switch (C) {
    case 80: return (int)PC_CONV(80);
    case 120: return (int)PC_CONV(120);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PC_CONV
}

// The weight gradient, fp32 (D, C, K) `dw` (every element written):
// dw[g C + o, i, k] = sum over b and t < T_out of gy[b, t, g C + o]
// x[b, t + k - pad, g C + i], from chunk-major bf16 copies of the output
// gradient, (B, D/8, T_out, 8), and of the input, (B, D/8, T_in, 8).
int pos_conv_wgrad(const void* gy, const void* x, void* dw, int B, int T_in,
                   int T_out, int D, int C, int K, int pad, void* stream) {
  if (!shapes_ok(B, T_in, T_out, D, C, K, pad))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = bind_device();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(dw);
  switch (C) {
    case 80: return (int)launch_wgrad<80>(gy, x, out, B, T_in, T_out, D, K,
                                          pad, s);
    case 120: return (int)launch_wgrad<120>(gy, x, out, B, T_in, T_out, D, K,
                                            pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
