// Hopper building blocks of the attention kernels: TMA tensor maps and
// loads, mbarriers, and wgmma on bf16 tiles of 64 rows x 64 columns
// (128 bytes a row, the width of the 128-byte swizzle); the fp32 kernels'
// tensor maps (64 x 32 fp32 boxes, the same 128 bytes a row), the TF32
// conversion and tf32 wgmma (f32_tiles.cuh builds 3xTF32 on them). The
// LN+GELU backward uses the mbarriers and the plain bulk copy.
//
// Every tile in shared memory is 64 rows of 64 bf16, loaded by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B and aligned to 1024 bytes, so wgmma reads it
// through a descriptor of the matching swizzle: 8-row groups 1024 bytes
// apart. As a K-major operand (the 64 columns are the reduction) a k16
// step moves the start address by 32 bytes; as an MN-major operand (the
// 64 rows are the reduction, trans-b) a k16 step moves it by 16 rows,
// 2048 bytes.
//
// Accumulator layout of wgmma m64n64 f32, thread t of the warpgroup
// (warp w = t / 32, lane l): d[4j + 2i + c] holds row 16w + l/4 + 8i,
// column 8j + 2(l%4) + c. The register A operand of m64k16 holds, for
// k-step columns 16s..16s+15, {a0, a1, a2, a3} = bf16 pairs of the
// accumulator entries 8s.. of the same rows: (d[8s], d[8s+1]),
// (d[8s+2], d[8s+3]), (d[8s+4], d[8s+5]), (d[8s+6], d[8s+7]); so a
// softmax tile turns into the A operand of the next product in place.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

constexpr int kTile = 64;                    // rows of every tile
constexpr int kTileBytes = kTile * 64 * 2;   // 64 x 64 bf16

// ---- host: a 4-D tensor map over (B, H, T, 64) bf16 or fp32 with explicit
// element strides, one box = 64 rows of one (b, h) pair ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once in libcuda at run time, so the
// library links against the CUDA runtime alone.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Make the current device's context current on this thread: libcuda's
// encoder below needs it, and autograd's backward thread may not have it yet.
inline cudaError_t bind_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// strides in elements (sb, sh, st; the head dim is contiguous). Rows past
// T read as zeros. One box is 64 rows of 128 bytes (the width of the
// 128-byte swizzle): all 64 bf16 columns, or 32 of the 64 fp32 ones, so a
// 64 x 64 fp32 tile is two boxes, at columns 0 and 32. A map libcuda
// refuses (strides, alignment) returns cudaErrorInvalidPitchValue. Call
// bind_device() first.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int H,
                            int T, long long sb, long long sh, long long st,
                            bool f32 = false) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t size = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {64, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * size, (cuuint64_t)sh * size,
                                 (cuuint64_t)sb * size};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / size), kTile, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map,
                        f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidPitchValue;
}

// ---- device ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the box of (b, h) at column c0 and row t0 into `dst` (1024-aligned)
__device__ __forceinline__ void tma_load_at(void* dst, const CUtensorMap* map,
                                            int c0, int t0, int h, int b,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(t0), "r"(h), "r"(b)
      : "memory");
}

// one 64-row box of (b, h) starting at row t0 into `dst` (1024-aligned)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int t0, int h, int b,
                                         uint64_t* bar) {
  tma_load_at(dst, map, 0, t0, h, b, bar);
}

// order this thread's ordinary shared-memory accesses before later ones
// of the async proxy (wgmma operands read through descriptors, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from 16-aligned `src`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma descriptor of a 64 x 64 bf16 tile with the 128-byte swizzle.
// K-major: the leading offset is unused (16 bytes by convention).
// MN-major: the leading offset would step between 64-column atoms, of
// which a 64-wide tile has one, so both offsets are the 1024-byte 8-row
// stride.
template <bool kMnMajor>
__device__ __forceinline__ uint64_t desc(const void* tile) {
  const uint64_t lbo = kMnMajor ? 1024 : 16;
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define W2V_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define W2V_D32_OPS(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A . B, one k16 step: A and B from shared memory, both K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " W2V_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : W2V_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B, one k16 step: A = four bf16x2 registers, B from shared
// memory, MN-major
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " W2V_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : W2V_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- TF32 products (the fp32 kernels' 3xTF32 tiles, f32_tiles.cuh) ----
//
// wgmma takes tf32 operands K-major only (no transpose bits), k8 a step:
// 8 fp32 = 32 bytes, so a k-step moves a 128-byte-swizzle descriptor by
// 32 bytes, as a bf16 k16 step does. The register A operand of m64k8
// holds, for k-step columns 8s..8s+7, {a0, a1, a2, a3} = rows (r, r + 8,
// r, r + 8) and columns (8s + t, 8s + t, 8s + t + 4, 8s + t + 4), r = 16w
// + l/4, t = l%4 (CUTLASS's ALayout_64x8).

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero; the fp32 bit pattern with the low 13 bits 0
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d (+)= A . B, one k8 step: A and B from shared memory, both K-major
__device__ __forceinline__ void mma_tf32_ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " W2V_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : W2V_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B, one k8 step: A = four tf32 registers, B K-major in
// shared memory
__device__ __forceinline__ void mma_tf32_rs(float (&d)[32], const uint32_t* a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " W2V_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : W2V_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#undef W2V_D32
#undef W2V_D32_OPS

// d = A . B^T over the 64 columns of both tiles (four k16 steps): A and
// B are 64 x 64 K-major tiles in shared memory
__device__ __forceinline__ void tile_abt(float (&d)[32], const void* a,
                                         const void* b) {
  const uint64_t da = desc<false>(a), db = desc<false>(b);
#pragma unroll
  for (int s = 0; s < 4; ++s) mma_ss(d, da + 2 * s, db + 2 * s, s > 0);
}

// d += P . B over the 64 rows of B (four k16 steps): P is the bf16
// register form of a 64 x 64 accumulator, B a 64 x 64 tile in shared
// memory whose rows are the reduction
__device__ __forceinline__ void tile_pb(float (&d)[32], const uint32_t (&p)[16],
                                        const void* b) {
  const uint64_t db = desc<true>(b);
#pragma unroll
  for (int s = 0; s < 4; ++s) mma_rs(d, p + 4 * s, db + 128 * s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an fp32 accumulator tile as the bf16 register A operand
__device__ __forceinline__ void to_operand(uint32_t (&p)[16],
                                           const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// an fp32 accumulator tile as two bf16 register A operands, hi = bf16(d)
// and lo = bf16(d - hi): hi . B + lo . B carries d to ~16 bits
__device__ __forceinline__ void to_operand_split(uint32_t (&hi)[16],
                                                 uint32_t (&lo)[16],
                                                 const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hi[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
    const float2 h = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hi[i]));
    lo[i] = pack_bf16(d[2 * i] - h.x, d[2 * i + 1] - h.y);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx: relative error ~2^-22, far below the bf16
// rounding that follows); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace hopper
