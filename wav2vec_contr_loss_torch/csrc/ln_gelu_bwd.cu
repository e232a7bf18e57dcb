// Backward of the conv extractor's fused LayerNorm (+ exact GELU), for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bwd_kernel` of
// wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py (`fused_ln_gelu` -> `_bwd`).
// Per row of C channels it recomputes the statistics from x, forms
//   dh = dy * GELU'(h),  h = xhat * scale + bias   (dh = dy without GELU)
//   dx = rstd * (dh*scale - mean(dh*scale) - xhat * mean(dh*scale*xhat))
// and sums dscale = sum_rows dh*xhat and dbias = sum_rows dh over every
// row, in the Pallas kernel's order of operations (:89-105): fp32
// statistics, biased variance, rsqrt(var + eps), and GELU' through the
// Pallas kernel's own erf (Abramowitz & Stegun 7.1.26, :41-51, max abs
// error 1.5e-7), whose exp(-x^2) at x = h/sqrt(2) is the exp(-h^2/2) of
// GELU', so one __expf serves both: some 15 instructions an element
// fewer than erff and expf, in a kernel whose instruction throughput is
// the next limit after the bytes.
//
// Bound: it reads x and dy and writes dx once, 3 x 2 bytes an element
// (at the first conv of a training batch, 511,968 rows of 512 bf16,
// 1.57 GB: 0.47 ms at 3.35 TB/s); its ~30 fp32 operations an element are
// a quarter of that time at 67 TFLOP/s. So it is bound by bytes, and the
// design keeps the loads streaming and every reduction off shared memory:
//
//   * A persistent grid (SMs x blocks an SM at this kernel's shared
//     memory), each block a fixed, contiguous range of row stages (no
//     work stealing, so the bits do not depend on scheduling).
//   * One producer warp keeps a ring of kStages stages in flight, each
//     a run of whole rows of x and of dy brought in by two bulk copies
//     (cp.async.bulk global -> shared, completion on an mbarrier):
//     three stages of 32 KB a block (24 KB at C = 768), two blocks an SM
//     at C <= 512.
//   * Eight consumer warps, one row at a time each. Lane l holds columns
//     256c + 8l ... 256c + 8l + 7 of x and dy in registers (16-byte loads
//     from shared memory, 16-byte stores of dx), so mean, variance and
//     the two means of the dx epilogue (one shuffle tree for both) are
//     warp shuffles: no shared-memory reduction and no __syncthreads in
//     the row loop.
//   * dscale and dbias: each lane adds dh*xhat and dh of its columns in
//     registers over all of its warp's rows; at the end of the block the
//     warps add theirs through shared memory in warp order, and the block
//     writes one partial row pair. A second small kernel adds the partial
//     rows in block order. No atomics: two calls give the same bits.
//
// C must be a multiple of 256 up to 1024 (the conv width is 512); x, dy
// and dx are (rows, C) contiguous and 16-byte aligned, all bf16 or all
// fp32: the row kernel is one template over the element type, with an
// entry point each (ln_gelu_bwd, ln_gelu_bwd_f32). Its arithmetic is fp32
// for both. An fp32 row is twice the bytes, so a stage holds half the
// rows (8 at C = 512, 16 KB of x and 16 KB of dy as in bf16) and the
// ring, the occupancy (two blocks an SM at C <= 512) and the registers
// stay those of the bf16 kernel; a lane's eight fp32 columns are two
// 16-byte loads. The fp32 bound at 511,968 rows: 3.15 GB, 0.94 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;                     // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;   // + one producer warp
constexpr int kStages = 3;
constexpr int kSumThreads = 1024;             // partial-sum kernel

// rows a consumer warp takes from each stage, rows a stage holds: a
// stage of fp32 rows holds half the bf16 count (at least one a warp)
template <int NCH, typename T>
struct Shape {
  static constexpr int C = 256 * NCH;
  static constexpr int kRowsBf16 = NCH == 1 ? 4 : (NCH == 2 ? 2 : 1);
  static constexpr int kRowsPerWarp =
      sizeof(T) == 2 ? kRowsBf16 : (kRowsBf16 > 1 ? kRowsBf16 / 2 : 1);
  static constexpr int kStageRows = kWarps * kRowsPerWarp;
  static constexpr size_t kStageBytes =
      (size_t)kStageRows * C * sizeof(T);  // one of x, dy
  static constexpr size_t kRingBytes = kStages * 2 * kStageBytes;
  static constexpr size_t kSmem =
      kRingBytes + 2 * C * sizeof(float) + 2 * kStages * sizeof(uint64_t);
  static_assert(kRingBytes >= (size_t)kWarps * 2 * C * sizeof(float),
                "the warps' column sums reuse the ring");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// a lane's eight consecutive columns of a row, as fp32, and back
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* d) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(hopper::pack_bf16(d[0], d[1]), hopper::pack_bf16(d[2], d[3]),
                 hopper::pack_bf16(d[4], d[5]), hopper::pack_bf16(d[6], d[7]));
}

__device__ __forceinline__ void store8(float* p, const float* d) {
  reinterpret_cast<float4*>(p)[0] = make_float4(d[0], d[1], d[2], d[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(d[4], d[5], d[6], d[7]);
}

// erf(x) by Abramowitz & Stegun 7.1.26, given e = exp(-x^2)
__device__ __forceinline__ float erf_as(float x, float e) {
  const float t = __fdividef(1.f, 1.f + 0.3275911f * fabsf(x));
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t -
        0.284496736f) * t + 0.254829592f) * t;
  return copysignf(1.f - poly * e, x);
}

// scale and bias sit in shared memory in the order the lanes read them:
// column 256c + 8l + e at ((2c + e/4) * 32 + l) * 4 + e%4, so each lane's
// 16-byte reads of its eight columns of a chunk are bank-conflict free
__device__ __forceinline__ int param_slot(int col) {
  const int c = col >> 8, l = (col >> 3) & 31, e = col & 7;
  return ((2 * c + (e >> 2)) * 32 + l) * 4 + (e & 3);
}

__device__ __forceinline__ void lane_params(const float* p, int c, int lane,
                                            float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p + ((2 * c) * 32 + lane) * 4);
  const float4 b =
      *reinterpret_cast<const float4*>(p + ((2 * c + 1) * 32 + lane) * 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// up to C = 512 a thread's row values and column sums fit the 112
// registers of two blocks an SM; wider rows take one block an SM
template <int NCH, typename T>
__global__ void __launch_bounds__(kThreads, NCH <= 2 ? 2 : 1)
ln_gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ dx,
                   float* __restrict__ part, int n, float eps, int gelu) {
  using S = Shape<NCH, T>;
  constexpr int C = S::C, V = 8 * NCH;   // columns a lane holds
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_sc = reinterpret_cast<float*>(smem + S::kRingBytes);
  float* s_b = s_sc + C;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + C);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_stages = ((long long)n + S::kStageRows - 1) / S::kStageRows;
  const long long s_begin = (long long)blockIdx.x * n_stages / gridDim.x;
  const long long s_end = (long long)(blockIdx.x + 1) * n_stages / gridDim.x;
  const int ns = (int)(s_end - s_begin);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::bar_init(&full[s], 1);
      hopper::bar_init(&empty[s], kWarps);
    }
    hopper::bar_init_fence();
  }
  for (int col = tid; col < C; col += kThreads) {
    const int p = param_slot(col);
    s_sc[p] = scale[col];
    s_b[p] = bias[col];
  }
  __syncthreads();

  auto x_slot = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * 2 * S::kStageBytes);
  };
  float acc_s[V], acc_b[V];   // the lane's column sums (consumers)
#pragma unroll
  for (int v = 0; v < V; ++v) acc_s[v] = acc_b[v] = 0.f;

  if (warp == kWarps) {
    // ---- producer: one lane keeps the ring full ----
    if (lane == 0) {
      for (int it = 0; it < ns; ++it) {
        const int slot = it % kStages;
        if (it >= kStages)
          hopper::bar_wait(&empty[slot], ((it / kStages) - 1) & 1);
        const long long r0 = (s_begin + it) * S::kStageRows;
        const long long left = (long long)n - r0;
        const int nr = left < S::kStageRows ? (int)left : S::kStageRows;
        const uint32_t bytes = (uint32_t)nr * C * sizeof(T);
        T* xs = x_slot(slot);
        hopper::bar_expect(&full[slot], 2 * bytes);
        hopper::bulk_load(xs, x + r0 * C, bytes, &full[slot]);
        hopper::bulk_load(xs + S::kStageRows * C, dy + r0 * C, bytes,
                          &full[slot]);
      }
    }
  } else {
    // ---- consumers: one row a warp at a time ----
    for (int it = 0; it < ns; ++it) {
      const int slot = it % kStages;
      hopper::bar_wait(&full[slot], (it / kStages) & 1);
      const long long r0 = (s_begin + it) * S::kStageRows;
      const T* xs = x_slot(slot);
      const T* gs = xs + S::kStageRows * C;
#pragma unroll 1
      for (int rr = 0; rr < S::kRowsPerWarp; ++rr) {
        const int loc = warp * S::kRowsPerWarp + rr;
        const long long row = r0 + loc;
        if (row >= n) break;
        float xv[V], gv[V];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int col = 256 * c + 8 * lane;
          load8(xs + (size_t)loc * C + col, xv + 8 * c);
          load8(gs + (size_t)loc * C + col, gv + 8 * c);
        }
        float t = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) t += xv[v];
        const float mean = warp_sum(t) / (float)C;
        t = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          xv[v] -= mean;
          t += xv[v] * xv[v];
        }
        const float var = warp_sum(t) / (float)C;
        const float rstd = rsqrtf(var + eps);
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float sc[8], sb[8];
          lane_params(s_sc, c, lane, sc);
          lane_params(s_b, c, lane, sb);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int v = 8 * c + e;
            xv[v] *= rstd;                                   // xhat
            float dh = gv[v];
            if (gelu) {
              const float h = xv[v] * sc[e] + sb[e];
              const float e2 = __expf(-0.5f * h * h);
              const float phi = 0.5f * (1.f + erf_as(h * 0.7071067811865476f, e2));
              dh = dh * (phi + h * 0.3989422804014327f * e2);
            }
            gv[v] = dh;
            const float dxh = dh * sc[e];
            m1 += dxh;
            m2 += dxh * xv[v];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {                   // one tree
          m1 += __shfl_xor_sync(0xffffffffu, m1, o);
          m2 += __shfl_xor_sync(0xffffffffu, m2, o);
        }
        m1 /= (float)C;
        m2 /= (float)C;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float sc[8];
          lane_params(s_sc, c, lane, sc);
          float d[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int v = 8 * c + e;
            d[e] = rstd * (gv[v] * sc[e] - m1 - xv[v] * m2);
          }
          store8(dx + row * C + 256 * c + 8 * lane, d);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc_s[v] += gv[v] * xv[v];
          acc_b[v] += gv[v];
        }
      }
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(&empty[slot]);
    }
  }
  // every stage has landed and been read: the ring is free
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);     // (kWarps, 2, C)
  if (warp < kWarps) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float* rs = red + (size_t)warp * 2 * C + 256 * c + 8 * lane;
      float* rb = rs + C;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        *reinterpret_cast<float4*>(rs + e) =
            make_float4(acc_s[8 * c + e], acc_s[8 * c + e + 1],
                        acc_s[8 * c + e + 2], acc_s[8 * c + e + 3]);
        *reinterpret_cast<float4*>(rb + e) =
            make_float4(acc_b[8 * c + e], acc_b[8 * c + e + 1],
                        acc_b[8 * c + e + 2], acc_b[8 * c + e + 3]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * C; e += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[(size_t)w * 2 * C + e];
    part[(size_t)blockIdx.x * 2 * C + e] = t;
  }
}

// dscale[c] / dbias[c] = the partial rows' column c added in block order:
// a block takes 32 of the 2C columns; its warp y adds partial rows y,
// y + 32, ... in order, and lane x of warp 0 then adds the 32 warp sums
// of column x in warp order (a fixed tree, whatever the schedule)
__global__ void __launch_bounds__(kSumThreads)
ln_gelu_sum_partials(const float* __restrict__ part, float* __restrict__ ds,
                     float* __restrict__ db, int n_parts, int C) {
  __shared__ float red[32][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + x;
  float t = 0.f;
  if (e < 2 * C)
    for (int p = y; p < n_parts; p += 32) t += part[(size_t)p * 2 * C + e];
  red[y][x] = t;
  __syncthreads();
  if (y == 0 && e < 2 * C) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 32; ++w) s += red[w][x];
    if (e < C)
      ds[e] = s;
    else
      db[e - C] = s;
  }
}

template <int NCH, typename T>
cudaError_t occupancy(int* blocks_per_sm) {
  // the shared-memory attribute is set once per process and device, with
  // the count
  static OncePerDevice once;
  static int per_sm[OncePerDevice::kMaxDevices];
  int dev = 0;
  const cudaError_t err = once([](int d) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_gelu_bwd_kernel<NCH, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Shape<NCH, T>::kSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[d], ln_gelu_bwd_kernel<NCH, T>, kThreads,
          Shape<NCH, T>::kSmem);
    if (e == cudaSuccess && per_sm[d] < 1) e = cudaErrorInvalidConfiguration;
    return e;
  }, &dev);
  *blocks_per_sm = per_sm[dev];
  return err;
}

template <int NCH, typename T>
cudaError_t grid_of(int n, int* grid) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = occupancy<NCH, T>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long stages =
      ((long long)n + Shape<NCH, T>::kStageRows - 1) /
      Shape<NCH, T>::kStageRows;
  const long long most = (long long)sms * per_sm;
  *grid = (int)(stages < most ? stages : most);
  return cudaSuccess;
}

template <int NCH, typename T>
cudaError_t launch(const void* x, const void* dy, const void* scale,
                   const void* bias, void* dx, void* part, int n, float eps,
                   int gelu, int grid, cudaStream_t stream) {
  int per_sm = 0;
  const cudaError_t err = occupancy<NCH, T>(&per_sm);
  if (err != cudaSuccess) return err;
  ln_gelu_bwd_kernel<NCH, T>
      <<<grid, kThreads, Shape<NCH, T>::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(dx), static_cast<float*>(part), n, eps, gelu);
  return cudaGetLastError();
}

template <typename T>
int grid_for(int n, int C, int* grid) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 256: return (int)grid_of<1, T>(n, grid);
    case 512: return (int)grid_of<2, T>(n, grid);
    case 768: return (int)grid_of<3, T>(n, grid);
    case 1024: return (int)grid_of<4, T>(n, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the row kernel, then the partial sums
template <typename T>
int backward(const void* x, const void* dy, const void* scale,
             const void* bias, void* dx, void* part, void* dscale,
             void* dbias, int n, int C, float eps, int gelu, int grid,
             void* stream) {
  if (n <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 256: err = launch<1, T>(x, dy, scale, bias, dx, part, n, eps, gelu, grid, s); break;
    case 512: err = launch<2, T>(x, dy, scale, bias, dx, part, n, eps, gelu, grid, s); break;
    case 768: err = launch<3, T>(x, dy, scale, bias, dx, part, n, eps, gelu, grid, s); break;
    case 1024: err = launch<4, T>(x, dy, scale, bias, dx, part, n, eps, gelu, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  ln_gelu_sum_partials<<<(2 * C + 31) / 32, kSumThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale),
      static_cast<float*>(dbias), grid, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The persistent grid for n rows of C channels: min(SMs x blocks an SM,
// row stages). The caller allocates a (grid, 2, C) fp32 partial buffer.
// One entry per element type (the fp32 stages hold fewer rows).
int ln_gelu_bwd_grid(int n, int C, int* grid) {
  return grid_for<__nv_bfloat16>(n, C, grid);
}

int ln_gelu_bwd_grid_f32(int n, int C, int* grid) {
  return grid_for<float>(n, C, grid);
}

// x, dy, dx: (n, C) bf16 (ln_gelu_bwd) or fp32 (ln_gelu_bwd_f32); scale,
// bias, dscale, dbias: (C,) fp32; part: (grid, 2, C) fp32 scratch; grid
// from the entry of the same type.
int ln_gelu_bwd(const void* x, const void* dy, const void* scale,
                const void* bias, void* dx, void* part, void* dscale,
                void* dbias, int n, int C, float eps, int gelu, int grid,
                void* stream) {
  return backward<__nv_bfloat16>(x, dy, scale, bias, dx, part, dscale, dbias,
                                 n, C, eps, gelu, grid, stream);
}

int ln_gelu_bwd_f32(const void* x, const void* dy, const void* scale,
                    const void* bias, void* dx, void* part, void* dscale,
                    void* dbias, int n, int C, float eps, int gelu, int grid,
                    void* stream) {
  return backward<float>(x, dy, scale, bias, dx, part, dscale, dbias, n, C,
                         eps, gelu, grid, stream);
}

}  // extern "C"
