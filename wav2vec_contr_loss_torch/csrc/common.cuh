// Helpers shared by the port's CUDA sources.
#pragma once

#include <cuda_runtime.h>

// 16-byte global -> shared copy that bypasses L1; `valid == false` fills
// the 16 bytes with zeros and reads nothing (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// The message of a cudaError_t that an entry point returned. Every
// library (one .cu each, so one definition each) exports it, so a wrapper
// can explain a failed launch.
extern "C" const char* w2v_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
