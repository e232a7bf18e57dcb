// Helpers shared by the port's CUDA sources.
#pragma once

#include <cuda_runtime.h>

// The message of a cudaError_t that an entry point returned. Every
// library (one .cu each, so one definition each) exports it, so a wrapper
// can explain a failed launch.
extern "C" const char* w2v_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
