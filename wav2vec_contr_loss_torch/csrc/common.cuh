// Helpers shared by the port's CUDA sources.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

// Set-up that runs once per process and device, such as a kernel's
// shared-memory attribute: that applies only to the context of the device
// current when it is set. init(dev) returns a cudaError_t, which every
// later call on that device returns too; *device gets the device.
namespace {
class OncePerDevice {
 public:
  template <class Init>
  cudaError_t operator()(Init&& init, int* device = nullptr) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (device) *device = dev;
    std::call_once(once_[dev], [&] { err_[dev] = init(dev); });
    return err_[dev];
  }
  static constexpr int kMaxDevices = 64;

 private:
  std::once_flag once_[kMaxDevices];
  cudaError_t err_[kMaxDevices] = {};
};
}  // namespace

// The message of a cudaError_t that an entry point returned. Every
// library (one .cu each, so one definition each) exports it, so a wrapper
// can explain a failed launch.
extern "C" const char* w2v_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
