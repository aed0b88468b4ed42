// The device of a launch: every entry point takes the CUDA device index of
// its tensors, and a DeviceGuard makes that device current on the calling
// thread for the launch and then restores the one that was current.  The
// library carries its own CUDA runtime, but a thread's current device is
// its current context, which PyTorch shares: the guard runs the kernel on
// any card of the process and leaves PyTorch's current device as it was.

#pragma once

#include <cuda_runtime.h>

namespace paffy {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess) err_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (err_ == cudaSuccess) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  cudaError_t err_;
};

}  // namespace paffy
