// Host code shared by the kernels' C entry points: the wrappers
// (ops/kernels.py) pass the tensors' device index and PyTorch's current
// raw stream on it, and the entry point makes that device current for
// the launch, instead of the wrapper entering a device context.
#pragma once

#include <cuda_runtime.h>

namespace ydorb {

// Makes ``device`` current for the guard's life, as the wrapper's
// tensors and stream are on it.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    cudaGetDevice(&prev_);
    if (prev_ != device_) cudaSetDevice(device_);
  }
  ~DeviceGuard() {
    if (prev_ != device_) cudaSetDevice(prev_);
  }

 private:
  int device_, prev_ = 0;
};

}  // namespace ydorb
