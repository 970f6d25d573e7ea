// The device every kernel launch of the port's libraries runs on.
//
// Each launch entry point (every exported *_launch function) takes the
// CUDA device index of its tensors as its first argument and opens a
// DeviceScope on it before anything else touches the runtime.  The kernel,
// the stream the launcher passes (that device's current stream) and a
// per-device function attribute (the dynamic shared-memory opt-in) then
// all belong to the tensors' card, whatever device the calling thread has
// current: a fresh thread, such as a register plane's dispatch thread,
// starts on device 0.  The scope calls cudaSetDevice only when the device
// differs from the current one and sets the previous device back when it
// closes, so a launch on the current card pays one cudaGetDevice.
#pragma once

#include <cuda_runtime.h>

class DeviceScope {
 public:
  explicit DeviceScope(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~DeviceScope() {
    if (err_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  // cudaSuccess, or why the device could not be made current (nothing
  // may then be launched).
  cudaError_t status() const { return err_; }
  int device() const { return device_; }

 private:
  int device_;
  int prev_ = 0;
  cudaError_t err_;
};
