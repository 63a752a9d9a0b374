// Launch set-up asked once per kernel instance and device, for the extern
// "C" entries of every library built from csrc/ (each source includes this
// header and gets its own copy of the state).
//
// A kernel's dynamic shared-memory limit (cudaFuncSetAttribute) and the
// card's SM count (cudaDeviceGetAttribute) depend only on the kernel
// instance and the device, not on the launch.  An entry that asked for them
// at every launch paid host time for each ask on every launch, which for a
// kernel of a few microseconds is most of its launch.  Here the first
// launch of an instance on a device asks, and every later launch on that
// device reuses the answer.  A failed first ask is kept too: every later
// launch on that device returns the same error, so a failure is never
// passed over.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

namespace redsec {

constexpr int kMaxDevices = 64;

// The current device, or -1 if it cannot be read or lies past kMaxDevices.
inline int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : -1;
}

// One answer a device: make(dev) runs on the first get() on that device,
// under std::call_once, and every get() returns its value.
class PerDevice {
 public:
  template <class Make>
  int get(int dev, Make&& make) {
    std::call_once(once_[dev], [&] { value_[dev] = make(dev); });
    return value_[dev];
  }

 private:
  std::once_flag once_[kMaxDevices];
  int value_[kMaxDevices] = {};
};

// SMs of the current device, read once a device; 0 where it cannot be read.
inline int sm_count() {
  static PerDevice sms;
  const int dev = current_device();
  if (dev < 0) return 0;
  return sms.get(dev, [](int d) {
    int n = 0;
    return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, d) == cudaSuccess ? n : 0;
  });
}

// Whether a launch of `kernel` with `bytes` of dynamic shared memory may go
// ahead on the current device.  `state` is the kernel instance's own (a
// static beside its launch).  Once a device, the kernel is opted in to all
// the dynamic shared memory a block may have there (the card's opt-in limit
// less the kernel's static shared memory); the limit is kept and each
// launch's bytes are held against it.  Returns cudaSuccess, the first
// opt-in's error on every launch if it failed, or cudaErrorInvalidValue for
// more bytes than the limit.
template <class Kernel>
cudaError_t opt_in_smem(PerDevice& state, Kernel kernel, size_t bytes) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  const int limit = state.get(dev, [&](int d) {
    int optin = 0;
    cudaFuncAttributes fa{};
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, d);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    const int dynamic = optin - static_cast<int>(fa.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    return e == cudaSuccess ? dynamic : -static_cast<int>(e);
  });
  if (limit < 0) return static_cast<cudaError_t>(-limit);
  return bytes <= static_cast<size_t>(limit) ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace redsec
