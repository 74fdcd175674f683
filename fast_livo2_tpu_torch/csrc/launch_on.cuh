// Shared by the port's C entry points: run a launch on a given CUDA
// device without a device guard in Python.
//
// The wrapper passes the device index of its tensors
// (`Tensor.get_device()`) and the raw current stream of that device.
// `launch_on` switches the calling thread's current device only when it
// differs from `device`, runs `launch`, reads cudaGetLastError() (a
// refused launch never runs, and a later synchronize would not report
// it) and restores the previous device. On one card the switch never
// happens: the cost is one cudaGetDevice.

#pragma once

#include <cuda_runtime.h>

template <class Launch>
inline int launch_on(int device, Launch&& launch) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  launch();
  e = cudaGetLastError();
  if (prev != device) {
    const cudaError_t r = cudaSetDevice(prev);
    if (e == cudaSuccess) e = r;
  }
  return static_cast<int>(e);
}
