// Sequential covariance propagation P <- F_i P F_i^T + Q_i, i = 0..K-1,
// returning only the final P: the Hopper port of the TPU kernel
// fast_livo2_tpu/ops/cov_scan.py:propagate_cov (Pallas body `_kernel`,
// cov_scan.py:45-65), which the IMU propagation calls once per frame
// (fast_livo2_tpu/core/imu.py:222-231).
//
// What it computes, not the TPU's block structure: the TPU zero-padded
// 19 -> 32 for its sublanes and ran a fori_loop with P resident in VMEM.
// Here ONE thread block keeps P, F_i and the step product T in shared
// memory (D <= 32: at most 4 KB each) and runs the K steps in order:
//   T = F_i P          (sync)
//   P = T F_i^T + Q_i  (sync)
// D is the real state dimension (19 on the main path, unpadded); each
// thread owns output elements e = tid, tid + blockDim, ... of the D x D
// matrix. Plain FP32 FFMA only: no tensor cores and no TF32, because
// reduced-precision inputs diverge the filter (the TPU's own note,
// cov_scan.py:51-55).
//
// What bounds it on an H100: at the main path's K = 64 (max_imu_per_
// packet; ~20 live intervals at 200 Hz IMU / 10 Hz scans, the rest
// padding with F = I, Q = 0) it reads (2K + 1) * 19^2 * 4 B = 187 KB
// (0.06 us at 3.35 TB/s) and does K * 4 * 19^3 = 1.8 MFLOP (0.03 us at
// 67 TFLOP/s FP32). Both bounds sit far below a microsecond; the real
// cost is the launch plus a chain of 2K dependent, barrier-separated
// 19 x 19 products on one SM. Shortening that chain (building F_i and
// Q_i in the kernel from the IMU batch, or capturing the frame in a CUDA
// graph) is later work.
//
// C interface for ctypes: cov_scan_launch(F, Q, P0, out, K, D, device,
// stream) takes contiguous float32 device pointers F, Q (K, D, D), P0
// (D, D), out (D, D) on CUDA device `device`, launches on `stream` and
// returns cudaGetLastError() (launch_on.cuh).

#include <cuda_runtime.h>

#include "launch_on.cuh"

namespace {

constexpr int kMaxD = 32;

__global__ void cov_scan_kernel(const float* __restrict__ F,
                                const float* __restrict__ Q,
                                const float* __restrict__ P0,
                                float* __restrict__ out, int K, int D) {
  __shared__ float P[kMaxD * kMaxD];
  __shared__ float Fs[kMaxD * kMaxD];
  __shared__ float T[kMaxD * kMaxD];
  const int DD = D * D;
  for (int e = threadIdx.x; e < DD; e += blockDim.x) P[e] = P0[e];
  for (int k = 0; k < K; ++k) {
    const float* Fk = F + static_cast<size_t>(k) * DD;
    const float* Qk = Q + static_cast<size_t>(k) * DD;
    for (int e = threadIdx.x; e < DD; e += blockDim.x) Fs[e] = Fk[e];
    __syncthreads();
    // T = F_k P
    for (int e = threadIdx.x; e < DD; e += blockDim.x) {
      const int i = e / D, j = e - (e / D) * D;
      float acc = 0.0f;
      for (int m = 0; m < D; ++m) acc = fmaf(Fs[i * D + m], P[m * D + j], acc);
      T[e] = acc;
    }
    __syncthreads();
    // P = T F_k^T + Q_k
    for (int e = threadIdx.x; e < DD; e += blockDim.x) {
      const int i = e / D, j = e - (e / D) * D;
      float acc = 0.0f;
      for (int m = 0; m < D; ++m) acc = fmaf(T[i * D + m], Fs[j * D + m], acc);
      P[e] = acc + Qk[e];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < DD; e += blockDim.x) out[e] = P[e];
}

}  // namespace

extern "C" int cov_scan_launch(const void* F, const void* Q, const void* P0,
                               void* out, int K, int D, int device,
                               void* stream) {
  if (D < 1 || D > kMaxD || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((D * D + 31) / 32) * 32;  // one thread per element
  return launch_on(device, [&] {
    cov_scan_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(F), static_cast<const float*>(Q),
        static_cast<const float*>(P0), static_cast<float*>(out), K, D);
  });
}
