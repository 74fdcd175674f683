// Sequential covariance propagation P <- F_k P F_k^T + Q_k, k = 0..K-1,
// returning only the final P: the Hopper port of the TPU kernel
// fast_livo2_tpu/ops/cov_scan.py:propagate_cov (Pallas body `_kernel`,
// cov_scan.py:45-65), which the IMU propagation calls once per frame
// (fast_livo2_tpu/core/imu.py:222-231).
//
// What bounds it on an H100. At the main path's K = 64, D = 19 the work
// reads (2K + 1) * 19^2 * 4 B and writes 19^2 * 4 B, 187,720 B in all
// (0.056 us at 3.35 TB/s), and does K * 4 * 19^3 = 1.8 MFLOP (0.026 us
// at 67 TFLOP/s FP32): bytes-bound, far below a microsecond. No design
// comes near that bound, because the steps form one dependent chain of
// 2K small products: step k needs all of step k-1's P. Spreading a step
// over SMs would put a grid-wide synchronisation on every link, so one
// thread block runs the chain, and the design shortens each link.
//
// What holds each link back on an H100 is shared-memory load
// instructions, not FMAs: a load costs a shared-memory wavefront per
// value a warp needs (a broadcast float4 costs as much as four broadcast
// floats), so the design cuts the loads per FMA. And one SM pulls F and Q
// from L2 far below the card's rate, so the copies of a call start before
// the chain and overlap it.
//
// The design (one block of kWarps = 4 warps, one per SM sub-partition):
// - Inputs staged ahead. Every thread issues asynchronous copies
//   (cp.async) of its share of F_k and Q_k, one commit group per kGroup =
//   8 steps, into shared memory laid out as in F and Q: the first two
//   groups before the chain starts, group g + 2 when the chain reaches
//   group g, and every step of a chunk (up to 64 steps: the whole
//   main-path call) keeps its own slot, so no copy waits for a slot to
//   free. A group is a whole number of 16-byte pieces, so where F and Q
//   start on 16-byte boundaries (decided in C from the real pointers) each
//   copy moves 16 bytes, the last one of a call zero-filled past its end;
//   else 4. Nothing is copied between the steps of a group.
// - Exact no-op steps skipped inside the kernel. The IMU batch pads its
//   fixed K = 64 with intervals of dt = 0, whose F_k is I and Q_k is 0 by
//   value (some entries -0.0): 43 of the main path's 64 steps. When a
//   group has landed, each thread compares the floats it copied for the
//   group with I and 0 using == (so -0.0 counts as 0), without branches;
//   a warp OR and one block barrier combine them into one live bit a step,
//   and a step whose bit is clear costs nothing: no product and no
//   barrier. Such a step leaves a finite P unchanged as values. The one
//   case where the values differ: a non-finite P. A skipped step keeps an
//   Inf that the full step turns into NaN (0 * Inf in the off-diagonal
//   terms).
// - One block barrier a live step, operands reused from registers. Warp w
//   owns a block of 5 rows (the fourth block's last row is a sink row);
//   each lane computes a tile of 2 rows x 2 columns of it. T = F_k P: per
//   m the lane loads 2 values of F_k's column m and 2 of P's row m and
//   does 4 FMAs: one load per FMA, where a lane per output element needs
//   two. The warp writes its rows of T to a shared tile behind
//   __syncwarp() only, and P' = T F_k^T + Q_k runs on the same tile: 2
//   values of T's column m and 2 of F_k's rows. P' goes
//   into the second of two P buffers, and one __syncthreads() makes it
//   whole before the next live step reads its rows. Each lane's 4 chains
//   run unconditionally (the rows past a warp's block or past D go to the
//   sink row D, the columns past D to the padding column), so they
//   interleave.
// - The summation order is the previous kernel's (and the plain version's
//   step order): each element is one fmaf chain over m = 0..D-1 from 0, and
//   P' adds Q_k last. The output is bit for bit that of the one-thread-per-
//   element kernel this replaces.
// Plain FP32 FFMA only: no tensor cores and no TF32, because
// reduced-precision inputs diverge the filter (the TPU's own note,
// cov_scan.py:51-55).
//
// C interface for ctypes: cov_scan_launch(F, Q, P0, out, K, D, device,
// stream) takes contiguous float32 device pointers F, Q (K, D, D), P0
// (D, D), out (D, D) on CUDA device `device`, K >= 0, 1 <= D <= 32,
// launches on `stream` and returns cudaGetLastError() (launch_on.cuh).
// D = 19 (the state) runs an instantiation with D fixed at compile time,
// any other D one with D at run time (lane tiles of 2 x 4 there). A
// chunk of up to 64 steps needs up to 189,664 bytes of shared memory at
// D = 19, above the 48 KB a launch gets by default: the first launch on
// each device raises the kernels' limit to the device's opt-in maximum,
// and the chunk is as many steps (a multiple of 8) as that maximum holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_on.cuh"

namespace {

constexpr int kMaxD = 32;
constexpr int kMainD = 19;  // the state dimension of the main path
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;        // steps per commit group and per live mask
constexpr int kMaxChunk = 64;    // steps a chunk holds at most
constexpr int kMaxDevices = 64;

// The row stride in floats of the P buffers and the T tile: the smallest
// multiple of 4 >= D whose count of float4s is odd. At D = 19 it is 20:
// the extra column takes the lane tiles' writes past column 18, and a
// warp's three row groups (rows 0, 2 and 4 apart) start in banks 0, 8 and
// 16.
__host__ __device__ constexpr int row_stride(int D) {
  return (D + 3) / 4 % 2 ? (D + 3) / 4 * 4 : (D + 3) / 4 * 4 + 4;
}

// Floats of the block's shared memory besides the staged steps: two P
// buffers and the T tile at the padded stride, each with a sink row D for
// the rows a warp owns past D, and two sets of per-warp live masks.
__host__ __device__ constexpr int fixed_floats(int D) {
  return 3 * (D + 1) * row_stride(D) + 2 * kWarps;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes to shared memory, of which the first `bytes` (1..16) are read
// from `src` and the rest are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}


// Component u of v, u a compile-time constant after unrolling.
__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// kD > 0: D fixed at compile time (D_arg ignored); kD = 0: D = D_arg.
// `chunk`: steps staged at once, a multiple of kGroup, <= kMaxChunk (0
// when K = 0). `wide`: F and Q start on 16-byte boundaries, so the copies
// move 16 bytes each; else 4.
template <int kD>
__global__ void __launch_bounds__(kThreads)
    cov_scan_kernel(const float* __restrict__ F, const float* __restrict__ Q,
                    const float* __restrict__ P0, float* __restrict__ out,
                    int K, int D_arg, int chunk, bool wide) {
  constexpr int kBound = kD > 0 ? kD : kMaxD;  // bound of the unrolled loops
  // Warp w owns the block of kRowsW rows from kRowsW * w; each lane a tile
  // of 2 rows x kB columns, the lanes a grid of kRG x kCG tiles.
  constexpr int kRowsW = (kBound + kWarps - 1) / kWarps;
  constexpr int kRG = (kRowsW + 1) / 2;
  constexpr int kB = kRG * ((kBound + 1) / 2) <= 32 ? 2 : 4;
  constexpr int kCG = (kBound + kB - 1) / kB;
  static_assert(kRG * kCG <= 32, "a warp's tiles must fit its lanes");
  // A group's F (or Q) is kGroup * D * D floats, 2 * D * D float4s.
  constexpr int kQuads = (2 * kBound * kBound + kThreads - 1) / kThreads;
  const int D = kD > 0 ? kD : D_arg;
  const int LD = row_stride(D);
  const int DD = D * D;

  extern __shared__ __align__(16) float smem[];
  float* Fs = smem;                       // `chunk` steps of F_k, as in F
  float* Qs = Fs + chunk * DD;            // and of Q_k
  float* pbuf = Qs + chunk * DD;          // two P buffers
  float* T = pbuf + 2 * (D + 1) * LD;     // T = F_k P, rows by warp blocks
  int* masks = reinterpret_cast<int*>(T + (D + 1) * LD);  // [2][kWarps]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t fs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Fs));
  const uint32_t qs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Qs));

  // The float4s of a group this thread copies and checks, x = tid + n *
  // kThreads (the same in every group: a group is a whole number of
  // float4s), and for each of their 4 floats the group step it belongs to
  // (4 bits each) and whether it is on the diagonal of F_k (1 bit each).
  int quad_step[kQuads];
  int quad_diag[kQuads];
#pragma unroll
  for (int n = 0; n < kQuads; ++n) {
    quad_step[n] = 0;
    quad_diag[n] = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * min(tid + n * kThreads, 2 * DD - 1) + u;
      const int step = e / DD, rem = e - step * DD;
      quad_step[n] |= (step & 15) << (4 * u);
      quad_diag[n] |= (rem % (D + 1) == 0) << u;
    }
  }
  // This lane's tile: rows ti[a] and columns tj[b] (the lanes past the
  // grid repeat the last tile). A row past this warp's block or past D
  // goes to the sink row D; a column past the padded row, to its last
  // float. Loads read row min(i, D) instead: every address stays inside the
  // block's shared memory, and what a sink row or padding column gets is
  // never read into a real element.
  const int tile = min(lane, kRG * kCG - 1);
  int ti[2], tj[kB];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int local = 2 * (tile / kCG) + a;
    const int i = kRowsW * warp + local;
    ti[a] = local < kRowsW && i < D ? i : D;
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) tj[b] = min(kB * (tile % kCG) + b, LD - 1);
  for (int e = tid; e < DD; e += kThreads) {
    const int r = e / D;
    pbuf[r * LD + e - r * D] = P0[e];
  }
  int cur = 0;
  for (int c0 = 0; c0 < K; c0 += chunk) {
    const int n_steps = min(chunk, K - c0);
    const int n_groups = (n_steps + kGroup - 1) / kGroup;
    const int n_floats = n_steps * DD;
    const float* Fc = F + static_cast<size_t>(c0) * DD;
    const float* Qc = Q + static_cast<size_t>(c0) * DD;
    // Every step of the previous chunk is done before its slots are
    // overwritten (and P0 is whole before the first step).
    __syncthreads();
    // Copies of group g of this chunk into its slots; one commit group.
#define COV_SCAN_COPY(g)                                                 \
  do {                                                                    \
    _Pragma("unroll") for (int n = 0; n < kQuads; ++n) {                  \
      const int x = tid + n * kThreads;                                   \
      const int e = (g) * kGroup * DD + 4 * x;                            \
      if (x < 2 * DD && e < n_floats) {                                   \
        if (wide) {                                                       \
          const int bytes = min(16, (n_floats - e) * 4);                  \
          cp_async16(fs_addr + e * 4, Fc + e, bytes);                     \
          cp_async16(qs_addr + e * 4, Qc + e, bytes);                     \
        } else {                                                          \
          _Pragma("unroll") for (int u = 0; u < 4; ++u) {                 \
            if (e + u < n_floats) {                                       \
              cp_async4(fs_addr + (e + u) * 4, Fc + e + u);               \
              cp_async4(qs_addr + (e + u) * 4, Qc + e + u);               \
            }                                                             \
          }                                                               \
        }                                                                 \
      }                                                                   \
    }                                                                     \
    cp_async_commit();                                                    \
  } while (0)
    COV_SCAN_COPY(0);
    if (n_groups > 1) COV_SCAN_COPY(1);
    for (int g = 0; g < n_groups; ++g) {
      // Group g landed (this thread's copies; group g + 1 may be in
      // flight); which of its steps are live.
      if (g + 1 < n_groups) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // Without branches: a float4 past the group is clamped to its last
      // one (checked twice), a float past the call's end never counts.
      int live = 0;
#pragma unroll
      for (int n = 0; n < kQuads; ++n) {
        const int x = min(tid + n * kThreads, 2 * DD - 1);
        const int e = g * kGroup * DD + 4 * x;
        const float4 f = *reinterpret_cast<const float4*>(Fs + e);
        const float4 q = *reinterpret_cast<const float4*>(Qs + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool noop = part(f, u) == ((quad_diag[n] >> u & 1) ? 1.0f : 0.0f)
                            && part(q, u) == 0.0f;
          const int dead = e + u < n_floats && !noop;
          live |= dead << (quad_step[n] >> (4 * u) & 15);
        }
      }
      live = __reduce_or_sync(0xffffffffu, live);
      if (lane == 0) masks[(g & 1) * kWarps + warp] = live;
      __syncthreads();  // the group's copies and masks seen by every thread
#pragma unroll
      for (int w = 0; w < kWarps; ++w) live |= masks[(g & 1) * kWarps + w];
      if (g + 2 < n_groups) COV_SCAN_COPY(g + 2);

      for (int s = 0; s < kGroup; ++s) {
        if (!(live >> s & 1)) continue;
        const float* Fk = Fs + (g * kGroup + s) * DD;
        const float* Qk = Qs + (g * kGroup + s) * DD;
        const float* P = pbuf + cur * (D + 1) * LD;
        float* Pn = pbuf + (cur ^ 1) * (D + 1) * LD;
        float q[2][kB];  // Q_k on the tile, loaded early for the step's end
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            q[a][b] = Qk[min(ti[a], D) * D + min(tj[b], D)];
          }
        }
        // T = F_k P on this lane's tile: per m, two values of F_k's column
        // m and kB of P's row m, each a chain over m = 0..D-1.
        float acc[2][kB];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < kB; ++b) acc[a][b] = 0.0f;
        }
#pragma unroll
        for (int m = 0; m < kBound; ++m) {
          if (kD > 0 || m < D) {
            float f[2], p[kB];
#pragma unroll
            for (int a = 0; a < 2; ++a) f[a] = Fk[min(ti[a], D) * D + m];
#pragma unroll
            for (int b = 0; b < kB; ++b) p[b] = P[m * LD + tj[b]];
#pragma unroll
            for (int a = 0; a < 2; ++a) {
#pragma unroll
              for (int b = 0; b < kB; ++b) acc[a][b] = fmaf(f[a], p[b], acc[a][b]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < kB; ++b) T[ti[a] * LD + tj[b]] = acc[a][b];
        }
        __syncwarp();
        // P' = T F_k^T + Q_k on the same tile: per m, two values of T's
        // column m (this warp's rows) and kB of F_k's column m (rows tj).
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < kB; ++b) acc[a][b] = 0.0f;
        }
#pragma unroll
        for (int m = 0; m < kBound; ++m) {
          if (kD > 0 || m < D) {
            float t[2], f[kB];
#pragma unroll
            for (int a = 0; a < 2; ++a) t[a] = T[ti[a] * LD + m];
#pragma unroll
            for (int b = 0; b < kB; ++b) f[b] = Fk[min(tj[b], D) * D + m];
#pragma unroll
            for (int a = 0; a < 2; ++a) {
#pragma unroll
              for (int b = 0; b < kB; ++b) acc[a][b] = fmaf(t[a], f[b], acc[a][b]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            Pn[ti[a] * LD + tj[b]] = acc[a][b] + q[a][b];
          }
        }
        cur ^= 1;
        __syncthreads();  // P' whole before the next live step
      }
    }
  }
#undef COV_SCAN_COPY
  cp_async_wait<0>();
  __syncthreads();
  const float* P = pbuf + cur * (D + 1) * LD;
  for (int e = tid; e < DD; e += kThreads) {
    const int r = e / D;
    out[e] = P[r * LD + e - r * D];
  }
}

// Steps a chunk holds at this D within `smem_bytes`: a multiple of kGroup,
// at most kMaxChunk; 0 if not even one group fits.
int chunk_steps(int D, int smem_bytes) {
  const int fit = (smem_bytes / 4 - fixed_floats(D)) / (2 * D * D);
  return fit >= kMaxChunk ? kMaxChunk : fit / kGroup * kGroup;
}

// The device's opt-in shared memory a block, set as the kernels' limit on
// the first launch on each device (0: not yet).
int g_smem_optin[kMaxDevices];

int raise_smem_limit(int device) {
  int bytes = device < kMaxDevices ? g_smem_optin[device] : 0;
  if (bytes > 0) return bytes;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      cudaFuncSetAttribute(cov_scan_kernel<kMainD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess ||
      cudaFuncSetAttribute(cov_scan_kernel<0>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess) {
    return 0;
  }
  if (device < kMaxDevices) g_smem_optin[device] = bytes;
  return bytes;
}

}  // namespace

extern "C" int cov_scan_launch(const void* F, const void* Q, const void* P0,
                               void* out, int K, int D, int device,
                               void* stream) {
  if (D < 1 || D > kMaxD || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = static_cast<const float*>(F);
  const auto q = static_cast<const float*>(Q);
  const auto p0 = static_cast<const float*>(P0);
  const auto o = static_cast<float*>(out);
  int err = cudaSuccess;
  const int rc = launch_on(device, [&] {
    const int chunk = chunk_steps(D, raise_smem_limit(device));
    if (chunk <= 0) {  // the limit could not be read or raised: no launch
      err = cudaErrorInvalidConfiguration;
      return;
    }
    // A call shorter than a chunk stages its own steps only.
    const int staged = K < chunk ? (K + kGroup - 1) / kGroup * kGroup : chunk;
    const size_t bytes =
        static_cast<size_t>(staged * 2 * D * D + fixed_floats(D)) * 4;
    const bool wide = (reinterpret_cast<uintptr_t>(F) |
                       reinterpret_cast<uintptr_t>(Q)) % 16 == 0;
    if (D == kMainD) {
      cov_scan_kernel<kMainD>
          <<<1, kThreads, bytes, s>>>(f, q, p0, o, K, D, staged, wide);
    } else {
      cov_scan_kernel<0><<<1, kThreads, bytes, s>>>(f, q, p0, o, K, D, staged, wide);
    }
  });
  return err != cudaSuccess ? err : rc;
}
