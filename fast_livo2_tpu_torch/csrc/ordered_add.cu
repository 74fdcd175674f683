// Ordered segment add: base[r, :] += src[i, :] for every lane i with
// dst[i] == r, each row summed in ascending lane order, so that the card
// gives the bits the CPU's sequential `index_add_` gives:
//   base[r] <- (((base[r] + src[i1]) + src[i2]) + ...), i1 < i2 < ...
//
// It replaces no TPU kernel. The JAX package's float scatter-adds
// (`.at[].add` in fast_livo2_tpu/core/lio.py, core/voxel_map.py and
// io/tsdf.py) are XLA scatters, which sum in update order on the CPU and
// deterministically on the TPU. PyTorch's CUDA `index_add_` sums with
// float atomics in no fixed order, so two runs of the same frames on the
// card parted by centimetres; its deterministic mode sorts and sums
// through a slower generic path. This kernel is the port's one float
// scatter-add on the card: the downsample's centroid sums, the map's
// running moments and the TSDF's weighted SDF sums.
//
// Design. The wrapper (ops/ordered_add.py) takes a stable sort of dst
// (torch.sort(stable=True): deterministic and capturable), giving the
// sorted keys and the permutation; a caller whose dst is already
// non-decreasing skips it and passes no permutation. Then one thread per
// (sorted position j, column c): the thread whose j starts a run of
// equal keys reads base[row, c] once, adds src[perm[k], c] for k along
// the run in order, and writes once. No atomics, no host reads, no
// allocation: the launch can be captured in a CUDA graph. The other
// threads of a run exit after two key loads. The row named `drop` (the
// callers' sink, which collects every invalid lane and which no caller
// reads) is skipped, so no thread walks the sink's long run; that row is
// left as it was.
//
// What bounds it on an H100: bytes. Each input read once: src (n W
// floats), the sorted keys and the permutation (n int64 each), and the
// rows touched read and written once (2 T W floats, T distinct rows):
// n (4 W + 16) + 8 T W bytes. At the map insert (3 x 8,192 lanes of 16
// floats) that is about 2 MB, under a microsecond at 3.35 TB/s, below
// the launch itself. The walk is serial within a run, so a run of length
// m costs m dependent adds; the loads of a run are independent of the
// sum and are issued ahead of it (the loop over the known run length is
// unrolled). At the port's shapes runs hold tens of lanes. Gathering src
// into sorted order first, so that the walk reads contiguous memory, is
// the next step if the kernel shows in a frame.
//
// Keys are not range-checked (a check on the host would be a device
// sync): a key outside [0, R) other than `drop` writes outside base.
//
// C interface for ctypes: ordered_add_launch(base, keys, perm, src, n, W,
// drop, device, stream) takes a contiguous float32 base (R, W), int64
// keys (n,) non-decreasing, int64 perm (n,) or null (the identity),
// float32 src (n, W), `drop` (-1: none), as pointers on CUDA device
// `device`; launches on `stream` and returns cudaGetLastError()
// (launch_on.cuh). n = 0 launches nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_on.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kPerm>
__global__ void ordered_add_kernel(float* __restrict__ base,
                                   const long long* __restrict__ keys,
                                   const long long* __restrict__ perm,
                                   const float* __restrict__ src,
                                   long long n, int W, long long drop) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n * W) return;
  const long long j = t / W;
  const int c = static_cast<int>(t - j * W);
  const long long row = __ldg(keys + j);
  if (row == drop || (j > 0 && __ldg(keys + j - 1) == row)) return;
  long long end = j + 1;
  while (end < n && __ldg(keys + end) == row) ++end;
  float* out = base + row * W + c;
  float acc = *out;
#pragma unroll 8
  for (long long k = j; k < end; ++k) {
    const long long i = kPerm ? __ldg(perm + k) : k;
    acc += __ldg(src + i * W + c);
  }
  *out = acc;
}

}  // namespace

extern "C" int ordered_add_launch(void* base, const void* keys,
                                  const void* perm, const void* src,
                                  long long n, int W, long long drop,
                                  int device, void* stream) {
  if (n < 0 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long threads = n * W;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads)),
      block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(base);
  const long long* k = static_cast<const long long*>(keys);
  const long long* p = static_cast<const long long*>(perm);
  const float* x = static_cast<const float*>(src);
  return launch_on(device, [&] {
    if (p != nullptr) {
      ordered_add_kernel<true><<<grid, block, 0, s>>>(b, k, p, x, n, W, drop);
    } else {
      ordered_add_kernel<false><<<grid, block, 0, s>>>(b, k, p, x, n, W, drop);
    }
  });
}
