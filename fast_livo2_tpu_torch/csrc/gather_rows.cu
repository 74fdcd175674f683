// Row gather out[n, :] = table[idx[n], :] for a (C, W) float32 table and
// N int32 row indices: the Hopper port of the TPU kernel
// fast_livo2_tpu/ops/pallas_gather.py:gather_rows (Pallas body `_kernel`,
// pallas_gather.py:27-49).
//
// What it computes, not the TPU's block structure: the TPU prefetched
// the indices to SMEM by scalar prefetch and, per grid step, issued
// `group` row DMAs into VMEM, waited, and wrote the (group, W) block.
// Here each block loads its own indices and every warp copies one whole
// row (eight rows a block), its 32 lanes reading neighbouring 16-byte
// float4s of the row (the vector path: W % 4 == 0 and both base pointers
// 16-byte aligned, which the wrapper decides from the real pointers) or
// neighbouring floats (the scalar path). Nothing is staged through shared memory: a gather
// reuses no byte it reads. The copy is exact (loads and stores only).
//
// What bounds it on an H100: bytes. At the LIO map's shape (C = 262,144
// slots of W = 128 floats, N = 8,192 rows) it reads 4 MiB of rows and
// 32 KiB of indices and writes 4 MiB: 8,421,376 B, 2.51 us at 3.35 TB/s.
// The 128 MiB table does not fit the 50 MB L2, so rows the L2 has not
// seen come from HBM; each 512 B row is four full 128 B sectors, so no
// sector is read in part. With 8,192 rows in flight as 1,024 blocks of 8
// warps the card has enough independent loads outstanding to cover the
// HBM latency; the launch itself (a few microseconds) is of the same
// order as the bound.
//
// Indices are not range-checked (a check on the host would be a device
// sync): an index outside [0, C) reads outside the table, as the TPU
// kernel's DMA is undefined there.
//
// C interface for ctypes: gather_rows_launch(table, idx, out, N, W, vec,
// stream) takes a contiguous float32 table (C, W), int32 idx (N,) and
// float32 out (N, W) as device pointers, launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows in flight per block (one warp a row)

template <bool kVec>
__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int N, int W) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  const size_t src = static_cast<size_t>(__ldg(idx + n)) * W;
  const size_t dst = static_cast<size_t>(n) * W;
  if (kVec) {
    const float4* s = reinterpret_cast<const float4*>(table + src);
    float4* d = reinterpret_cast<float4*>(out + dst);
    for (int c = lane; c < (W >> 2); c += 32) d[c] = __ldg(s + c);
  } else {
    for (int c = lane; c < W; c += 32) out[dst + c] = __ldg(table + src + c);
  }
}

}  // namespace

extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  void* out, int N, int W, int vec,
                                  void* stream) {
  if (N < 0 || W < 1 || (vec && (W & 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  if (vec) {
    gather_rows_kernel<true><<<grid, block, 0, s>>>(t, i, o, N, W);
  } else {
    gather_rows_kernel<false><<<grid, block, 0, s>>>(t, i, o, N, W);
  }
  return static_cast<int>(cudaGetLastError());
}
