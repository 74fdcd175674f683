// Stage marks: one frame's stage bounds as device timestamps, written in
// stream order with the frame's own kernels (utils/timing.StageClock).
//
// It replaces no TPU kernel. The JAX package's stage timing runs each
// stage as its own program and blocks on it; the port's fused frame is
// one captured CUDA graph, and host-side ranges (NVTX, the profiler's
// record_function) record nothing into a graph. A mark is a kernel, so a
// capture keeps it and every replay writes it again.
//
// Design. One thread reads the card's %globaltimer (nanoseconds) and
// writes it into its slot of a small int64 buffer on the device. Each
// slot is its own instantiation, `stage_mark_kernel<slot>`, so that a
// profile names the slot of every mark it sees, even where the profiler
// drops other events. Nothing waits for a mark; the buffer is read with
// the frame's other outputs. What bounds it: the launch (one node of the
// graph, about as long as any small kernel's), nothing else.
//
// Kernel nodes by stage. While a stream captures, `capture_kernel_nodes`
// counts the kernel nodes of the graph it captures into (the runtime
// permits every query of that graph during the capture), so the clock
// can count, at each mark, the nodes each stage added.
//
// C interface for ctypes:
//   stage_mark_launch(marks, slot, device, stream): launches the slot's
//     mark on `stream` of CUDA device `device` (launch_on.cuh), writing
//     int64 marks[slot]; slot in [0, 64).
//   capture_kernel_nodes(stream, count): *count = the kernel nodes of the
//     graph `stream` captures into, or -1 where it is not capturing.
//   graph_kernel_nodes(graph, count): *count = the kernel nodes of a
//     cudaGraph_t.
// Each returns a cudaError_t.

#include <cuda_runtime.h>

#include <utility>
#include <vector>

#include "launch_on.cuh"

constexpr int kSlots = 64;

template <int kSlot>
__global__ void stage_mark_kernel(unsigned long long* marks) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  marks[kSlot] = t;
}

namespace {

template <int... I>
const void* const* mark_kernels(std::integer_sequence<int, I...>) {
  static const void* const table[] = {
      reinterpret_cast<const void*>(&stage_mark_kernel<I>)...};
  return table;
}

}  // namespace

extern "C" int graph_kernel_nodes(void* graph, long long* count) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (e = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  long long kernels = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if ((e = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess) {
      return static_cast<int>(e);
    }
    kernels += type == cudaGraphNodeTypeKernel;
  }
  *count = kernels;
  return static_cast<int>(cudaSuccess);
}

extern "C" int capture_kernel_nodes(void* stream, long long* count) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaError_t e = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) {
    *count = -1;
    return static_cast<int>(cudaSuccess);
  }
  return graph_kernel_nodes(graph, count);
}

extern "C" int stage_mark_launch(void* marks, int slot, int device,
                                 void* stream) {
  if (slot < 0 || slot >= kSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const void* const* kernels =
      mark_kernels(std::make_integer_sequence<int, kSlots>{});
  void* args[] = {&marks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_on(device, [&] {
    cudaLaunchKernel(kernels[slot], dim3(1), dim3(1), args, 0, s);
  });
}
