// Hopper (sm_90a) kernel of MoE capacity arbitration, behind a plain C
// interface loaded with ctypes (see ../../build.py).
//
// moe_route: replaces repro/kernels/moe_route/moe_route.py::_kernel
// (moe_route_call).  For an ascending expert-id stream ids[n] it writes
// pos[i] = i - (first index j with ids[j] == ids[i]): the pre-increment
// read of expert ids[i]'s admission counter when the entries increment it
// in stream order (P4DB's hot-tuple counter).  The TPU kernel walks the
// stream in blocks on one sequential grid, counting equal ids in a
// block x block strict lower triangle and carrying (last id, count) in
// SMEM from block to block, so N must be a multiple of the block (the
// wrapper pads with INT32_MAX).  On Hopper the blocks run in no order and
// nothing carries between them, so this kernel computes the function
// directly, one thread per entry: pos[i] = i - lower_bound(ids[0..i],
// ids[i]).  The stream is sorted, so the first index of ids[i]'s run is
// that lower bound; there is no carry, no inter-block order and no
// padding, and n need not be a multiple of anything.  Chosen over a
// head-flag segmented max-scan because it is one pass with no shared
// memory and no cross-block step; the log2(n) probes of a thread fall on
// the same few cache lines as its neighbours' (threads of one run search
// the same prefix), so they are served from L1/L2.  What bounds it: bytes,
// 4n read and 4n written (0.04 us at 3.35 TB/s for n = 16,384, the
// Qwen3-MoE prefill stream of 2,048 tokens x top-8); at the serving path's
// n (64 per decode step, 16,384 per prefill) it is bound by the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void moe_route_kernel(const int32_t* __restrict__ ids,
                                 int32_t* __restrict__ pos, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t v = ids[i];
  int lo = 0, hi = i;                // ids[i] == v, so the answer is <= i
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ids[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  pos[i] = i - lo;
}

}  // namespace

extern "C" {

// pos[i] = i - (first index of ids[i]'s run) for an ascending ids[n],
// n >= 1.  Returns cudaGetLastError() after the launch.
int moe_route_launch(const void* ids, int n, void* pos, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  moe_route_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(pos), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
