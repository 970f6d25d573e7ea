// Hopper (sm_90a) kernels of the switch-transaction path, behind a plain C
// interface loaded with ctypes (see ../build.py).
//
// switch_txn: replaces repro/kernels/switch_txn/switch_txn.py::_kernel
// (switch_txn_call).  The TPU kernel keeps the whole register file in VMEM
// and walks the instruction stream on one sequential grid.  On an H100 the
// full-width file (24 x 65536 int32 = 6 MiB) is far beyond the 227 KB of
// shared memory one block may hold, and a sequential grid would leave 131
// of 132 SMs idle.  Without ADDP only per-slot order matters, so the
// wrapper stable-sorts the stream by slot (a permutation, not the RMW) and
// this kernel runs one thread per sorted position: each thread that starts
// a slot segment walks the segment in stream order with the register held
// in a local variable, writes res/ok back through the permutation, and
// stores the register once.  NOPs touch no register; the wrapper gives
// them the key n_slots, so the bucket padding (NOP rows, unused
// instruction slots: often half the stream) is answered one thread per
// NOP instead of forming one long segment at slot 0.  What bounds it: a
// B=256, K=16 group moves ~48 KB of stream in and ~32 KB of results out
// plus one register touch per distinct slot — well under a microsecond at
// 3.35 TB/s — so the kernel is bound by launch and by the serial walk of
// the longest (hottest) segment, not by bytes.  Hot-key skew lengthens that walk; it is P4DB's hot-tuple
// case and stays in one thread so the per-slot order is the stream order.
//
// result_gather: replaces switch_txn.py::_gather_kernel
// (result_gather_call).  One thread per output, out[i] = src[clamp(idx[i],
// 0, n-1)].  The TPU clamps only from above; indices are never negative on
// the hot path (pad gathers point at slot 0), and the low clamp keeps a
// stray negative index from reading outside the buffer.  Bound by bytes
// (M reads of idx, M scattered reads of src, M writes), i.e. by launch at
// the path's M <= B*K.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNop = 0, kRead = 1, kWrite = 2, kAdd = 3, kCadd = 4;
constexpr int kThreads = 256;

// int32 addition that wraps like JAX's int32 (signed overflow is undefined
// in C++; unsigned overflow is defined modulo 2^32).
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void switch_txn_kernel(int32_t* __restrict__ regs,
                                  int32_t n_slots,
                                  const int32_t* __restrict__ op,
                                  const int32_t* __restrict__ val,
                                  const int32_t* __restrict__ sorted_slot,
                                  const int64_t* __restrict__ perm,
                                  int32_t* __restrict__ res,
                                  int32_t* __restrict__ ok, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t g = sorted_slot[i];
  if (g >= n_slots) {                              // NOP: no register
    const int64_t p = perm[i];
    res[p] = 0;
    ok[p] = 1;
    return;
  }
  if (i > 0 && sorted_slot[i - 1] == g) return;   // not a segment head
  int32_t cur = regs[g];
  for (int j = i; j < n && sorted_slot[j] == g; ++j) {
    const int64_t p = perm[j];                     // stream position
    const int32_t o = op[p];
    const int32_t v = val[p];
    const int32_t post = wrap_add(cur, v);
    const bool cadd_ok = post >= 0;
    int32_t next = cur;
    if (o == kWrite) next = v;
    else if (o == kAdd || (o == kCadd && cadd_ok)) next = post;
    res[p] = o == kRead ? cur : (o == kNop ? 0 : next);
    ok[p] = (o == kCadd && !cadd_ok) ? 0 : 1;
    cur = next;                                    // NOP keeps cur
  }
  regs[g] = cur;
}

__global__ void result_gather_kernel(const int32_t* __restrict__ src,
                                     int n_src,
                                     const int32_t* __restrict__ idx,
                                     int32_t* __restrict__ out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int32_t j = idx[i];
  j = j < 0 ? 0 : (j > n_src - 1 ? n_src - 1 : j);
  out[i] = src[j];
}

}  // namespace

extern "C" {

// Applies n instructions to regs[n_slots] in place.  sorted_slot holds the
// stream's clamped slots (n_slots for a NOP) in stable-sorted order and
// perm the stream position of each sorted entry.  Returns
// cudaGetLastError() after the launch.
int switch_txn_launch(void* regs, int n_slots, const void* op,
                      const void* val, const void* sorted_slot,
                      const void* perm, void* res, void* ok, int n,
                      void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  switch_txn_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(regs), n_slots, static_cast<const int32_t*>(op),
      static_cast<const int32_t*>(val),
      static_cast<const int32_t*>(sorted_slot),
      static_cast<const int64_t*>(perm), static_cast<int32_t*>(res),
      static_cast<int32_t*>(ok), n);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = src[clamp(idx[i], 0, n_src - 1)] for i < m.  Returns
// cudaGetLastError() after the launch.
int result_gather_launch(const void* src, int n_src, const void* idx,
                         void* out, int m, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  result_gather_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), n_src,
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
