// Hopper (sm_90a) kernels of the switch-transaction path, behind a plain C
// interface loaded with ctypes (see ../../build.py).
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
//
// scan_prune: replaces switch_txn.py::_scan_prune_kernel (scan_prune_call).
// The TPU kernel walks the value stream in order on one sequential grid,
// appending each match to a cap-row scratch through a sacrificial slot and
// carrying the aggregates in scratch memory.  On an H100 that order is a
// prefix sum, so the compaction runs in three passes over one thread per
// element: (1) each block counts its matches with __ballot_sync/__popc and
// folds the aggregates into agg[4] with one atomic per block and lane
// (the sum as uint32: addition modulo 2^32 is exact in any order, which is
// JAX's int32 wraparound; min/max as signed int); (2) one block turns the
// per-block counts into exclusive offsets; (3) each block whose offset is
// still below cap recomputes its matches, ranks them by ballot + prefix
// popcount and writes (value, position) where the global rank is < cap.
// What bounds it: bytes — the stream is read once by pass 1 and again by
// the blocks of pass 3 that still hold ranks below cap (none past the
// cap-th match), and cap rows are written; the three launches dominate
// below ~1M elements.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNop = 0, kRead = 1, kWrite = 2, kAdd = 3, kCadd = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ bool in_range(int32_t v, int32_t lo, int32_t hi) {
  return v >= lo && v <= hi;                       // signed compares
}

// Pass 1: per-block match counts, and the aggregates over every match.
__global__ void scan_count_kernel(const int32_t* __restrict__ src, int m,
                                  int32_t lo, int32_t hi,
                                  int32_t* __restrict__ block_count,
                                  int32_t* __restrict__ agg) {
  __shared__ int32_t s_cnt[kWarps], s_min[kWarps], s_max[kWarps];
  __shared__ uint32_t s_sum[kWarps];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int32_t v = i < m ? src[i] : 0;
  const bool hit = i < m && in_range(v, lo, hi);
  const unsigned mask = __ballot_sync(kFull, hit);
  const uint32_t sum = __reduce_add_sync(kFull, hit ? static_cast<uint32_t>(v)
                                                    : 0u);
  const int32_t mn = __reduce_min_sync(kFull, hit ? v : INT32_MAX);
  const int32_t mx = __reduce_max_sync(kFull, hit ? v : INT32_MIN);
  if (lane == 0) {
    s_cnt[w] = __popc(mask);
    s_sum[w] = sum;
    s_min[w] = mn;
    s_max[w] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t cnt = 0, bmin = INT32_MAX, bmax = INT32_MIN;
    uint32_t bsum = 0;
    for (int k = 0; k < kWarps; ++k) {
      cnt += s_cnt[k];
      bsum += s_sum[k];
      bmin = min(bmin, s_min[k]);
      bmax = max(bmax, s_max[k]);
    }
    block_count[blockIdx.x] = cnt;
    if (cnt > 0) {
      atomicAdd(&agg[0], cnt);
      atomicAdd(reinterpret_cast<unsigned int*>(&agg[1]), bsum);
      atomicMin(&agg[2], bmin);
      atomicMax(&agg[3], bmax);
    }
  }
}

// Pass 2: exclusive prefix sum of the n block counts, in place, by one
// block of kScanThreads threads walking the counts in tiles.
__global__ void scan_offsets_kernel(int32_t* __restrict__ counts, int n) {
  __shared__ int32_t s_warp[kScanThreads / 32];
  __shared__ int32_t s_carry;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int n_warps = kScanThreads / 32;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int32_t v = i < n ? counts[i] : 0;
    int32_t x = v;                                  // inclusive, in the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_warp[w] = x;
    __syncthreads();
    if (w == 0) {                                   // scan the warp totals
      int32_t t = lane < n_warps ? s_warp[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t += y;
      }
      if (lane < n_warps) s_warp[lane] = t;
    }
    __syncthreads();
    const int32_t carry = s_carry;
    if (i < n) counts[i] = carry + (w > 0 ? s_warp[w - 1] : 0) + x - v;
    __syncthreads();                                // every thread read carry
    if (threadIdx.x == 0) s_carry = carry + s_warp[n_warps - 1];
    __syncthreads();
  }
}

// Pass 3: ordered writes of the first cap matches.
__global__ void scan_write_kernel(const int32_t* __restrict__ src, int m,
                                  int32_t lo, int32_t hi,
                                  const int32_t* __restrict__ offset, int cap,
                                  int32_t* __restrict__ vals,
                                  int32_t* __restrict__ idx) {
  __shared__ int32_t s_warp[kWarps];
  const int32_t base = offset[blockIdx.x];
  if (base >= cap) return;                         // uniform per block
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int32_t v = i < m ? src[i] : 0;
  const bool hit = i < m && in_range(v, lo, hi);
  const unsigned mask = __ballot_sync(kFull, hit);
  if (lane == 0) s_warp[w] = __popc(mask);
  __syncthreads();
  int32_t before = 0;                              // matches in earlier warps
  for (int k = 0; k < w; ++k) before += s_warp[k];
  const int32_t rank = base + before + __popc(mask & ((1u << lane) - 1u));
  if (hit && rank < cap) {
    vals[rank] = v;
    idx[rank] = i;
  }
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

// The int32 count of the scratch buffer scan_prune_launch needs for an
// m-element stream: one per block of its passes.
int scan_prune_scratch_len(int m) { return (m + kThreads - 1) / kThreads; }

// Range scan of src[m] (m >= 1) for lo <= v <= hi: the first cap matches
// in stream order go to vals[cap] / idx[cap], and agg[4] accumulates
// (count, sum, min, max) over every match.  The caller pre-fills vals with
// 0, idx with -1 and agg with (0, 0, INT32_MAX, INT32_MIN); scratch holds
// scratch_len int32, at least scan_prune_scratch_len(m) (else
// cudaErrorInvalidValue, nothing launched).  Returns the first non-zero
// cudaGetLastError() of the three launches.
int scan_prune_launch(const void* src, int m, int lo, int hi, int cap,
                      void* vals, void* idx, void* agg, void* scratch,
                      int scratch_len, void* stream) {
  const int blocks = scan_prune_scratch_len(m);
  if (scratch_len < blocks) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in = static_cast<const int32_t*>(src);
  int32_t* offs = static_cast<int32_t*>(scratch);
  scan_count_kernel<<<blocks, kThreads, 0, s>>>(in, m, lo, hi, offs,
                                               static_cast<int32_t*>(agg));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_offsets_kernel<<<1, kScanThreads, 0, s>>>(offs, blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_write_kernel<<<blocks, kThreads, 0, s>>>(
      in, m, lo, hi, offs, cap, static_cast<int32_t*>(vals),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
