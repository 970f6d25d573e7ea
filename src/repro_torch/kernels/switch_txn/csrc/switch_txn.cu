// Hopper (sm_90a) kernels of the switch-transaction path, behind a plain C
// interface loaded with ctypes (see ../../build.py).
//
// switch_txn_smem: replaces repro/kernels/switch_txn/switch_txn.py:29
// (_kernel, switch_txn_call) together with :61 (_gather_kernel,
// result_gather_call) on the hot dispatch.  The TPU kernel keeps the
// whole register file in VMEM and walks the instruction stream in order
// on one sequential grid; the full-width file (24 x 65536 int32 = 6 MiB)
// is far beyond the 227 KB of shared memory an H100 block may hold.
// Without ADDP only per-slot order matters, so one block of up to 512
// threads takes a whole hot group of N <= kSmemMaxN instructions and
// keeps everything but the register file in shared memory:
//   1. load op/stage/reg/val with 16-byte loads where aligned; compute
//      each key, the slot stage * R + reg (int32 wraparound) clamped into
//      [0, n_slots - 1], or n_slots for a NOP; fetch each instruction's
//      register (all fetches in flight at once, one device-memory round
//      trip, so a segment head later reads its register from shared
//      memory);
//   2. stable block radix sort of (key, stream position) with
//      cub::BlockRadixSort over the key's bit_length(n_slots) bits (21 at
//      full width); a ragged N is padded with keys n_slots, which sort
//      after every NOP and answer nothing;
//   3. copy op and val into sorted order, then the thread at the head of
//      each slot segment walks it in stream order with the register in a
//      local (the next step's key, op, val and position are read before
//      this step's stores, so a step waits on about one shared-memory
//      round trip, where the large-N path waits on three dependent
//      device-memory reads), writes res/ok at the stream position and
//      stores the register once; a NOP answers (0, 1) and touches no
//      register;
//   4. write res [N] int32 and ok [N] as bytes (torch.bool) coalesced,
//      and compact[j] = res[clamp(idx[j], 0, N - 1)] from shared memory:
//      result_gather's function with no second launch.
// The tile is the smallest of 256, 1024, 4096 or 8192 instructions that
// holds N (256 x 1, 256 x 4, 512 x 8 and 512 x 16 threads x items).
// Shared memory per tile instruction: val, the fetched register and the
// sorted val (12 B), op and sorted op (2 B), and a region that holds the
// keys, then CUB's sort storage, then the sorted keys and 16-bit
// positions (max(sort storage, 6 B)): about 20 B, 160 KB at the 8192
// tile (163,840 bytes; 81,920 at the main path's 4096 tile).
// kSmemMaxN = 8192 is the largest power of two that fits in 227 KB
// (16384 would need 320 KB).  What bounds it: not bytes (a B=256, K=16
// group moves ~80 KB of stream and results plus one register touch per
// distinct slot, under 0.04 us at 3.35 TB/s) but the launch, the block
// sort on one SM, and on a skewed stream the serial walk of the hottest
// segment (chip_smoke.py times the kernel with and without hot slots;
// PERF.md has the numbers).  ptxas -v on sm_90a, as chip_smoke.py prints
// it: 32 / 48 / 64 / 108 registers for the 256 / 1024 / 4096 / 8192
// tiles, no stack frame, no spills.
//
// switch_txn (the large-N path, N > kSmemMaxN): replaces the same
// switch_txn.py:29.  The wrapper stable-sorts the stream by slot with
// torch.sort (keys as above) and this kernel runs one thread per sorted
// position: each thread that starts a slot segment walks it in stream
// order through the permutation, writes res/ok back to device memory and
// stores the register once; result_gather compacts afterwards.  Bound by
// the sort's launches and by the hottest segment's walk, three dependent
// device-memory reads a step.
//
// result_gather: replaces switch_txn.py:61 (_gather_kernel) for the
// read tier and the large-N path.  One thread per output, out[i] =
// src[clamp(idx[i], 0, n-1)].  The TPU clamps only from above; the low
// clamp keeps a stray negative index inside the buffer.  Bound by launch
// at the path's M: 1.3 us of device time; its Python launcher does the
// least host work per call (see switch_txn.py).
//
// scan_prune: replaces switch_txn.py:105 (_scan_prune_kernel,
// scan_prune_call) and, on the scan path, :61 (_gather_kernel): the value
// stream v[j] = src[clamp(idx[j], 0, n_src - 1)] (src[j] without idx) is
// filtered by lo <= v <= hi; the first cap matches in stream order and
// (count, sum, min, max) over all matches go to one packed int32 buffer
// out[2 cap + 4] = vals[cap] | pos[cap] | agg[4], which the kernel writes
// whole (0 and -1 past the count, the identities when nothing matches),
// so the launcher pre-fills nothing and a scan ships one buffer to the
// host.  The TPU kernel walks the stream in order on one sequential grid,
// appending each match through a sacrificial slot and carrying the
// aggregates in scratch; on an H100 that order is a prefix sum.  What
// bounds it: not bytes (the main path's M = 400 or 4,096 indices and
// values are 3-32 KB, ns at 3.35 TB/s) but launches and round trips, so
// for M <= kScanSmemMaxM (16,384, every scan on the main path) the scan is
// ONE block: a blocked load of kIpt positions a thread with every index
// and value load in flight at once (16-byte index loads where aligned),
// a cub::BlockScan exclusive sum of the threads' match counts (each
// match's rank in stream order), the writes of ranks < cap, and a warp-
// shuffle block reduction of the aggregates (the sum as uint32: addition
// modulo 2^32 is JAX's int32 wraparound; min/max signed).  No atomics, no
// scratch, deterministic.  The tile is the smallest of 512, 2,048, 4,096
// or 16,384 positions that holds M (128 x 4, 256 x 8, 512 x 8, 1024 x 16
// threads x items).  A longer stream (the full-width register file,
// 1,572,864) takes two launches over tiles of 4,096: scan_block_agg_kernel
// writes each tile's (count, sum, min, max) to scratch;
// scan_block_write_kernel has each block fold the counts of the tiles
// before it into its offset and, while that offset is below cap, reload
// its tile, rank its matches into shared memory and write those < cap as
// one coalesced run; block 0 folds every tile into agg and writes the
// pads.  Two passes rather than one with decoupled look-
// back: the second pass rereads only the tiles that hold ranks below cap,
// and no block waits on another.  ptxas -v on sm_90a, as chip_smoke.py
// prints it: 32 / 38 / 64 / 64 registers for the 512 / 2,048 / 4,096 /
// 16,384 tiles (the last spills 48 bytes), 34 and 48 for the two passes.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "../../csrc/device_scope.cuh"

namespace {

constexpr int32_t kNop = 0, kRead = 1, kWrite = 2, kAdd = 3, kCadd = 4;
constexpr int32_t kOther = 5;      // any other opcode: answers the register
constexpr int kSmemMaxN = 8192;
constexpr int kThreads = 256;
constexpr int kScanSmemMaxM = 16384;   // the single-CTA scan's longest stream
constexpr int kLargeT = 256, kLargeIpt = 16;   // the large-M path's tile
constexpr int kLargeTile = kLargeT * kLargeIpt;
constexpr unsigned kFull = 0xffffffffu;

// int32 addition that wraps like JAX's int32 (signed overflow is undefined
// in C++; unsigned overflow is defined modulo 2^32).
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// The single-CTA kernel's shared-memory layout for a tile of kT x kIpt
// instructions (the byte budget is in the note above).
template <int kT, int kIpt>
struct SmemTile {
  static constexpr int kTile = kT * kIpt;
  using BlockSort = cub::BlockRadixSort<uint32_t, kT, kIpt, uint32_t>;
  static constexpr size_t kSortBytes =
      sizeof(typename BlockSort::TempStorage);
  static constexpr size_t kSortedBytes = size_t(kTile) * 6;  // key + u16 pos
  static constexpr size_t kUnion =
      ((kSortBytes > kSortedBytes ? kSortBytes : kSortedBytes) + 15) / 16 * 16;
  static constexpr size_t kBytes = size_t(kTile) * 12 + kUnion +
                                   size_t(kTile) * 2;
};

template <int kT, int kIpt>
__global__ void __launch_bounds__(kT) switch_txn_smem_kernel(
    int32_t* __restrict__ regs, int32_t n_slots, int32_t R,
    const int32_t* __restrict__ op, const int32_t* __restrict__ stage,
    const int32_t* __restrict__ reg, const int32_t* __restrict__ val, int n,
    int end_bit, int vec_in, int32_t* __restrict__ res,
    uint8_t* __restrict__ ok, int vec_out, const int32_t* __restrict__ idx,
    int32_t* __restrict__ compact, int m) {
  using Tile = SmemTile<kT, kIpt>;
  constexpr int kTile = Tile::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_val = reinterpret_cast<int32_t*>(smem);  // stream order; res
  int32_t* s_cur = s_val + kTile;       // each instruction's register
  int32_t* s_sval = s_cur + kTile;      // val in sorted order
  unsigned char* u = smem + size_t(kTile) * 12;
  uint32_t* s_key = reinterpret_cast<uint32_t*>(u);   // keys, sorted keys
  uint16_t* s_spos = reinterpret_cast<uint16_t*>(u + size_t(kTile) * 4);
  auto& sort_tmp =
      *reinterpret_cast<typename Tile::BlockSort::TempStorage*>(u);
  uint8_t* s_op = u + Tile::kUnion;     // stream order opcode; ok
  uint8_t* s_sop = s_op + kTile;        // opcode in sorted order
  const int tid = threadIdx.x;
  const uint32_t nop_key = static_cast<uint32_t>(n_slots);

  // 1. load, four instructions a thread per step; padding loads as NOP
  for (int base = tid * 4; base < kTile; base += kT * 4) {
    int32_t o[4], st[4], rg[4], v[4];
    if (vec_in && base + 4 <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(op + base));
      const int4 b = __ldg(reinterpret_cast<const int4*>(stage + base));
      const int4 c = __ldg(reinterpret_cast<const int4*>(reg + base));
      const int4 d = __ldg(reinterpret_cast<const int4*>(val + base));
      o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
      st[0] = b.x; st[1] = b.y; st[2] = b.z; st[3] = b.w;
      rg[0] = c.x; rg[1] = c.y; rg[2] = c.z; rg[3] = c.w;
      v[0] = d.x; v[1] = d.y; v[2] = d.z; v[3] = d.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = base + e;
        const bool in = p < n;
        o[e] = in ? op[p] : kNop;
        st[e] = in ? stage[p] : 0;
        rg[e] = in ? reg[p] : 0;
        v[e] = in ? val[p] : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = base + e;
      const int32_t g = static_cast<int32_t>(
          static_cast<uint32_t>(st[e]) * static_cast<uint32_t>(R) +
          static_cast<uint32_t>(rg[e]));
      const int32_t slot = g < 0 ? 0 : (g >= n_slots ? n_slots - 1 : g);
      const bool nop = o[e] == kNop;
      s_key[p] = nop ? nop_key : static_cast<uint32_t>(slot);
      s_op[p] = static_cast<uint8_t>(
          static_cast<uint32_t>(o[e]) <= static_cast<uint32_t>(kCadd)
              ? o[e] : kOther);
      s_val[p] = v[e];
      s_cur[p] = nop ? 0 : regs[slot];
    }
  }
  __syncthreads();

  // 2. stable sort of (key, position): the input is blocked (thread t
  // holds positions t * kIpt .. t * kIpt + kIpt - 1), so equal keys keep
  // stream order; the output is striped (rank i * kT + t)
  uint32_t keys[kIpt], pos[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    pos[i] = static_cast<uint32_t>(tid * kIpt + i);
    keys[i] = s_key[pos[i]];
  }
  __syncthreads();                      // sort_tmp overlays s_key
  using BlockSort = typename Tile::BlockSort;
  BlockSort(sort_tmp).SortBlockedToStriped(keys, pos, 0, end_bit);
  __syncthreads();                      // before sort_tmp is reused

  // 3. sorted keys, positions, opcodes and operands
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int j = i * kT + tid;
    s_key[j] = keys[i];
    s_spos[j] = static_cast<uint16_t>(pos[i]);
    s_sop[j] = s_op[pos[i]];
    s_sval[j] = s_val[pos[i]];
  }
  __syncthreads();

  // 4. walk: the head of each slot segment applies it in stream order;
  // results go to s_val / s_op at the stream position
#pragma unroll 1
  for (int j0 = tid; j0 < kTile; j0 += kT) {
    const uint32_t g = s_key[j0];
    const int p0 = s_spos[j0];
    if (g >= nop_key) {                 // NOP (or padding): no register
      if (p0 < n) {
        s_val[p0] = 0;
        s_op[p0] = 1;
      }
      continue;
    }
    if (j0 > 0 && s_key[j0 - 1] == g) continue;   // not a segment head
    int32_t cur = s_cur[p0];
    int j = j0, p = p0;
    int32_t o = s_sop[j], v = s_sval[j];
    for (;;) {
      const int jn = j + 1 < kTile ? j + 1 : j;   // read the next step
      const uint32_t gn = s_key[jn];              // before this one's
      const int32_t on = s_sop[jn], vn = s_sval[jn];    // stores
      const int pn = s_spos[jn];
      const int32_t post = wrap_add(cur, v);
      const bool cadd_ok = post >= 0;
      int32_t next = cur;
      if (o == kWrite) next = v;
      else if (o == kAdd || (o == kCadd && cadd_ok)) next = post;
      s_val[p] = o == kRead ? cur : next;
      s_op[p] = (o == kCadd && !cadd_ok) ? 0 : 1;
      cur = next;
      if (jn == j || gn != g) break;
      j = jn;
      o = on;
      v = vn;
      p = pn;
    }
    regs[g] = cur;
  }
  __syncthreads();

  // 5. epilogue: res, ok and the compacted gather, coalesced
  if (vec_out) {
    for (int q = tid; q < n / 4; q += kT) {
      reinterpret_cast<int4*>(res)[q] = reinterpret_cast<const int4*>(s_val)[q];
      reinterpret_cast<uint32_t*>(ok)[q] =
          reinterpret_cast<const uint32_t*>(s_op)[q];
    }
    for (int p = n / 4 * 4 + tid; p < n; p += kT) {
      res[p] = s_val[p];
      ok[p] = s_op[p];
    }
  } else {
    for (int p = tid; p < n; p += kT) {
      res[p] = s_val[p];
      ok[p] = s_op[p];
    }
  }
  for (int q = tid; q < m; q += kT) {
    int32_t k = idx[q];
    k = k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
    compact[q] = s_val[k];
  }
}

// One launch of the single-CTA kernel at tile kT x kIpt on device dev
// (the current device, under the caller's DeviceScope); raises the block's
// dynamic shared-memory limit once per device.
template <int kT, int kIpt>
cudaError_t launch_smem(int dev, int32_t* regs, int n_slots, int R,
                        const int32_t* op, const int32_t* stage,
                        const int32_t* reg, const int32_t* val, int n,
                        int end_bit, int vec_in, int32_t* res, uint8_t* ok,
                        int vec_out, const int32_t* idx, int32_t* compact,
                        int m, cudaStream_t s) {
  static std::atomic<unsigned> configured{0};
  constexpr int bytes = static_cast<int>(SmemTile<kT, kIpt>::kBytes);
  const unsigned bit = 1u << (dev & 31);
  if (!(configured.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        switch_txn_smem_kernel<kT, kIpt>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  switch_txn_smem_kernel<kT, kIpt><<<1, kT, bytes, s>>>(
      regs, n_slots, R, op, stage, reg, val, n, end_bit, vec_in, res, ok,
      vec_out, idx, compact, m);
  return cudaGetLastError();
}

static_assert(SmemTile<512, 16>::kTile == kSmemMaxN, "largest tile");
static_assert(SmemTile<512, 16>::kBytes <= 232448,
              "the largest tile fits in a block's shared memory");

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

// The kIpt values at one thread's positions p0 .. p0 + kIpt - 1 of the
// stream v[j] = src[clamp(idx[j], 0, n_src - 1)] (src[j] when idx is
// null), each flagged in hit when j < m and lo <= v <= hi.  Every load is
// issued before the first is used; the index (or value) run is read as
// 16-byte loads when vec (its pointer 16-byte aligned) and the whole run
// lies inside the stream.
template <int kIpt>
__device__ __forceinline__ void scan_load(
    const int32_t* __restrict__ src, int n_src,
    const int32_t* __restrict__ idx, int m, int p0, int vec, int32_t lo,
    int32_t hi, int32_t (&v)[kIpt], bool (&hit)[kIpt]) {
  const int32_t* stream = idx != nullptr ? idx : src;
  int32_t k[kIpt];
  bool done = false;
  if constexpr (kIpt % 4 == 0) {
    if (vec && p0 + kIpt <= m) {
#pragma unroll
      for (int i = 0; i < kIpt; i += 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(stream + p0 + i));
        k[i] = q.x;
        k[i + 1] = q.y;
        k[i + 2] = q.z;
        k[i + 3] = q.w;
      }
      done = true;
    }
  }
  if (!done) {
#pragma unroll
    for (int i = 0; i < kIpt; ++i)
      k[i] = p0 + i < m ? __ldg(stream + p0 + i) : 0;
  }
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    if (idx != nullptr) {
      const int32_t j = k[i] < 0 ? 0 : (k[i] > n_src - 1 ? n_src - 1 : k[i]);
      v[i] = p0 + i < m ? __ldg(src + j) : 0;
    } else {
      v[i] = k[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kIpt; ++i)
    hit[i] = p0 + i < m && v[i] >= lo && v[i] <= hi;   // signed compares
}

// (count, sum, min, max) of matches; the sum wraps modulo 2^32.
struct ScanAgg {
  int32_t cnt;
  uint32_t sum;
  int32_t mn, mx;
};

__device__ __forceinline__ ScanAgg scan_agg_empty() {
  return ScanAgg{0, 0u, INT32_MAX, INT32_MIN};
}

__device__ __forceinline__ void scan_fold(ScanAgg& a, int32_t cnt,
                                          uint32_t sum, int32_t mn,
                                          int32_t mx) {
  a.cnt += cnt;
  a.sum += sum;
  a.mn = min(a.mn, mn);
  a.mx = max(a.mx, mx);
}

template <int kIpt>
__device__ __forceinline__ ScanAgg thread_agg(const int32_t (&v)[kIpt],
                                              const bool (&hit)[kIpt]) {
  ScanAgg a = scan_agg_empty();
#pragma unroll
  for (int i = 0; i < kIpt; ++i)
    if (hit[i]) scan_fold(a, 1, static_cast<uint32_t>(v[i]), v[i], v[i]);
  return a;
}

// The block's total of every thread's aggregates, returned to every
// thread: warp shuffles, then each thread folds the kT / 32 warp totals.
// Every thread of the block must call it.
template <int kT>
__device__ __forceinline__ ScanAgg block_agg(ScanAgg a, ScanAgg* s_warp) {
  a.cnt = __reduce_add_sync(kFull, a.cnt);
  a.sum = __reduce_add_sync(kFull, a.sum);
  a.mn = __reduce_min_sync(kFull, a.mn);
  a.mx = __reduce_max_sync(kFull, a.mx);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = a;
  __syncthreads();
  ScanAgg t = s_warp[0];
#pragma unroll
  for (int w = 1; w < kT / 32; ++w)
    scan_fold(t, s_warp[w].cnt, s_warp[w].sum, s_warp[w].mn, s_warp[w].mx);
  return t;
}

// One thread's matches, in stream order from rank on: (value, position)
// where the rank is below cap.
template <int kIpt>
__device__ __forceinline__ void scan_write(const int32_t (&v)[kIpt],
                                           const bool (&hit)[kIpt], int rank,
                                           int p0, int cap,
                                           int32_t* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    if (hit[i]) {
      if (rank < cap) {
        out[rank] = v[i];
        out[cap + rank] = p0 + i;
      }
      ++rank;
    }
  }
}

// The pads past the match count (value 0, position -1) and agg, given
// the aggregates over every match; thread tid of n_threads.
__device__ __forceinline__ void scan_finish(const ScanAgg& t, int cap,
                                            int32_t* __restrict__ out,
                                            int tid, int n_threads) {
  for (int r = t.cnt + tid; r < cap; r += n_threads) {
    out[r] = 0;
    out[cap + r] = -1;
  }
  if (tid == 0) {
    out[2 * cap] = t.cnt;
    out[2 * cap + 1] = static_cast<int32_t>(t.sum);
    out[2 * cap + 2] = t.mn;
    out[2 * cap + 3] = t.mx;
  }
}

// The single-CTA scan of m <= kT * kIpt positions.
template <int kT, int kIpt>
__global__ void __launch_bounds__(kT) scan_prune_kernel(
    const int32_t* __restrict__ src, int n_src,
    const int32_t* __restrict__ idx, int m, int32_t lo, int32_t hi, int cap,
    int vec, int32_t* __restrict__ out) {
  using BlockScan = cub::BlockScan<int, kT>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ ScanAgg s_warp[kT / 32];
  int32_t v[kIpt];
  bool hit[kIpt];
  const int p0 = threadIdx.x * kIpt;              // blocked: stream order
  scan_load<kIpt>(src, n_src, idx, m, p0, vec, lo, hi, v, hit);
  const ScanAgg a = thread_agg<kIpt>(v, hit);
  int rank;
  BlockScan(scan_tmp).ExclusiveSum(a.cnt, rank);
  scan_write<kIpt>(v, hit, rank, p0, cap, out);
  scan_finish(block_agg<kT>(a, s_warp), cap, out, threadIdx.x, kT);
}

// Large-M pass 1: each tile's (count, sum, min, max) to scratch[4 b ..].
__global__ void __launch_bounds__(kLargeT) scan_block_agg_kernel(
    const int32_t* __restrict__ src, int n_src,
    const int32_t* __restrict__ idx, int m, int32_t lo, int32_t hi, int vec,
    int32_t* __restrict__ scratch) {
  __shared__ ScanAgg s_warp[kLargeT / 32];
  int32_t v[kLargeIpt];
  bool hit[kLargeIpt];
  const int p0 = blockIdx.x * kLargeTile + threadIdx.x * kLargeIpt;
  scan_load<kLargeIpt>(src, n_src, idx, m, p0, vec, lo, hi, v, hit);
  const ScanAgg t = block_agg<kLargeT>(thread_agg<kLargeIpt>(v, hit), s_warp);
  if (threadIdx.x == 0) {
    int32_t* s = scratch + 4 * blockIdx.x;
    s[0] = t.cnt;
    s[1] = static_cast<int32_t>(t.sum);
    s[2] = t.mn;
    s[3] = t.mx;
  }
}

// Large-M pass 2: block b's offset is the count of tiles 0 .. b - 1;
// while it is below cap, the block reloads its tile, ranks its matches
// into shared memory and writes those below cap as one contiguous run
// (coalesced).  Block 0 folds all n_tiles tiles into agg and writes the
// pads past the total count.
__global__ void __launch_bounds__(kLargeT) scan_block_write_kernel(
    const int32_t* __restrict__ src, int n_src,
    const int32_t* __restrict__ idx, int m, int32_t lo, int32_t hi, int cap,
    int vec, const int32_t* __restrict__ scratch, int n_tiles,
    int32_t* __restrict__ out) {
  using BlockScan = cub::BlockScan<int, kLargeT>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ ScanAgg s_warp[kLargeT / 32];
  __shared__ int32_t s_val[kLargeTile], s_pos[kLargeTile];   // 32 KB
  const int b = blockIdx.x, tid = threadIdx.x;
  const int upto = b == 0 ? n_tiles : b;
  ScanAgg a = scan_agg_empty();
  for (int k = tid; k < upto; k += kLargeT) {
    const int32_t* s = scratch + 4 * k;
    scan_fold(a, s[0], static_cast<uint32_t>(s[1]), s[2], s[3]);
  }
  const ScanAgg before = block_agg<kLargeT>(a, s_warp);
  if (b == 0) scan_finish(before, cap, out, tid, kLargeT);
  const int offset = b == 0 ? 0 : before.cnt;
  if (offset >= cap) return;                       // uniform per block
  int32_t v[kLargeIpt];
  bool hit[kLargeIpt];
  const int p0 = b * kLargeTile + tid * kLargeIpt;
  scan_load<kLargeIpt>(src, n_src, idx, m, p0, vec, lo, hi, v, hit);
  const ScanAgg mine = thread_agg<kLargeIpt>(v, hit);
  int rank, total;
  BlockScan(scan_tmp).ExclusiveSum(mine.cnt, rank, total);
#pragma unroll
  for (int i = 0; i < kLargeIpt; ++i) {
    if (hit[i]) {
      s_val[rank] = v[i];
      s_pos[rank] = p0 + i;
      ++rank;
    }
  }
  __syncthreads();
  const int n_out = min(total, cap - offset);
  for (int r = tid; r < n_out; r += kLargeT) {
    out[offset + r] = s_val[r];
    out[cap + offset + r] = s_pos[r];
  }
}

}  // namespace

extern "C" {

// Every *_launch entry point launches on `device`, the CUDA device of its
// tensors (a DeviceScope, ../../csrc/device_scope.cuh), on `stream`, a
// stream of that device.

// Applies n instructions to regs[n_slots] in place.  sorted_slot holds the
// stream's clamped slots (n_slots for a NOP) in stable-sorted order and
// perm the stream position of each sorted entry.  Returns
// cudaGetLastError() after the launch.
int switch_txn_launch(int device, void* regs, int n_slots, const void* op,
                      const void* val, const void* sorted_slot,
                      const void* perm, void* res, void* ok, int n,
                      void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
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

// The dynamic shared memory, in bytes, of switch_txn_smem_launch's block
// for an n-instruction stream; 0 when n is outside 1..kSmemMaxN.
int switch_txn_smem_bytes(int n) {
  if (n < 1 || n > kSmemMaxN) return 0;
  if (n <= 256) return static_cast<int>(SmemTile<256, 1>::kBytes);
  if (n <= 1024) return static_cast<int>(SmemTile<256, 4>::kBytes);
  if (n <= 4096) return static_cast<int>(SmemTile<512, 8>::kBytes);
  return static_cast<int>(SmemTile<512, 16>::kBytes);
}

// One hot dispatch in one launch: applies n (1 <= n <= kSmemMaxN)
// instructions, slot stage * R + reg, to regs[n_slots] in place, writes
// res[n] int32 and ok[n] bytes, and compact[j] = res[clamp(idx[j], 0,
// n - 1)] for j < m (m may be 0, idx and compact then unused).  Returns
// cudaErrorInvalidValue without launching on bad sizes, else
// cudaGetLastError() after the launch.
int switch_txn_smem_launch(int device, void* regs, int n_slots, int R,
                           const void* op, const void* stage,
                           const void* reg, const void* val, int n,
                           void* res, void* ok, const void* idx,
                           void* compact, int m, void* stream) {
  if (n < 1 || n > kSmemMaxN || n_slots < 1 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_in = a16(op) && a16(stage) && a16(reg) && a16(val);
  const int vec_out = a16(res) && reinterpret_cast<uintptr_t>(ok) % 4 == 0;
  const int end_bit = 32 - __builtin_clz(static_cast<unsigned>(n_slots));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* r = static_cast<int32_t*>(regs);
  const int32_t* o = static_cast<const int32_t*>(op);
  const int32_t* st = static_cast<const int32_t*>(stage);
  const int32_t* rg = static_cast<const int32_t*>(reg);
  const int32_t* v = static_cast<const int32_t*>(val);
  int32_t* out = static_cast<int32_t*>(res);
  uint8_t* okp = static_cast<uint8_t*>(ok);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* cp = static_cast<int32_t*>(compact);
  cudaError_t err;
  if (n <= 256)
    err = launch_smem<256, 1>(device, r, n_slots, R, o, st, rg, v, n,
                              end_bit, vec_in, out, okp, vec_out, ix, cp,
                              m, s);
  else if (n <= 1024)
    err = launch_smem<256, 4>(device, r, n_slots, R, o, st, rg, v, n,
                              end_bit, vec_in, out, okp, vec_out, ix, cp,
                              m, s);
  else if (n <= 4096)
    err = launch_smem<512, 8>(device, r, n_slots, R, o, st, rg, v, n,
                              end_bit, vec_in, out, okp, vec_out, ix, cp,
                              m, s);
  else
    err = launch_smem<512, 16>(device, r, n_slots, R, o, st, rg, v, n,
                               end_bit, vec_in, out, okp, vec_out, ix, cp, m,
                               s);
  return static_cast<int>(err);
}

// out[i] = src[clamp(idx[i], 0, n_src - 1)] for i < m.  Returns
// cudaGetLastError() after the launch.
int result_gather_launch(int device, const void* src, int n_src,
                         const void* idx, void* out, int m, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  const int blocks = (m + kThreads - 1) / kThreads;
  result_gather_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), n_src,
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// The int32 count of the scratch buffer scan_prune_large_launch needs
// for an m-position stream: four per tile of 4,096; 0 for m <= 16,384,
// which the single-CTA scan_prune_launch takes.
int scan_prune_scratch_len(int m) {
  return m > kScanSmemMaxM ? 4 * ((m + kLargeTile - 1) / kLargeTile) : 0;
}

// One pruned scan of m (0 <= m <= 16,384) positions in one launch of the
// single-CTA kernel: v[j] = src[clamp(idx[j], 0, n_src - 1)], or src[j]
// when idx is null; the first cap matches of lo <= v <= hi in stream
// order and (count, sum, min, max) over all matches are written to
// out[2 cap + 4] = vals[cap] | pos[cap] | agg[4], every word of it.
// Returns cudaErrorInvalidValue without launching on bad sizes, else
// cudaGetLastError() after the launch.
int scan_prune_launch(int device, const void* src, int n_src,
                      const void* idx, int m, int lo, int hi, int cap,
                      void* out, void* stream) {
  if (m < 0 || m > kScanSmemMaxM || cap < 0 || (idx != nullptr && n_src < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  const int vec =
      reinterpret_cast<uintptr_t>(idx != nullptr ? idx : src) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  int32_t* op = static_cast<int32_t*>(out);
  if (m <= 512)
    scan_prune_kernel<128, 4><<<1, 128, 0, s>>>(sp, n_src, ip, m, lo, hi,
                                                cap, vec, op);
  else if (m <= 2048)
    scan_prune_kernel<256, 8><<<1, 256, 0, s>>>(sp, n_src, ip, m, lo, hi,
                                                cap, vec, op);
  else if (m <= 4096)
    scan_prune_kernel<512, 8><<<1, 512, 0, s>>>(sp, n_src, ip, m, lo, hi,
                                                cap, vec, op);
  else
    scan_prune_kernel<1024, 16><<<1, 1024, 0, s>>>(sp, n_src, ip, m, lo, hi,
                                                   cap, vec, op);
  return static_cast<int>(cudaGetLastError());
}

// The same scan for m > 16,384 positions in two launches over tiles of
// 4,096; scratch holds scratch_len int32, at least
// scan_prune_scratch_len(m) (else cudaErrorInvalidValue, nothing
// launched).  Returns the first non-zero cudaGetLastError() of the two.
int scan_prune_large_launch(int device, const void* src, int n_src,
                            const void* idx, int m, int lo, int hi, int cap,
                            void* out, void* scratch, int scratch_len,
                            void* stream) {
  if (m <= kScanSmemMaxM || cap < 0 || (idx != nullptr && n_src < 1) ||
      scratch_len < scan_prune_scratch_len(m))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  const int vec =
      reinterpret_cast<uintptr_t>(idx != nullptr ? idx : src) % 16 == 0;
  const int tiles = (m + kLargeTile - 1) / kLargeTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  int32_t* sc = static_cast<int32_t*>(scratch);
  scan_block_agg_kernel<<<tiles, kLargeT, 0, s>>>(sp, n_src, ip, m, lo, hi,
                                                  vec, sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_write_kernel<<<tiles, kLargeT, 0, s>>>(
      sp, n_src, ip, m, lo, hi, cap, vec, sc, tiles,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
