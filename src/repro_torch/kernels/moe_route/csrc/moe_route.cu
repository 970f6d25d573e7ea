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
// It serves route's large path (n > kPlanMaxN or E > kPlanMaxE), after a
// torch.argsort, and the tests.
//
// moe_plan: replaces the same moe_route.py:24 (_kernel) together with
// what repro/models/moe.py:41-59 (route) does around it: the stable sort
// of the expert ids by expert, the positions, and the admission plan.
// From the unsorted ids[n] (arrival order) it writes, in sorted order,
// order[j] (the arrival position), slot[j] = admit ? id * C + pos : E * C,
// admit[j] = pos < C (bytes, torch.bool) and tok[j] = order[j] / top_k,
// where pos is the entry's place in its expert's run.  What bounds it on
// the H100: not bytes (13 n bytes, 0.06 us at n = 16,384) but the
// launch and the block-wide sort on one SM; the parent's chain spent a
// dozen launches (argsort's radix passes, a gather, moe_route, the
// compare, the where, the divide and the casts).  So for n <= kPlanMaxN
// and E <= kPlanMaxE one block does it all in shared memory:
//   1. a blocked load, thread t holding positions t * kIpt + i; the key
//      packs (expert << 14) | position; pads (positions >= n) take expert
//      E - 1 and sort after every real entry; an id outside [0, E) is
//      clamped to E - 1 (the plan is then unspecified, no access is out
//      of bounds; route never makes one);
//   2. a stable cub::BlockRadixSort of the keys over the expert's
//      bit_length(E - 1) bits only, bits 14 and up (7 bits, two 4-bit
//      passes, at E = 128; none at E = 1): the input is blocked in stream
//      order, so equal experts keep arrival order, and the position rides
//      in the low bits, so no value array is exchanged;
//   3. each expert's offset is the sorted index of its run's head, found
//      by comparing a key with its neighbour in shared memory; this is
//      the exclusive scan of the expert histogram without a histogram's
//      shared-memory atomics (a hot expert would serialize them) and
//      without a search: pos = j - offset[expert];
//   4. the plan, written in striped order (coalesced).
// Batched (moe_plan_streams_launch): S independent streams of n ids each,
// ids[S][n] row-major, in ONE launch of S blocks, blockIdx.x the stream:
// block s plans ids[s] into row s of each output with its own expert
// offsets, and order, slot and tok are relative to the stream.  This is
// the reference's vmap of route over S arbitration shards
// (repro/models/moe.py:91, moe_ffn_sharded), which runs moe_route_call
// once per shard.  The streams share nothing, so each block is the
// single-stream kernel on its row; at Qwen3-MoE training's 2 x 16,384
// or 4 x 8,192 ids the blocks run on 2 or 4 SMs at once.  S = 1 is
// moe_plan_launch.
// The tile is the smallest of 256, 1,024, 4,096 or 16,384 entries that
// holds n (128 x 2, 256 x 4, 512 x 8, 1024 x 16 threads x items).  Shared
// memory: the sort's storage, reused for the sorted keys, plus E int32
// offsets (kPlanMaxE = 4,096 caps E at 16 KB).  ptxas -v on sm_90a, as
// chip_smoke.py prints it: 30 / 40 / 56 / 64 registers for the 256 /
// 1,024 / 4,096 / 16,384 tiles (the last spills 60 bytes).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanMaxN = 16384;    // the longest stream moe_plan takes
constexpr int kPlanMaxE = 4096;     // the most experts its offsets hold
constexpr int kPosBits = 14;        // a tile position in a sort key
static_assert(kPlanMaxN <= (1 << kPosBits), "positions fit the key");

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

// moe_plan's shared memory for a tile of kT x kIpt entries: the sort's
// storage, reused for the sorted keys, then the experts' offsets.
template <int kT, int kIpt>
struct PlanTile {
  static constexpr int kTile = kT * kIpt;
  using Sort = cub::BlockRadixSort<uint32_t, kT, kIpt>;
  static constexpr size_t kSortBytes = sizeof(typename Sort::TempStorage);
  static constexpr size_t kKeyBytes = size_t(kTile) * 4;
  static constexpr size_t kUnion =
      ((kSortBytes > kKeyBytes ? kSortBytes : kKeyBytes) + 15) / 16 * 16;
};

template <int kT, int kIpt>
__global__ void __launch_bounds__(kT) moe_plan_kernel(
    const int32_t* __restrict__ ids, int n, int n_experts, int capacity,
    int top_k, int end_bit, int32_t* __restrict__ order,
    int32_t* __restrict__ slot, uint8_t* __restrict__ admit,
    int32_t* __restrict__ tok) {
  using Tile = PlanTile<kT, kIpt>;
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's stream: row blockIdx.x of ids and of every output
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  ids += row;
  order += row;
  slot += row;
  admit += row;
  tok += row;
  auto& sort_tmp =
      *reinterpret_cast<typename Tile::Sort::TempStorage*>(smem);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem);  // after the sort
  int32_t* s_first = reinterpret_cast<int32_t*>(smem + Tile::kUnion);
  const int tid = threadIdx.x;
  const uint32_t top = static_cast<uint32_t>(n_experts - 1);
  constexpr uint32_t kPosMask = (1u << kPosBits) - 1;

  // 1. keys (expert << 14) | position, blocked
  uint32_t keys[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int p = tid * kIpt + i;
    const uint32_t e =
        p < n ? min(static_cast<uint32_t>(__ldg(ids + p)), top) : top;
    keys[i] = (e << kPosBits) | static_cast<uint32_t>(p);
  }
  // 2. stable sort by expert; the output is striped (index i * kT + tid)
  if (end_bit > kPosBits) {
    using Sort = typename Tile::Sort;
    Sort(sort_tmp).SortBlockedToStriped(keys, kPosBits, end_bit);
  } else {                              // one expert: already in order
#pragma unroll
    for (int i = 0; i < kIpt; ++i)
      keys[i] = static_cast<uint32_t>(i * kT + tid);
  }
  __syncthreads();                      // s_key overlays sort_tmp
#pragma unroll
  for (int i = 0; i < kIpt; ++i) s_key[i * kT + tid] = keys[i];
  __syncthreads();

  // 3. each run's head records its sorted index as its expert's offset
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int j = i * kT + tid;
    const uint32_t e = keys[i] >> kPosBits;
    if (j < n && (j == 0 || (s_key[j - 1] >> kPosBits) != e))
      s_first[e] = j;
  }
  __syncthreads();

  // 4. the plan in sorted order
  const int32_t dropped = n_experts * capacity;
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int j = i * kT + tid;
    if (j < n) {
      const uint32_t e = keys[i] >> kPosBits;
      const int32_t p = static_cast<int32_t>(keys[i] & kPosMask);
      const int32_t pos = j - s_first[e];
      const bool adm = pos < capacity;
      order[j] = p;
      slot[j] = adm ? static_cast<int32_t>(e) * capacity + pos : dropped;
      admit[j] = adm ? 1 : 0;
      tok[j] = p / top_k;
    }
  }
}

// One launch of moe_plan_kernel at tile kT x kIpt, one block per stream;
// raises the block's dynamic shared-memory limit once per device.
template <int kT, int kIpt>
cudaError_t launch_plan(const int32_t* ids, int n_streams, int n,
                        int n_experts, int capacity, int top_k, int end_bit,
                        int32_t* order, int32_t* slot, uint8_t* admit,
                        int32_t* tok, cudaStream_t s) {
  using Tile = PlanTile<kT, kIpt>;
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(
        moe_plan_kernel<kT, kIpt>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tile::kUnion + 4 * kPlanMaxE));
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const int bytes = static_cast<int>(Tile::kUnion) + 4 * n_experts;
  moe_plan_kernel<kT, kIpt><<<n_streams, kT, bytes, s>>>(
      ids, n, n_experts, capacity, top_k, end_bit, order, slot, admit, tok);
  return cudaGetLastError();
}

static_assert(PlanTile<1024, 16>::kTile == kPlanMaxN, "largest tile");
static_assert(PlanTile<1024, 16>::kUnion + 4 * kPlanMaxE <= 232448,
              "the largest tile fits in a block's shared memory");

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

// The routing plans of n_streams (1 .. 65,535) streams of n (1 <= n <=
// 16,384) expert ids each, ids[n_streams][n] in arrival order, over
// n_experts (1 .. 4,096) experts at capacity C, in one launch of one
// block per stream: order, slot and tok int32 [n_streams][n] and admit
// bytes [n_streams][n], each row in its stream's stable expert-sorted
// order and relative to its stream.  Returns cudaErrorInvalidValue
// without launching on bad sizes (or n_experts * capacity past int32),
// else cudaGetLastError() after the launch.
int moe_plan_streams_launch(const void* ids, int n_streams, int n,
                            int n_experts, int capacity, int top_k,
                            void* order, void* slot, void* admit, void* tok,
                            void* stream) {
  if (n_streams < 1 || n_streams > 65535 || n < 1 || n > kPlanMaxN ||
      n_experts < 1 || n_experts > kPlanMaxE || capacity < 0 || top_k < 1 ||
      static_cast<long long>(n_experts) * capacity > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int end_bit =
      kPosBits + (n_experts > 1
                      ? 32 - __builtin_clz(static_cast<unsigned>(n_experts - 1))
                      : 0);
  const int32_t* in = static_cast<const int32_t*>(ids);
  int32_t* o = static_cast<int32_t*>(order);
  int32_t* sl = static_cast<int32_t*>(slot);
  uint8_t* a = static_cast<uint8_t*>(admit);
  int32_t* t = static_cast<int32_t*>(tok);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n_streams;
  cudaError_t err;
  if (n <= 256)
    err = launch_plan<128, 2>(in, S, n, n_experts, capacity, top_k, end_bit,
                              o, sl, a, t, s);
  else if (n <= 1024)
    err = launch_plan<256, 4>(in, S, n, n_experts, capacity, top_k, end_bit,
                              o, sl, a, t, s);
  else if (n <= 4096)
    err = launch_plan<512, 8>(in, S, n, n_experts, capacity, top_k, end_bit,
                              o, sl, a, t, s);
  else
    err = launch_plan<1024, 16>(in, S, n, n_experts, capacity, top_k,
                                end_bit, o, sl, a, t, s);
  return static_cast<int>(err);
}

// The routing plan of one stream: moe_plan_streams_launch at n_streams = 1.
int moe_plan_launch(const void* ids, int n, int n_experts, int capacity,
                    int top_k, void* order, void* slot, void* admit,
                    void* tok, void* stream) {
  return moe_plan_streams_launch(ids, 1, n, n_experts, capacity, top_k,
                                 order, slot, admit, tok, stream);
}

}  // extern "C"
