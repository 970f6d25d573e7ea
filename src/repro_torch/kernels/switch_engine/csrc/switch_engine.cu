// Hopper (sm_90a) kernels of the switch engines of auto mode, behind a plain
// C interface loaded with ctypes (see ../../build.py).
//
// What they replace.  Not Pallas kernels: the reference's three compiled
// XLA programs of repro/core/engine.py, each run as ONE device program per
// dispatch with the result compaction fused in (_fused_engine_impl :232):
//   serial (_serial_engine_impl :98)  a lax.scan over the stream, every
//                                      opcode, CADD and ADDP included;
//   staged (_staged_engine_impl :132) an affine pass per stage, ADDP
//                                      operands forwarded from earlier stages;
//   affine (_affine_engine_impl :170) a segmented associative scan over the
//                                      slot-sorted stream, {NOP, READ, WRITE,
//                                      ADD}.
// The three differ in the order they visit instructions and in how a slot
// names a register; all three reduce to one walk over per-instruction slot
// entries, so one kernel with a per-mode slot rule serves them.
//
// The slot rules (the reference's on every slot; JAX wraps a negative
// index once by the array's length, then clamps a read and drops a write):
//   every mode: g = stage * R + reg with int32 wraparound; NOP answers
//     (0, ok 1); sums wrap to int32; an opcode the mode does not execute
//     reads.
//   serial: a = g + S*R if g < 0 else g; the entry is the register
//     clamp(a, 0, S*R - 1), shared by every instruction that names it (so
//     a read past the file sees this stream's earlier writes to the last
//     slot); a write is kept only when a lies in the file.  Visited in
//     stream order; ADDP adds res[row + clamp(v, 0, K-1)] as it stands (0
//     before the source ran); CADD keeps the value when post < 0, ok =
//     post >= 0, answers the new value.
//   affine: one chain per distinct g (NOPs keyed S*R), seeded from the
//     pre-batch register clamp(g + S*R if g < 0 else g); written back to g
//     when 0 <= g < S*R, to g + S*R + 1 when that lies in the file and g <
//     0 (the reference's write-back buffer has one extra slot), where a
//     chain of the same slot wins; never for g >= S*R.
//   staged: an instruction runs only at a stage in [0, S); its chain is
//     (stage, reg) under the affine rule on that stage's row of R slots.
//     ADDP adds its source's result when the source's stage is earlier
//     (in [0, own stage)), else 0, then acts as ADD.
// Chains of different stages never share a register and an ADDP reads
// only finished stages, so the staged walk may take the chains in key
// order (stage-major) just as affine does.
//
// switch_walk_smem (one CTA, N <= kWalkSmemMax): the whole dispatch in
// shared memory.
//   1. prologue, block-wide: each instruction's 64-bit key under the
//      mode's rule (serial: the clamped slot; affine: g with its sign bit
//      flipped; staged: stage << 32 | flipped reg; every NOP, idle staged
//      instruction and tile pad gets the mode's sentinel key, which is
//      never written back), opcode and flags (serial write-enable, staged
//      forward), operand (ADDP: its source's position), and the seed, the
//      pre-batch register its chain starts from;
//   2. a stable cub::BlockRadixSort of (key, position) over the mode's key
//      bits (serial bit_length(S*R), affine 32, staged 32 +
//      bit_length(S)); the sorted keys stay in shared memory;
//   3. serial only: each instruction's entry, the stream position of its
//      run's head (a binary search of the sorted keys);
//   4. the walk, by ONE thread: serial in stream order over the entries;
//      affine and staged over the sorted runs with the chain's value in a
//      register, the final value left at the head;
//   5. write-back by the run heads (affine and staged: the chains of
//      negative g first, then the others, so a chain of the slot itself
//      wins), res, ok and compact[j] = res[clamp(idx[j], 0, N-1)].
// Shared memory per tile instruction: operand, seed/entry value and result
// (12 B), entry and sorted position (4 B), opcode then ok (1 B), and a
// region that holds CUB's sort storage, then the sorted 64-bit keys
// (max(sort storage, 8 B)): 206,848 bytes at the 8,192 tile.
// kWalkSmemMax = 8,192 is the largest power of two that fits in 227 KB.
// Tiles: 32 x 1, 256 x 1, 256 x 4, 512 x 8, 512 x 16 threads x items.
// What bounds it: not bytes (a B = 256, K = 16 group moves ~80 KB, 0.03 us
// at 3.35 TB/s) but the single-thread walk, a few dependent shared-memory
// reads per instruction, and the block sort; the walk is not parallelised
// here (chip_smoke.py phase 21 times it; PERF.md has the numbers).
//
// switch_walk (the large route, N > kWalkSmemMax): the same steps in
// device memory.  switch_walk_prep_kernel computes keys, seeds, opcodes
// and operands (one thread an instruction); the wrapper stable-sorts the
// keys with torch.sort; switch_walk_launch then runs the link kernel
// (serial entries), the walk on one thread of one block, and the
// write-back kernel twice (negative chains, then the rest); the wrapper
// compacts with result_gather.  Nothing waits on the host.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int32_t kNop = 0, kRead = 1, kWrite = 2, kAdd = 3, kCadd = 4,
                  kAddp = 5;
constexpr int kSerial = 0, kStaged = 1, kAffine = 2;
constexpr uint8_t kCode = 0x7, kWen = 0x40, kFwd = 0x80;
constexpr uint32_t kSign = 0x80000000u;
constexpr int kWalkSmemMax = 8192;
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The key a NOP, an idle staged instruction or a tile pad takes: sorts
// with (or after) the chains that are never written back.
__device__ __forceinline__ uint64_t sentinel_key(int mode, int S, int R) {
  const int64_t n_slots = int64_t(S) * R;
  if (mode == kSerial) return static_cast<uint64_t>(n_slots);
  if (mode == kAffine)
    return static_cast<uint64_t>(static_cast<uint32_t>(n_slots) ^ kSign);
  return static_cast<uint64_t>(S) << 32;
}

struct Prep {
  uint64_t key;
  int64_t seed;     // the register the chain starts from, -1 for none
  uint8_t opf;      // opcode class | kWen | kFwd
  int32_t vq;       // operand; an ADDP's source position
};

// Step 1 for instruction p of the [n / K, K] stream.
__device__ Prep prep_one(int mode, int p, int S, int R, int K,
                         const int32_t* __restrict__ op,
                         const int32_t* __restrict__ stage,
                         const int32_t* __restrict__ reg,
                         const int32_t* __restrict__ val) {
  const int64_t n_slots = int64_t(S) * R;
  const int32_t o = op[p], st = stage[p], rg = reg[p], v = val[p];
  int32_t code = (o >= kNop && o <= kAddp) ? o : kRead;
  Prep out{sentinel_key(mode, S, R), -1, 0, v};
  const int32_t g = static_cast<int32_t>(
      static_cast<uint32_t>(st) * static_cast<uint32_t>(R) +
      static_cast<uint32_t>(rg));
  const int row = p - p % K;
  if (mode == kSerial) {
    if (code == kNop) return out;
    const int64_t a = g < 0 ? int64_t(g) + n_slots : int64_t(g);
    const int64_t slot = clamp64(a, 0, n_slots - 1);
    out.key = static_cast<uint64_t>(slot);
    out.seed = slot;
    out.opf = static_cast<uint8_t>(code | (a >= 0 && a < n_slots ? kWen : 0));
    if (code == kAddp) out.vq = row + (v < 0 ? 0 : (v > K - 1 ? K - 1 : v));
    return out;
  }
  if (mode == kAffine) {
    if (code == kNop) {                 // the chain of g = S*R: its seed
      out.seed = n_slots - 1;
      return out;
    }
    if (code != kWrite && code != kAdd) code = kRead;
    out.key = static_cast<uint64_t>(static_cast<uint32_t>(g) ^ kSign);
    out.seed = clamp64(g < 0 ? int64_t(g) + n_slots : int64_t(g), 0,
                       n_slots - 1);
    out.opf = static_cast<uint8_t>(code);
    return out;
  }
  // staged
  if (code == kNop || st < 0 || st >= S) return out;
  if (code != kWrite && code != kAdd && code != kAddp) code = kRead;
  out.key = (static_cast<uint64_t>(st) << 32) |
            (static_cast<uint32_t>(rg) ^ kSign);
  out.seed = int64_t(st) * R +
             clamp64(rg < 0 ? int64_t(rg) + R : int64_t(rg), 0, R - 1);
  uint8_t flags = 0;
  if (code == kAddp) {
    const int q = row + (v < 0 ? 0 : (v > K - 1 ? K - 1 : v));
    const int32_t sq = stage[q];
    if (sq >= 0 && sq < st) flags = kFwd;
    out.vq = q;
  }
  out.opf = static_cast<uint8_t>(code | flags);
  return out;
}

// The register a chain of key ``key`` is written back to in phase
// ``phase`` (0: the chains of a negative slot, 1: the rest), or -1.
__device__ __forceinline__ int64_t writeback_slot(int mode, uint64_t key,
                                                  int phase, int S, int R) {
  const int64_t n_slots = int64_t(S) * R;
  if (mode == kSerial)
    return (phase == 1 && key < static_cast<uint64_t>(n_slots))
               ? static_cast<int64_t>(key) : -1;
  int64_t file = n_slots, base = 0;
  if (mode == kStaged) {
    const uint64_t s = key >> 32;
    if (s >= static_cast<uint64_t>(S)) return -1;
    file = R;
    base = static_cast<int64_t>(s) * R;
  }
  const int32_t g = static_cast<int32_t>(static_cast<uint32_t>(key) ^ kSign);
  if (g >= 0) return (phase == 1 && g < file) ? base + g : -1;
  const int64_t t = int64_t(g) + file + 1;
  return (phase == 0 && t >= 0 && t < file) ? base + t : -1;
}

// First index in skey[0, n) whose key is >= k.
__device__ __forceinline__ int lower_bound(const uint64_t* skey, int n,
                                           uint64_t k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (skey[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Step 4, on one thread.  Generic pointers: shared memory on the
// single-CTA route, device memory on the large one; ok may alias opf (each
// opcode is read before its ok is written).  res must hold 0 everywhere.
// cur holds each instruction's seed; serial updates the entry (the head's
// slot of cur) in place, affine and staged leave each chain's final value
// at its head.  Positions >= n (tile pads) are skipped.
template <typename PosT, typename EntT>
__device__ void walk(int mode, int n_sorted, int n, const uint8_t* opf,
                     const int32_t* vq, int32_t* cur, int32_t* res,
                     uint8_t* ok, const uint64_t* skey, const PosT* spos,
                     const EntT* ent) {
  if (mode == kSerial) {
#pragma unroll 1
    for (int p = 0; p < n; ++p) {
      const uint8_t f = opf[p];
      const int32_t code = f & kCode;
      if (code == kNop) {
        ok[p] = 1;
        continue;
      }
      const int e = static_cast<int>(ent[p]);
      const int32_t v = vq[p];
      const int32_t c = cur[e];
      const int32_t post = wrap_add(c, code == kAddp ? res[v] : v);
      const bool cadd_ok = post >= 0;
      int32_t next = c;
      if (code == kWrite) next = v;
      else if (code == kAdd || code == kAddp || (code == kCadd && cadd_ok))
        next = post;
      res[p] = code == kRead ? c : next;
      ok[p] = (code == kCadd && !cadd_ok) ? 0 : 1;
      if (f & kWen) cur[e] = next;
    }
    return;
  }
  int head = -1;
  uint64_t chain = 0;
  int32_t c = 0;
#pragma unroll 1
  for (int j = 0; j < n_sorted; ++j) {
    const int p = static_cast<int>(spos[j]);
    if (p >= n) continue;
    const uint64_t k = skey[j];
    if (head < 0 || k != chain) {
      if (head >= 0) cur[head] = c;
      head = p;
      chain = k;
      c = cur[p];
    }
    const uint8_t f = opf[p];
    const int32_t code = f & kCode;
    const int32_t v = vq[p];
    if (code == kWrite) c = v;
    else if (code == kAdd) c = wrap_add(c, v);
    else if (code == kAddp) c = wrap_add(c, (f & kFwd) ? res[v] : 0);
    res[p] = code == kNop ? 0 : c;
    ok[p] = 1;
  }
  if (head >= 0) cur[head] = c;
}

// The single-CTA route's shared-memory layout for a tile of kT x kIpt
// instructions (the byte budget is in the note above).
template <int kT, int kIpt>
struct WalkTile {
  static constexpr int kTile = kT * kIpt;
  using BlockSort = cub::BlockRadixSort<uint64_t, kT, kIpt, uint32_t>;
  static constexpr size_t kSortBytes =
      sizeof(typename BlockSort::TempStorage);
  static constexpr size_t kKeyBytes = size_t(kTile) * 8;
  static constexpr size_t kUnion =
      ((kSortBytes > kKeyBytes ? kSortBytes : kKeyBytes) + 15) / 16 * 16;
  static constexpr size_t kBytes = kUnion + size_t(kTile) * 17;
};

template <int kT, int kIpt>
__global__ void __launch_bounds__(kT) switch_walk_smem_kernel(
    int mode, int32_t* __restrict__ regs, int S, int R, int K,
    const int32_t* __restrict__ op, const int32_t* __restrict__ stage,
    const int32_t* __restrict__ reg, const int32_t* __restrict__ val, int n,
    int end_bit, int32_t* __restrict__ res, uint8_t* __restrict__ ok,
    const int32_t* __restrict__ idx, int32_t* __restrict__ compact, int m) {
  using Tile = WalkTile<kT, kIpt>;
  constexpr int kTile = Tile::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sort_tmp =
      *reinterpret_cast<typename Tile::BlockSort::TempStorage*>(smem);
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);   // after the sort
  int32_t* s_vq = reinterpret_cast<int32_t*>(smem + Tile::kUnion);
  int32_t* s_cur = s_vq + kTile;
  int32_t* s_res = s_cur + kTile;
  uint16_t* s_ent = reinterpret_cast<uint16_t*>(s_res + kTile);
  uint16_t* s_spos = s_ent + kTile;
  uint8_t* s_opf = reinterpret_cast<uint8_t*>(s_spos + kTile);  // then ok
  const int tid = threadIdx.x;

  // 1. prologue: blocked (thread t holds positions t * kIpt ..), every
  // seed fetch in flight at once
  uint64_t keys[kIpt];
  uint32_t pos[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int p = tid * kIpt + i;
    pos[i] = static_cast<uint32_t>(p);
    if (p < n) {
      const Prep pr = prep_one(mode, p, S, R, K, op, stage, reg, val);
      keys[i] = pr.key;
      s_opf[p] = pr.opf;
      s_vq[p] = pr.vq;
      s_cur[p] = pr.seed >= 0 ? regs[pr.seed] : 0;
    } else {
      keys[i] = sentinel_key(mode, S, R);
      s_opf[p] = 0;
      s_vq[p] = 0;
      s_cur[p] = 0;
    }
    s_res[p] = 0;
  }

  // 2. stable sort of (key, position): blocked in, blocked out
  using BlockSort = typename Tile::BlockSort;
  BlockSort(sort_tmp).Sort(keys, pos, 0, end_bit);
  __syncthreads();                      // s_key overlays sort_tmp
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    s_key[tid * kIpt + i] = keys[i];
    s_spos[tid * kIpt + i] = static_cast<uint16_t>(pos[i]);
  }
  __syncthreads();

  // 3. serial: each instruction's entry is its run head's position
  if (mode == kSerial) {
    for (int j = tid; j < kTile; j += kT) {
      const int h = lower_bound(s_key, kTile, s_key[j]);
      s_ent[s_spos[j]] = s_spos[h];
    }
    __syncthreads();
  }

  // 4. the walk
  if (tid == 0)
    walk<uint16_t, uint16_t>(mode, kTile, n, s_opf, s_vq, s_cur, s_res, s_opf,
                             s_key, s_spos, s_ent);
  __syncthreads();

  // 5. write-back by the run heads, in two phases; then res, ok, compact
  for (int phase = mode == kSerial ? 1 : 0; phase < 2; ++phase) {
    for (int j = tid; j < kTile; j += kT) {
      const int p = s_spos[j];
      if (p >= n || (j > 0 && s_key[j - 1] == s_key[j])) continue;
      const int64_t t = writeback_slot(mode, s_key[j], phase, S, R);
      if (t >= 0) regs[t] = s_cur[p];
    }
    __syncthreads();
  }
  for (int p = tid; p < n; p += kT) {
    res[p] = s_res[p];
    ok[p] = s_opf[p];
  }
  for (int q = tid; q < m; q += kT) {
    int32_t k = idx[q];
    k = k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
    compact[q] = s_res[k];
  }
}

template <int kT, int kIpt>
cudaError_t launch_smem(int mode, int32_t* regs, int S, int R, int K,
                        const int32_t* op, const int32_t* stage,
                        const int32_t* reg, const int32_t* val, int n,
                        int end_bit, int32_t* res, uint8_t* ok,
                        const int32_t* idx, int32_t* compact, int m,
                        cudaStream_t s) {
  static std::atomic<unsigned> configured{0};
  constexpr int bytes = static_cast<int>(WalkTile<kT, kIpt>::kBytes);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(switch_walk_smem_kernel<kT, kIpt>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  switch_walk_smem_kernel<kT, kIpt><<<1, kT, bytes, s>>>(
      mode, regs, S, R, K, op, stage, reg, val, n, end_bit, res, ok, idx,
      compact, m);
  return cudaGetLastError();
}

static_assert(WalkTile<512, 16>::kTile == kWalkSmemMax, "largest tile");
static_assert(WalkTile<512, 16>::kBytes <= 232448,
              "the largest tile fits in a block's shared memory");

// ------------------------------------------------------ the large route --

__global__ void switch_walk_prep_kernel(
    int mode, const int32_t* __restrict__ regs, int S, int R, int K,
    const int32_t* __restrict__ op, const int32_t* __restrict__ stage,
    const int32_t* __restrict__ reg, const int32_t* __restrict__ val, int n,
    uint64_t* __restrict__ key, int32_t* __restrict__ cur,
    uint8_t* __restrict__ opf, int32_t* __restrict__ vq,
    int32_t* __restrict__ res) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Prep pr = prep_one(mode, p, S, R, K, op, stage, reg, val);
  key[p] = pr.key;
  opf[p] = pr.opf;
  vq[p] = pr.vq;
  cur[p] = pr.seed >= 0 ? regs[pr.seed] : 0;
  res[p] = 0;
}

__global__ void switch_walk_link_kernel(const uint64_t* __restrict__ skey,
                                        const int64_t* __restrict__ perm,
                                        int32_t* __restrict__ ent, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  ent[perm[j]] = static_cast<int32_t>(perm[lower_bound(skey, n, skey[j])]);
}

__global__ void switch_walk_kernel(int mode, int n,
                                   const uint8_t* __restrict__ opf,
                                   const int32_t* __restrict__ vq,
                                   int32_t* cur, int32_t* res, uint8_t* ok,
                                   const uint64_t* __restrict__ skey,
                                   const int64_t* __restrict__ perm,
                                   const int32_t* __restrict__ ent) {
  walk<int64_t, int32_t>(mode, n, n, opf, vq, cur, res, ok, skey, perm, ent);
}

__global__ void switch_walk_writeback_kernel(
    int mode, int phase, int32_t* __restrict__ regs, int S, int R,
    const uint64_t* __restrict__ skey, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ cur, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || (j > 0 && skey[j - 1] == skey[j])) return;
  const int64_t t = writeback_slot(mode, skey[j], phase, S, R);
  if (t >= 0) regs[t] = cur[perm[j]];
}

int bit_length(uint64_t x) {
  int b = 0;
  while (x) {
    ++b;
    x >>= 1;
  }
  return b;
}

bool sizes_ok(int mode, int S, int R, int K, int n) {
  return mode >= kSerial && mode <= kAffine && S >= 1 && R >= 1 && K >= 1 &&
         int64_t(S) * R <= 0x7fffffffLL && n >= 1 && n % K == 0;
}

}  // namespace

extern "C" {

// The dynamic shared memory, in bytes, of switch_walk_smem_launch's block
// for an n-instruction stream; 0 when n is outside 1..kWalkSmemMax.
int switch_walk_smem_bytes(int n) {
  if (n < 1 || n > kWalkSmemMax) return 0;
  if (n <= 32) return static_cast<int>(WalkTile<32, 1>::kBytes);
  if (n <= 256) return static_cast<int>(WalkTile<256, 1>::kBytes);
  if (n <= 1024) return static_cast<int>(WalkTile<256, 4>::kBytes);
  if (n <= 4096) return static_cast<int>(WalkTile<512, 8>::kBytes);
  return static_cast<int>(WalkTile<512, 16>::kBytes);
}

// One dispatch of engine ``mode`` (0 serial, 1 staged, 2 affine) in one
// launch: applies the [n / K, K] stream (1 <= n <= kWalkSmemMax) to
// regs[S * R] in place, writes res[n] int32 and ok[n] bytes, and
// compact[j] = res[clamp(idx[j], 0, n - 1)] for j < m (m may be 0, idx and
// compact then unused).  Returns cudaErrorInvalidValue without launching
// on bad sizes, else cudaGetLastError() after the launch.
int switch_walk_smem_launch(int mode, void* regs, int S, int R, int K,
                            const void* op, const void* stage,
                            const void* reg, const void* val, int n,
                            void* res, void* ok, const void* idx,
                            void* compact, int m, void* stream) {
  if (!sizes_ok(mode, S, R, K, n) || n > kWalkSmemMax || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int end_bit =
      mode == kSerial ? bit_length(uint64_t(S) * R)
                      : (mode == kAffine ? 32 : 32 + bit_length(S));
  auto* rg = static_cast<int32_t*>(regs);
  auto* o = static_cast<const int32_t*>(op);
  auto* st = static_cast<const int32_t*>(stage);
  auto* r = static_cast<const int32_t*>(reg);
  auto* v = static_cast<const int32_t*>(val);
  auto* out = static_cast<int32_t*>(res);
  auto* okb = static_cast<uint8_t*>(ok);
  auto* ix = static_cast<const int32_t*>(idx);
  auto* cm = static_cast<int32_t*>(compact);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 32)
    err = launch_smem<32, 1>(mode, rg, S, R, K, o, st, r, v, n, end_bit, out,
                             okb, ix, cm, m, s);
  else if (n <= 256)
    err = launch_smem<256, 1>(mode, rg, S, R, K, o, st, r, v, n, end_bit,
                              out, okb, ix, cm, m, s);
  else if (n <= 1024)
    err = launch_smem<256, 4>(mode, rg, S, R, K, o, st, r, v, n, end_bit,
                              out, okb, ix, cm, m, s);
  else if (n <= 4096)
    err = launch_smem<512, 8>(mode, rg, S, R, K, o, st, r, v, n, end_bit,
                              out, okb, ix, cm, m, s);
  else
    err = launch_smem<512, 16>(mode, rg, S, R, K, o, st, r, v, n, end_bit,
                               out, okb, ix, cm, m, s);
  return static_cast<int>(err);
}

// The large route's first launch: key[n] (uint64, stored in an int64
// tensor; every key is below 2^63, so the signed sort is the unsigned
// one), cur[n] seeds, opf[n] opcodes and flags, vq[n] operands, and res[n]
// zeroed.  Returns cudaGetLastError() after the launch.
int switch_walk_prep_launch(int mode, const void* regs, int S, int R, int K,
                            const void* op, const void* stage,
                            const void* reg, const void* val, int n,
                            void* key, void* cur, void* opf, void* vq,
                            void* res, void* stream) {
  if (!sizes_ok(mode, S, R, K, n))
    return static_cast<int>(cudaErrorInvalidValue);
  switch_walk_prep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const int32_t*>(regs), S, R, K,
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(stage),
      static_cast<const int32_t*>(reg), static_cast<const int32_t*>(val), n,
      static_cast<uint64_t*>(key), static_cast<int32_t*>(cur),
      static_cast<uint8_t*>(opf), static_cast<int32_t*>(vq),
      static_cast<int32_t*>(res));
  return static_cast<int>(cudaGetLastError());
}

// The large route after the sort: skey[n] the stably sorted keys, perm[n]
// (int64) their stream positions; ent[n] int32 scratch (serial only).
// Runs the link kernel (serial), the walk on one thread and the two
// write-back passes; writes res, ok and the registers.  Returns the first
// launch error.
int switch_walk_launch(int mode, void* regs, int S, int R, int n,
                       const void* skey, const void* perm, void* ent,
                       const void* opf, const void* vq, void* cur, void* res,
                       void* ok, void* stream) {
  if (!sizes_ok(mode, S, R, 1, n))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  auto* sk = static_cast<const uint64_t*>(skey);
  auto* pm = static_cast<const int64_t*>(perm);
  auto* en = static_cast<int32_t*>(ent);
  if (mode == kSerial) {
    switch_walk_link_kernel<<<blocks, kThreads, 0, s>>>(sk, pm, en, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch_walk_kernel<<<1, 1, 0, s>>>(
      mode, n, static_cast<const uint8_t*>(opf),
      static_cast<const int32_t*>(vq), static_cast<int32_t*>(cur),
      static_cast<int32_t*>(res), static_cast<uint8_t*>(ok), sk, pm, en);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int phase = mode == kSerial ? 1 : 0; phase < 2; ++phase) {
    switch_walk_writeback_kernel<<<blocks, kThreads, 0, s>>>(
        mode, phase, static_cast<int32_t*>(regs), S, R, sk, pm,
        static_cast<const int32_t*>(cur), n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
