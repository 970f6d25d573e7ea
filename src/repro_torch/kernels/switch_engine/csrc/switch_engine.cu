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
// names a register; all three sort per-instruction slot keys into chains
// (one chain a register), so one kernel family with a per-mode slot rule
// serves them.
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
//
// The design.  READ, WRITE and ADD are maps x -> a*x + b with a in {0, 1}
// (READ (1, 0), WRITE (0, v), ADD (1, v), NOP the identity); two such maps
// compose exactly in uint32 arithmetic, so a chain's values are a
// segmented scan of its maps applied to its seed, with no thread walking
// the chain.  A staged ADDP is ADD with b = its source's result; a serial
// CADD is not affine, so serial chains are walked, one thread a chain.
// ADDP couples chains; the couplings only point back in the stream (serial)
// or to earlier stages (staged), so rounds that recompute the chains from
// the addends of the round before reach the unique answer once an addend
// stops changing, one round per level of ADDP sources.
//
// switch_walk_smem (one CTA, N <= kWalkSmemMax): the whole dispatch in
// shared memory, templated on the mode.
//   1. prologue, blocked (thread t holds positions t * kIpt ..): each
//      instruction's key under the mode's rule (serial: the clamped slot;
//      affine: g with its sign bit flipped; staged: stage * R + reg when
//      every live reg of the stream lies in [0, R), else stage << 32 |
//      flipped reg; every NOP, idle staged instruction and tile pad gets the
//      mode's sentinel key, which is never written back), opcode and flags
//      (serial write-enable and same-chain ADDP source, staged forward),
//      operand (ADDP: its source's position), and the seed, the pre-batch
//      register its chain starts from;
//   2. the key range by a block min / max; a stable cub::BlockRadixSort of
//      (key - min, position) over bit_length(max - min) bits, as uint32
//      keys unless a staged stream's range needs more (a real stream's
//      slots lie in [0, S*R): 21 of the 32 bits at S*R = 1,572,864);
//   3. run heads and ends from the sorted keys (each thread's first and
//      last key through shared memory) and each chain's write-back target;
//   4. affine and staged: a cub::BlockScan of (a, b, head) pairs under the
//      segmented composition, then res = the prefix map applied to the
//      seed (READ's pre-value equals its post-value).  Staged repeats the
//      scan while a forwarded ADDP's source result changed (a
//      __syncthreads_or ends it; a stream without one takes one scan).
//      Serial: each run's head thread walks its chain in stream order (the
//      sort is stable) with the value in a register, over sorted copies of
//      opcode and operand (no dependent load a step), software-pipelined
//      (the next steps' loads in flight); an ADDP takes its source's result
//      from the previous round (a source in its own chain: this round's,
//      already walked).  Rounds repeat while an addend changed, at most
//      kRoundCap; past the cap one thread walks the whole stream in
//      stream order, in the same launch, from scratch.  The rounds taken
//      (negative: walked) go to an optional device word;
//   5. write-back by the run ends (affine, staged: the chains of negative g
//      first, then the others, so a chain of the slot itself wins; serial by
//      the walkers), res, ok and compact[j] = res[clamp(idx[j], 0, N-1)].
// Shared memory per tile instruction: operand, seed, result and write-back
// target (16 B), sorted position (2 B), opcode (1 B), and a region that
// holds the range reduction, then CUB's sort storage, then each thread's
// first and last sorted key, then the scan's storage (serial: sorted
// copies of opcode and operand, the last resort's entries and ok, 8 B an
// instruction): 223,232 bytes for staged at the 8,192 tile (the 64-bit
// sort's storage), 221,184 serial, 189,440 affine.  kWalkSmemMax = 8,192
// is the largest power of two that fits in 227 KB.  Tiles: 32 x 1, 256 x
// 1, 256 x 4, 512 x 8, 512 x 16 threads x items.
// What bounds it: not bytes (a B = 256, K = 16 group moves ~80 KB, 0.03 us
// at 3.35 TB/s) but latency: the launch, the block radix sort (about 6
// passes of rank and exchange at 4,096 keys), a block scan a round, and
// for serial the longest chain's walk (a hot slot's chain is still one
// thread's); chip_smoke.py phase 21 times it (PERF.md has the numbers).
//
// switch_walk (the large route, N > kWalkSmemMax): the same steps in
// device memory.  switch_walk_prep_kernel computes keys, seeds, opcodes and
// operands (one thread an instruction); the wrapper stable-sorts the keys
// with torch.sort; switch_walk_launch then runs switch_walk_link_kernel
// (run flags and sorted copies) and the rounds: affine and staged a
// reduce-then-scan over tiles of 2,048 (tile aggregates, one block's scan
// of them, each tile rescanned from its prefix), serial a chain walk a run
// head.  Every round is launched kRoundCap times (a gather kernel first
// refreshes the ADDP addends and raises a changed flag); each launch exits
// at once on a device converged flag, as do the one-thread walk and its
// write-back, launched last as the last resort.  A chain's write-back is
// one pass: a negative chain's write yields to the target slot's own chain
// (a binary search of the sorted keys).  The wrapper compacts with
// result_gather.  Nothing waits on the host.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int32_t kNop = 0, kRead = 1, kWrite = 2, kAdd = 3, kCadd = 4,
                  kAddp = 5;
constexpr int kSerial = 0, kStaged = 1, kAffine = 2;
// an instruction's opcode byte: the opcode class, serial's ADDP whose
// source is an earlier instruction of its own chain, a run's head and end
// (sorted copies only), serial write-enable, staged forward
constexpr uint8_t kCode = 0x7, kSame = 0x08, kHead = 0x10, kLast = 0x20,
                  kWen = 0x40, kFwd = 0x80;
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kNoDense = 0xffffffffu;
constexpr uint32_t kMetaHead = 1u << 16, kMetaLast = 1u << 17;
constexpr int kWalkSmemMax = 8192;
constexpr int kThreads = 256;
// rounds of serial walks (both routes) and of staged scans (large route)
// before the last resort; a staged single-CTA stream needs at most one
// scan per stage on an ADDP source path, so it has no cap
constexpr int kRoundCap = 8;
// the large route's control words: rounds taken (negative: walked),
// converged, and the changed flag of each round's gather
constexpr int kRounds = 0, kConv = 1, kChg = 2;
constexpr int kCtlLen = kChg + kRoundCap + 1;
constexpr int kScanT = 256, kScanI = 8, kScanTile = kScanT * kScanI;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int32_t slot_of(int32_t st, int32_t rg, int R) {
  return static_cast<int32_t>(static_cast<uint32_t>(st) *
                                  static_cast<uint32_t>(R) +
                              static_cast<uint32_t>(rg));
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
  uint32_t dense;   // staged: stage * R + reg for 0 <= reg < R (S * R idle)
  uint8_t opf;      // opcode class | kWen | kSame | kFwd
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
  Prep out{sentinel_key(mode, S, R), -1, static_cast<uint32_t>(n_slots), 0,
           v};
  const int32_t g = slot_of(st, rg, R);
  const int row = p - p % K;
  const int q = row + (v < 0 ? 0 : (v > K - 1 ? K - 1 : v));
  if (mode == kSerial) {
    if (code == kNop) return out;
    const int64_t a = g < 0 ? int64_t(g) + n_slots : int64_t(g);
    const int64_t slot = clamp64(a, 0, n_slots - 1);
    out.key = static_cast<uint64_t>(slot);
    out.seed = slot;
    uint8_t flags = (a >= 0 && a < n_slots) ? kWen : 0;
    if (code == kAddp) {
      out.vq = q;
      if (q < p && op[q] != kNop) {
        const int32_t gq = slot_of(stage[q], reg[q], R);
        const int64_t aq = gq < 0 ? int64_t(gq) + n_slots : int64_t(gq);
        if (clamp64(aq, 0, n_slots - 1) == slot) flags |= kSame;
      }
    }
    out.opf = static_cast<uint8_t>(code | flags);
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
  out.dense = (rg >= 0 && rg < R)
                  ? static_cast<uint32_t>(int64_t(st) * R + rg) : kNoDense;
  out.seed = int64_t(st) * R +
             clamp64(rg < 0 ? int64_t(rg) + R : int64_t(rg), 0, R - 1);
  uint8_t flags = 0;
  if (code == kAddp) {
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

// The large route's write-back of chain key k's final value v, in one
// pass: a negative chain's phase-0 target yields to that slot's own chain.
__device__ void write_back(int mode, uint64_t k, int32_t v, int32_t* regs,
                           const uint64_t* skey, int n, int S, int R) {
  int64_t t = writeback_slot(mode, k, 1, S, R);
  if (t >= 0) {
    regs[t] = v;
    return;
  }
  if (mode == kSerial) return;
  t = writeback_slot(mode, k, 0, S, R);
  if (t < 0) return;
  uint64_t own = static_cast<uint32_t>(t) ^ kSign;      // affine: g = t
  if (mode == kStaged) {
    const uint64_t s = k >> 32;
    own = (s << 32) |
          (static_cast<uint32_t>(t - static_cast<int64_t>(s) * R) ^ kSign);
  }
  const int i = lower_bound(skey, n, own);
  if (i >= n || skey[i] != own) regs[t] = v;
}

// The segmented scan's element: the map x -> a*x + b (fa bit 0: a) and
// whether a run starts at it (fa bit 1).  l then r: a = l.a * r.a, b =
// r.a * l.b + r.b, in uint32 arithmetic; a run start drops what precedes.
struct Seg {
  uint32_t fa;
  uint32_t b;
};

struct SegOp {
  __host__ __device__ __forceinline__ Seg operator()(const Seg& l,
                                                     const Seg& r) const {
    if (r.fa & 2u) return r;
    return Seg{(l.fa & r.fa & 1u) | (l.fa & 2u),
               (r.fa & 1u) ? l.b + r.b : r.b};
  }
};

// The map of an instruction with opcode byte f: WRITE (0, v); ADD and a
// staged ADDP (1, v) (v: the ADDP's addend); READ, NOP and pads (1, 0).
__device__ __forceinline__ Seg seg_of(uint8_t f, int32_t v, bool head) {
  const int32_t code = f & kCode;
  Seg s;
  s.fa = (code == kWrite ? 0u : 1u) | (head ? 2u : 0u);
  s.b = (code == kWrite || code == kAdd || code == kAddp)
            ? static_cast<uint32_t>(v) : 0u;
  return s;
}

__device__ __forceinline__ int32_t seg_apply(const Seg& s, int32_t seed) {
  return static_cast<int32_t>((s.fa & 1u) ? static_cast<uint32_t>(seed) + s.b
                                          : s.b);
}

// kB sorted entries from j on (the last one repeated past n_sorted).
template <int kB, typename PosT>
__device__ __forceinline__ void load_steps(int j, int n_sorted,
                                           const uint8_t* sop,
                                           const PosT* spos,
                                           const int32_t* sv,
                                           uint8_t (&f)[kB], int (&p)[kB],
                                           int32_t (&v)[kB]) {
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int jj = j + u < n_sorted ? j + u : n_sorted - 1;
    f[u] = sop[jj];
    p[u] = static_cast<int>(spos[jj]);
    v[u] = sv[jj];
  }
}

// A serial chain's walk from its head at sorted index j, value c (the
// seed), in stream order, software-pipelined: the next kB steps' loads are
// in flight while kB steps run.  sop / spos / sv: sorted opcode bytes
// (with kHead / kLast), stream positions and operands (an ADDP's: its
// addend from the previous round); vq: stream-order operands (an ADDP's
// source position; one whose source is in its own chain reads that
// source's result as walked); res and ok in stream order.  Returns the
// chain's final value.
template <int kB, typename PosT>
__device__ int32_t walk_chain(int j, int n_sorted, int32_t c,
                              const uint8_t* sop, const PosT* spos,
                              const int32_t* sv, const int32_t* vq,
                              int32_t* res, uint8_t* ok) {
  uint8_t f[kB];
  int p[kB];
  int32_t v[kB];
  load_steps<kB>(j, n_sorted, sop, spos, sv, f, p, v);
#pragma unroll 1
  for (;; j += kB) {
    uint8_t f2[kB];
    int p2[kB];
    int32_t v2[kB];
    load_steps<kB>(j + kB, n_sorted, sop, spos, sv, f2, p2, v2);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int32_t code = f[u] & kCode;
      const int32_t add =
          (code == kAddp && (f[u] & kSame)) ? res[vq[p[u]]] : v[u];
      const int32_t post = wrap_add(c, add);
      const bool cadd_ok = post >= 0;
      int32_t next = c;
      if (code == kWrite) next = v[u];
      else if (code == kAdd || code == kAddp || (code == kCadd && cadd_ok))
        next = post;
      res[p[u]] = code == kRead ? c : next;
      ok[p[u]] = (code == kCadd && !cadd_ok) ? 0 : 1;
      if (f[u] & kWen) c = next;
      if (f[u] & kLast) return c;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      f[u] = f2[u];
      p[u] = p2[u];
      v[u] = v2[u];
    }
  }
}

// The last resort: the whole walk on one thread.  Generic
// pointers: shared memory on the single-CTA route, device memory on the
// large one; ok may alias opf (each opcode is read before its ok is
// written).  Serial: res must hold 0 everywhere and ent each instruction's
// run head (its stream position); cur holds each instruction's seed, and
// the walk updates the entry (the head's slot of cur) in place.  Staged
// walks the sorted runs and leaves each chain's final value at its head.
// Positions >= n (tile pads) are skipped.
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

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Step 2's stable sort of (keys - lo, pos) over ``bits`` bits as KeyT keys;
// keys come back sorted, lo added back.
template <typename BlockSort, typename KeyT, int kIpt>
__device__ __forceinline__ void sort_keys(unsigned char* storage,
                                          uint64_t (&keys)[kIpt],
                                          uint32_t (&pos)[kIpt], uint64_t lo,
                                          int bits) {
  KeyT k[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) k[i] = static_cast<KeyT>(keys[i] - lo);
  BlockSort(*reinterpret_cast<typename BlockSort::TempStorage*>(storage))
      .Sort(k, pos, 0, bits);
#pragma unroll
  for (int i = 0; i < kIpt; ++i) keys[i] = lo + k[i];
}

// The single-CTA route's shared-memory layout for a tile of kT x kIpt
// instructions (the byte budget is in the note above).
template <int kMode, int kT, int kIpt>
struct WalkTile {
  static constexpr int kTile = kT * kIpt;
  using Sort32 = cub::BlockRadixSort<uint32_t, kT, kIpt, uint32_t>;
  using Sort64 = cub::BlockRadixSort<uint64_t, kT, kIpt, uint32_t>;
  using Scan = cub::BlockScan<Seg, kT>;
  static constexpr size_t kSortBytes =
      kMode == kStaged ? cmax(sizeof(typename Sort64::TempStorage),
                              sizeof(typename Sort32::TempStorage))
                       : sizeof(typename Sort32::TempStorage);
  static constexpr size_t kEdgeBytes = size_t(kT) * 16;
  static constexpr size_t kLaterBytes =
      kMode == kSerial ? size_t(kTile) * 8
                       : sizeof(typename Scan::TempStorage);
  static constexpr size_t kUnion =
      (cmax(kSortBytes, cmax(kEdgeBytes, kLaterBytes)) + 15) / 16 * 16;
  static constexpr size_t kBytes = kUnion + size_t(kTile) * 19;
};

template <int kMode, int kT, int kIpt>
__global__ void __launch_bounds__(kT) switch_walk_smem_kernel(
    int32_t* __restrict__ regs, int S, int R, int K,
    const int32_t* __restrict__ op, const int32_t* __restrict__ stage,
    const int32_t* __restrict__ reg, const int32_t* __restrict__ val, int n,
    int32_t* __restrict__ res, uint8_t* __restrict__ ok,
    const int32_t* __restrict__ idx, int32_t* __restrict__ compact, int m,
    int32_t* __restrict__ rounds) {
  using Tile = WalkTile<kMode, kT, kIpt>;
  using Sort32 = typename Tile::Sort32;
  using Sort64 = typename Tile::Sort64;
  using Scan = typename Tile::Scan;
  constexpr int kTile = Tile::kTile;
  constexpr int kWarps = kT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  // the region: reduction, sort, edges, then the scan or serial's copies
  uint64_t* s_edge = reinterpret_cast<uint64_t*>(smem);
  int32_t* s_vq = reinterpret_cast<int32_t*>(smem + Tile::kUnion);
  int32_t* s_cur = s_vq + kTile;
  int32_t* s_res = s_cur + kTile;
  int32_t* s_wbt = s_res + kTile;
  uint16_t* s_spos = reinterpret_cast<uint16_t*>(s_wbt + kTile);
  uint8_t* s_opf = reinterpret_cast<uint8_t*>(s_spos + kTile);
  const int tid = threadIdx.x;
  const int64_t n_slots = int64_t(S) * R;

  // 1. prologue: every seed fetch in flight at once
  uint64_t keys[kIpt];
  uint32_t dense_key[kIpt];
  bool dense = true;
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int p = tid * kIpt + i;
    if (p < n) {
      const Prep pr = prep_one(kMode, p, S, R, K, op, stage, reg, val);
      keys[i] = pr.key;
      dense_key[i] = pr.dense;
      dense = dense && pr.dense != kNoDense;
      s_opf[p] = pr.opf;
      s_vq[p] = pr.vq;
      s_cur[p] = pr.seed >= 0 ? regs[pr.seed] : 0;
    } else {
      keys[i] = sentinel_key(kMode, S, R);
      dense_key[i] = static_cast<uint32_t>(n_slots);
      s_opf[p] = 0;
      s_vq[p] = 0;
      s_cur[p] = 0;
    }
    s_res[p] = 0;
  }
  if constexpr (kMode == kStaged) {
    dense = __syncthreads_and(dense);
    if (dense) {
#pragma unroll
      for (int i = 0; i < kIpt; ++i) keys[i] = dense_key[i];
    }
  }

  // 2. the key range, then the stable sort of (key - min, position)
  uint64_t lo = keys[0], hi = keys[0];
#pragma unroll
  for (int i = 1; i < kIpt; ++i) {
    lo = keys[i] < lo ? keys[i] : lo;
    hi = keys[i] > hi ? keys[i] : hi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t l2 = __shfl_xor_sync(
        0xffffffffu, static_cast<unsigned long long>(lo), o);
    const uint64_t h2 = __shfl_xor_sync(
        0xffffffffu, static_cast<unsigned long long>(hi), o);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  if ((tid & 31) == 0) {
    s_edge[tid >> 5] = lo;
    s_edge[kWarps + (tid >> 5)] = hi;
  }
  __syncthreads();
  lo = s_edge[0];
  hi = s_edge[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = s_edge[w] < lo ? s_edge[w] : lo;
    hi = s_edge[kWarps + w] > hi ? s_edge[kWarps + w] : hi;
  }
  __syncthreads();                      // the sort's storage overlays these
  const int bits =
      hi > lo ? 64 - __clzll(static_cast<long long>(hi - lo)) : 1;
  uint32_t pos[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i)
    pos[i] = static_cast<uint32_t>(tid * kIpt + i);
  if constexpr (kMode == kStaged) {
    if (bits > 32)                      // a staged stream's stray regs
      sort_keys<Sort64, uint64_t>(smem, keys, pos, lo, bits);
    else
      sort_keys<Sort32, uint32_t>(smem, keys, pos, lo, bits);
  } else {
    sort_keys<Sort32, uint32_t>(smem, keys, pos, lo, bits);
  }
  __syncthreads();                      // the edges overlay the sort's storage
  s_edge[tid] = keys[0];
  s_edge[kT + tid] = keys[kIpt - 1];
#pragma unroll
  for (int i = 0; i < kIpt; ++i)
    s_spos[tid * kIpt + i] = static_cast<uint16_t>(pos[i]);
  __syncthreads();

  // 3. run heads and ends; each chain's write-back target (serial at its
  // head, the others at its end): >= 0 a slot, <= -2 the phase-0 slot
  // -2 - t of a negative chain, -1 none
  uint32_t meta[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int j = tid * kIpt + i;
    const bool head = i > 0 ? keys[i - 1] != keys[i]
                            : (tid == 0 || s_edge[kT + tid - 1] != keys[0]);
    const bool last = i < kIpt - 1
                          ? keys[i] != keys[i + 1]
                          : (tid == kT - 1 || s_edge[tid + 1] != keys[i]);
    meta[i] = pos[i] | (head ? kMetaHead : 0u) | (last ? kMetaLast : 0u);
    if (kMode == kSerial ? head : last) {
      uint64_t k = keys[i];
      if (kMode == kStaged && dense)
        k = ((k / static_cast<uint64_t>(R)) << 32) |
            (static_cast<uint32_t>(k % static_cast<uint64_t>(R)) ^ kSign);
      int64_t t = writeback_slot(kMode, k, 1, S, R);
      if (t < 0 && kMode != kSerial) {
        const int64_t t0 = writeback_slot(kMode, k, 0, S, R);
        t = t0 >= 0 ? -2 - t0 : -1;
      }
      s_wbt[j] = static_cast<int32_t>(t);
    }
  }
  __syncthreads();                      // the region is reused next

  // 4. the chains
  int32_t taken = 0;
  if constexpr (kMode == kSerial) {
    int32_t* s_sv = reinterpret_cast<int32_t*>(smem);
    uint8_t* s_sop = smem + size_t(kTile) * 4;
    uint16_t* s_ent = reinterpret_cast<uint16_t*>(smem + size_t(kTile) * 5);
    uint8_t* s_ok = smem + size_t(kTile) * 7;
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      const int j = tid * kIpt + i;
      const int p = meta[i] & 0xffff;
      const uint8_t f = s_opf[p];
      s_sop[j] = f | ((meta[i] & kMetaHead) ? kHead : 0) |
                 ((meta[i] & kMetaLast) ? kLast : 0);
      s_sv[j] = (f & kCode) == kAddp ? 0 : s_vq[p];
      s_ok[p] = 1;
    }
    __syncthreads();
    for (;;) {
#pragma unroll 1
      for (int j = tid * kIpt; j < (tid + 1) * kIpt; ++j) {
        const uint8_t f = s_sop[j];
        const int p = s_spos[j];
        if (!(f & kHead) || p >= n || (f & kCode) == kNop) continue;
        const int32_t c = walk_chain<4, uint16_t>(j, kTile, s_cur[p], s_sop,
                                                  s_spos, s_sv, s_vq, s_res,
                                                  s_ok);
        if (s_wbt[j] >= 0) regs[s_wbt[j]] = c;
      }
      ++taken;
      __syncthreads();
      // the addends of the ADDPs whose source is another chain's
      bool changed = false;
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int j = tid * kIpt + i;
        if ((s_sop[j] & (kCode | kSame)) != kAddp) continue;
        const int p = meta[i] & 0xffff;
        const int q = s_vq[p];
        const int32_t a = q < p ? s_res[q] : 0;
        if (a != s_sv[j]) {
          s_sv[j] = a;
          changed = true;
        }
      }
      if (!__syncthreads_or(changed)) break;
      if (taken == kRoundCap) {         // the last resort, from scratch
#pragma unroll 1
        for (int j0 = tid * kIpt; j0 < (tid + 1) * kIpt; ++j0) {
          const int p0 = s_spos[j0];
          if (!(s_sop[j0] & kHead) || p0 >= n) continue;
          for (int j = j0;; ++j) {
            s_ent[s_spos[j]] = static_cast<uint16_t>(p0);
            if (s_sop[j] & kLast) break;
          }
        }
        for (int p = tid; p < kTile; p += kT) s_res[p] = 0;
        __syncthreads();
        if (tid == 0)
          walk<uint16_t, uint16_t>(kSerial, kTile, n, s_opf, s_vq, s_cur,
                                   s_res, s_ok, nullptr, nullptr, s_ent);
        __syncthreads();
#pragma unroll 1
        for (int j = tid * kIpt; j < (tid + 1) * kIpt; ++j) {
          const int p = s_spos[j];
          if ((s_sop[j] & kHead) && p < n && s_wbt[j] >= 0)
            regs[s_wbt[j]] = s_cur[p];
        }
        taken = -taken;
        break;
      }
    }
    __syncthreads();
    for (int p = tid; p < n; p += kT) ok[p] = s_ok[p];
  } else {
    auto& scan_tmp = *reinterpret_cast<typename Scan::TempStorage*>(smem);
    int32_t add[kIpt];                  // a forwarded ADDP's addend
    bool any_fwd = false;
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      add[i] = 0;
      const int p = meta[i] & 0xffff;
      any_fwd = any_fwd || (kMode == kStaged && p < n &&
                            (s_opf[p] & (kCode | kFwd)) == (kAddp | kFwd));
    }
    if constexpr (kMode == kStaged) any_fwd = __syncthreads_or(any_fwd);
    for (;;) {
      Seg it[kIpt];
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int p = meta[i] & 0xffff;
        const uint8_t f = s_opf[p];
        it[i] = seg_of(f, (f & kCode) == kAddp ? add[i] : s_vq[p],
                       meta[i] & kMetaHead);
      }
      Scan(scan_tmp).InclusiveScan(it, it, SegOp());
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int p = meta[i] & 0xffff;
        if (p < n)
          s_res[p] = (s_opf[p] & kCode) == kNop ? 0
                                                 : seg_apply(it[i], s_cur[p]);
      }
      ++taken;
      if (!any_fwd) break;
      __syncthreads();
      bool changed = false;
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int p = meta[i] & 0xffff;
        if (p >= n || (s_opf[p] & (kCode | kFwd)) != (kAddp | kFwd)) continue;
        const int32_t a = s_res[s_vq[p]];
        changed = changed || a != add[i];
        add[i] = a;
      }
      if (!__syncthreads_or(changed)) break;
    }
    __syncthreads();
    // 5. write-back by the run ends: negative chains first
#pragma unroll
    for (int phase = 0; phase < 2; ++phase) {
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        if (!(meta[i] & kMetaLast)) continue;
        const int t = s_wbt[tid * kIpt + i];
        if (phase == 0 ? t <= -2 : t >= 0)
          regs[phase == 0 ? -2 - t : t] = s_res[meta[i] & 0xffff];
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int p = tid; p < n; p += kT) {
    res[p] = s_res[p];
    if (kMode != kSerial) ok[p] = 1;
  }
  for (int q = tid; q < m; q += kT) {
    int32_t k = idx[q];
    k = k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
    compact[q] = s_res[k];
  }
  if (rounds != nullptr && tid == 0) *rounds = taken;
}

template <int kMode, int kT, int kIpt>
cudaError_t launch_smem(int32_t* regs, int S, int R, int K, const int32_t* op,
                        const int32_t* stage, const int32_t* reg,
                        const int32_t* val, int n, int32_t* res, uint8_t* ok,
                        const int32_t* idx, int32_t* compact, int m,
                        int32_t* rounds, cudaStream_t s) {
  static std::atomic<unsigned> configured{0};
  constexpr int bytes = static_cast<int>(WalkTile<kMode, kT, kIpt>::kBytes);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(switch_walk_smem_kernel<kMode, kT, kIpt>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  switch_walk_smem_kernel<kMode, kT, kIpt><<<1, kT, bytes, s>>>(
      regs, S, R, K, op, stage, reg, val, n, res, ok, idx, compact, m,
      rounds);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_smem_mode(int32_t* regs, int S, int R, int K,
                             const int32_t* op, const int32_t* stage,
                             const int32_t* reg, const int32_t* val, int n,
                             int32_t* res, uint8_t* ok, const int32_t* idx,
                             int32_t* compact, int m, int32_t* rounds,
                             cudaStream_t s) {
  if (n <= 32)
    return launch_smem<kMode, 32, 1>(regs, S, R, K, op, stage, reg, val, n,
                                     res, ok, idx, compact, m, rounds, s);
  if (n <= 256)
    return launch_smem<kMode, 256, 1>(regs, S, R, K, op, stage, reg, val, n,
                                      res, ok, idx, compact, m, rounds, s);
  if (n <= 1024)
    return launch_smem<kMode, 256, 4>(regs, S, R, K, op, stage, reg, val, n,
                                      res, ok, idx, compact, m, rounds, s);
  if (n <= 4096)
    return launch_smem<kMode, 512, 8>(regs, S, R, K, op, stage, reg, val, n,
                                      res, ok, idx, compact, m, rounds, s);
  return launch_smem<kMode, 512, 16>(regs, S, R, K, op, stage, reg, val, n,
                                     res, ok, idx, compact, m, rounds, s);
}

static_assert(WalkTile<kSerial, 512, 16>::kTile == kWalkSmemMax,
              "largest tile");
static_assert(WalkTile<kSerial, 512, 16>::kBytes <= 232448 &&
                  WalkTile<kStaged, 512, 16>::kBytes <= 232448 &&
                  WalkTile<kAffine, 512, 16>::kBytes <= 232448,
              "the largest tile fits in a block's shared memory");

// ------------------------------------------------------ the large route --

// true when round r of the large route has nothing to do: the rounds
// converged, or round r's gather changed no addend (which marks them so)
__device__ __forceinline__ bool round_done(int32_t* ctl, int r) {
  if (ctl[kConv]) return true;
  if (r > 0 && !ctl[kChg + r]) {
    if (blockIdx.x == 0 && threadIdx.x == 0) ctl[kConv] = 1;
    return true;
  }
  return false;
}

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

// Sorted copies with run flags: sop[j] = opf[perm[j]] | kHead | kLast,
// sv[j] its operand (an ADDP's addend starts at 0); ok = 1 everywhere (a
// serial walk rewrites it); the control words zeroed.
__global__ void switch_walk_link_kernel(
    int n, const uint64_t* __restrict__ skey, const int64_t* __restrict__ perm,
    const uint8_t* __restrict__ opf, const int32_t* __restrict__ vq,
    uint8_t* __restrict__ sop, int32_t* __restrict__ sv,
    uint8_t* __restrict__ ok, int32_t* __restrict__ ctl) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j == 0)
    for (int k = 0; k < kCtlLen; ++k) ctl[k] = 0;
  if (j >= n) return;
  const int64_t p = perm[j];
  const uint8_t f = opf[p];
  const uint64_t k = skey[j];
  const bool head = j == 0 || skey[j - 1] != k;
  const bool last = j == n - 1 || skey[j + 1] != k;
  sop[j] = f | (head ? kHead : 0) | (last ? kLast : 0);
  sv[j] = (f & kCode) == kAddp ? 0 : vq[p];
  ok[p] = 1;
}

// Round r's addends: serial an ADDP whose source is another chain's (q <
// p: its result, else 0), staged a forwarded ADDP (its source's result);
// raises changed[r] when one differs from the round before.
__global__ void switch_walk_gather_kernel(
    int mode, int r, int n, const uint8_t* __restrict__ sop,
    int32_t* __restrict__ sv, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ vq, const int32_t* __restrict__ res,
    int32_t* __restrict__ ctl) {
  if (ctl[kConv]) return;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint8_t f = sop[j];
  if ((f & kCode) != kAddp) return;
  if (mode == kSerial ? (f & kSame) != 0 : (f & kFwd) == 0) return;
  const int64_t p = perm[j];
  const int32_t q = vq[p];
  const int32_t a = (mode != kSerial || q < p) ? res[q] : 0;
  if (a != sv[j]) {
    sv[j] = a;
    ctl[kChg + r] = 1;
  }
}

// Serial round r: one thread a run head walks its chain and writes it back.
__global__ void switch_walk_chains_kernel(
    int r, int n, int32_t* __restrict__ regs, int64_t n_slots,
    const uint64_t* __restrict__ skey, const int64_t* __restrict__ perm,
    const uint8_t* __restrict__ sop, const int32_t* __restrict__ sv,
    const int32_t* __restrict__ vq, const int32_t* __restrict__ cur,
    int32_t* res, uint8_t* __restrict__ ok, int32_t* __restrict__ ctl) {
  if (round_done(ctl, r)) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[kRounds] = r + 1;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint8_t f = sop[j];
  if (!(f & kHead) || (f & kCode) == kNop) return;
  const int32_t c = walk_chain<8, int64_t>(j, n, cur[perm[j]], sop, perm, sv,
                                           vq, res, ok);
  if (skey[j] < static_cast<uint64_t>(n_slots)) regs[skey[j]] = c;
}

using TileScan = cub::BlockScan<Seg, kScanT>;

__device__ __forceinline__ void load_segs(int base, int n,
                                          const uint8_t* __restrict__ sop,
                                          const int32_t* __restrict__ sv,
                                          Seg (&it)[kScanI]) {
#pragma unroll
  for (int i = 0; i < kScanI; ++i) {
    const int j = base + i;
    if (j < n) {
      const uint8_t f = sop[j];
      it[i] = seg_of(f, sv[j], f & kHead);
    } else {
      it[i] = Seg{1u, 0u};
    }
  }
}

// Affine / staged round r, launch 1: each tile's composed map.
__global__ void __launch_bounds__(kScanT) switch_walk_tile_reduce_kernel(
    int r, int n, const uint8_t* __restrict__ sop,
    const int32_t* __restrict__ sv, Seg* __restrict__ agg,
    int32_t* __restrict__ ctl) {
  __shared__ typename TileScan::TempStorage tmp;
  if (round_done(ctl, r)) return;
  Seg it[kScanI];
  load_segs(blockIdx.x * kScanTile + threadIdx.x * kScanI, n, sop, sv, it);
  Seg total;
  TileScan(tmp).InclusiveScan(it, it, SegOp(), total);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

// Launch 2, one block: each tile's prefix, the composition of the tiles
// before it (a run of tiles a thread, then a block scan of those runs).
__global__ void __launch_bounds__(kScanT) switch_walk_tile_prefix_kernel(
    int r, int tiles, const Seg* __restrict__ agg, Seg* __restrict__ pre,
    int32_t* __restrict__ ctl) {
  __shared__ typename TileScan::TempStorage tmp;
  if (round_done(ctl, r)) return;
  const int per = (tiles + kScanT - 1) / kScanT;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < tiles ? lo + per : tiles;
  const SegOp op;
  Seg acc{1u, 0u};
  for (int t = lo; t < hi; ++t) acc = op(acc, agg[t]);
  Seg excl;
  TileScan(tmp).ExclusiveScan(acc, excl, Seg{1u, 0u}, op);
  for (int t = lo; t < hi; ++t) {
    pre[t] = excl;
    excl = op(excl, agg[t]);
  }
}

// Launch 3: each tile rescanned from its prefix; res, and the write-back
// at each run's end.
__global__ void __launch_bounds__(kScanT) switch_walk_tile_apply_kernel(
    int mode, int r, int n, int32_t* __restrict__ regs, int S, int R,
    const uint64_t* __restrict__ skey, const int64_t* __restrict__ perm,
    const uint8_t* __restrict__ sop, const int32_t* __restrict__ sv,
    const int32_t* __restrict__ cur, int32_t* __restrict__ res,
    const Seg* __restrict__ pre, int32_t* __restrict__ ctl) {
  __shared__ typename TileScan::TempStorage tmp;
  if (round_done(ctl, r)) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[kRounds] = r + 1;
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanI;
  Seg it[kScanI];
  load_segs(base, n, sop, sv, it);
  TileScan(tmp).InclusiveScan(it, it, SegOp());
  const Seg p0 = pre[blockIdx.x];
  const SegOp op;
#pragma unroll
  for (int i = 0; i < kScanI; ++i) {
    const int j = base + i;
    if (j >= n) break;
    const int64_t p = perm[j];
    const uint8_t f = sop[j];
    const int32_t v = seg_apply(op(p0, it[i]), cur[p]);
    res[p] = (f & kCode) == kNop ? 0 : v;
    if (f & kLast) write_back(mode, skey[j], v, regs, skey, n, S, R);
  }
}

// The last resort, serial: each instruction's entry and res zeroed.
__global__ void switch_walk_fallback_prep_kernel(
    int n, const uint64_t* __restrict__ skey, const int64_t* __restrict__ perm,
    int32_t* __restrict__ ent, int32_t* __restrict__ res,
    int32_t* __restrict__ ctl) {
  if (round_done(ctl, kRoundCap)) return;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  ent[perm[j]] = static_cast<int32_t>(perm[lower_bound(skey, n, skey[j])]);
  res[perm[j]] = 0;
}

// The last resort: the one-thread walk, when the rounds did not converge.
__global__ void switch_walk_kernel(int mode, int n,
                                   const uint8_t* __restrict__ opf,
                                   const int32_t* __restrict__ vq,
                                   int32_t* cur, int32_t* res, uint8_t* ok,
                                   const uint64_t* __restrict__ skey,
                                   const int64_t* __restrict__ perm,
                                   const int32_t* __restrict__ ent,
                                   int32_t* __restrict__ ctl) {
  if (round_done(ctl, kRoundCap)) return;
  walk<int64_t, int32_t>(mode, n, n, opf, vq, cur, res, ok, skey, perm, ent);
  ctl[kRounds] = -kRoundCap;
}

// ... and its write-back from the run heads.
__global__ void switch_walk_writeback_kernel(
    int mode, int32_t* __restrict__ regs, int S, int R,
    const uint64_t* __restrict__ skey, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ cur, int n, int32_t* __restrict__ ctl) {
  if (round_done(ctl, kRoundCap)) return;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || (j > 0 && skey[j - 1] == skey[j])) return;
  write_back(mode, skey[j], cur[perm[j]], regs, skey, n, S, R);
}

bool sizes_ok(int mode, int S, int R, int K, int n) {
  return mode >= kSerial && mode <= kAffine && S >= 1 && R >= 1 && K >= 1 &&
         int64_t(S) * R <= 0x7fffffffLL && n >= 1 && n % K == 0;
}

// The large route's scratch, in int32 words: the control words, the tile
// aggregates and prefixes (2 words each), sorted operands, entries, then
// the sorted opcode bytes.
struct Scratch {
  int tiles, ctl, agg, pre, sv, ent, sop, words;
  explicit Scratch(int n) {
    tiles = (n + kScanTile - 1) / kScanTile;
    ctl = 0;
    agg = (kCtlLen + 1) / 2 * 2;
    pre = agg + 2 * tiles;
    sv = pre + 2 * tiles;
    ent = sv + n;
    sop = ent + n;
    words = sop + (n + 3) / 4;
  }
};

}  // namespace

extern "C" {

// The dynamic shared memory, in bytes, of switch_walk_smem_launch's block
// for an n-instruction stream (the most any mode takes); 0 when n is
// outside 1..kWalkSmemMax.
int switch_walk_smem_bytes(int n) {
  if (n < 1 || n > kWalkSmemMax) return 0;
  if (n <= 32) return static_cast<int>(WalkTile<kStaged, 32, 1>::kBytes);
  if (n <= 256) return static_cast<int>(WalkTile<kStaged, 256, 1>::kBytes);
  if (n <= 1024) return static_cast<int>(WalkTile<kStaged, 256, 4>::kBytes);
  if (n <= 4096) return static_cast<int>(WalkTile<kStaged, 512, 8>::kBytes);
  return static_cast<int>(WalkTile<kStaged, 512, 16>::kBytes);
}

// One dispatch of engine ``mode`` (0 serial, 1 staged, 2 affine) in one
// launch: applies the [n / K, K] stream (1 <= n <= kWalkSmemMax) to
// regs[S * R] in place, writes res[n] int32 and ok[n] bytes, and
// compact[j] = res[clamp(idx[j], 0, n - 1)] for j < m (m may be 0, idx and
// compact then unused); rounds (may be null): one int32, the rounds taken
// (negative: that many serial rounds, then the one-thread walk).  Returns
// cudaErrorInvalidValue without launching on bad sizes, else
// cudaGetLastError() after the launch.
int switch_walk_smem_launch(int mode, void* regs, int S, int R, int K,
                            const void* op, const void* stage,
                            const void* reg, const void* val, int n,
                            void* res, void* ok, const void* idx,
                            void* compact, int m, void* rounds,
                            void* stream) {
  if (!sizes_ok(mode, S, R, K, n) || n > kWalkSmemMax || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* rg = static_cast<int32_t*>(regs);
  auto* o = static_cast<const int32_t*>(op);
  auto* st = static_cast<const int32_t*>(stage);
  auto* r = static_cast<const int32_t*>(reg);
  auto* v = static_cast<const int32_t*>(val);
  auto* out = static_cast<int32_t*>(res);
  auto* okb = static_cast<uint8_t*>(ok);
  auto* ix = static_cast<const int32_t*>(idx);
  auto* cm = static_cast<int32_t*>(compact);
  auto* rd = static_cast<int32_t*>(rounds);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == kSerial)
    err = launch_smem_mode<kSerial>(rg, S, R, K, o, st, r, v, n, out, okb,
                                    ix, cm, m, rd, s);
  else if (mode == kStaged)
    err = launch_smem_mode<kStaged>(rg, S, R, K, o, st, r, v, n, out, okb,
                                    ix, cm, m, rd, s);
  else
    err = launch_smem_mode<kAffine>(rg, S, R, K, o, st, r, v, n, out, okb,
                                    ix, cm, m, rd, s);
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

// The int32 words of switch_walk_launch's scratch for n instructions; its
// first word receives the rounds taken (negative: walked).
int switch_walk_scratch_words(int n) {
  return n < 1 ? 0 : Scratch(n).words;
}

// The large route after the sort: skey[n] the stably sorted keys, perm[n]
// (int64) their stream positions, scratch of switch_walk_scratch_words(n)
// int32 words.  Runs the link kernel, then the rounds (serial chain walks;
// affine and staged tile scans), each launched kRoundCap times (affine
// once) behind a gather of the ADDP addends, then the one-thread walk and
// its write-back, all exiting at once when the rounds converged; writes
// res, ok and the registers.  Returns the first launch error.
int switch_walk_launch(int mode, void* regs, int S, int R, int n,
                       const void* skey, const void* perm, const void* opf,
                       const void* vq, void* cur, void* res, void* ok,
                       void* scratch, void* stream) {
  if (!sizes_ok(mode, S, R, 1, n))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  const Scratch lay(n);
  auto* w = static_cast<int32_t*>(scratch);
  auto* ctl = w + lay.ctl;
  auto* agg = reinterpret_cast<Seg*>(w + lay.agg);
  auto* pre = reinterpret_cast<Seg*>(w + lay.pre);
  auto* sv = w + lay.sv;
  auto* ent = w + lay.ent;
  auto* sop = reinterpret_cast<uint8_t*>(w + lay.sop);
  auto* rg = static_cast<int32_t*>(regs);
  auto* sk = static_cast<const uint64_t*>(skey);
  auto* pm = static_cast<const int64_t*>(perm);
  auto* of = static_cast<const uint8_t*>(opf);
  auto* q = static_cast<const int32_t*>(vq);
  auto* cu = static_cast<int32_t*>(cur);
  auto* out = static_cast<int32_t*>(res);
  auto* okb = static_cast<uint8_t*>(ok);
  cudaError_t err;
#define WALK_CHECK()                                  \
  if ((err = cudaGetLastError()) != cudaSuccess) \
    return static_cast<int>(err);
  switch_walk_link_kernel<<<blocks, kThreads, 0, s>>>(n, sk, pm, of, q, sop,
                                                      sv, okb, ctl);
  WALK_CHECK();
  const int n_rounds = mode == kAffine ? 1 : kRoundCap;
  for (int r = 0; r <= n_rounds; ++r) {
    if (r > 0 && mode != kAffine) {
      switch_walk_gather_kernel<<<blocks, kThreads, 0, s>>>(
          mode, r, n, sop, sv, pm, q, out, ctl);
      WALK_CHECK();
    }
    if (r == n_rounds) break;
    if (mode == kSerial) {
      switch_walk_chains_kernel<<<blocks, kThreads, 0, s>>>(
          r, n, rg, int64_t(S) * R, sk, pm, sop, sv, q, cu, out, okb, ctl);
      WALK_CHECK();
      continue;
    }
    switch_walk_tile_reduce_kernel<<<lay.tiles, kScanT, 0, s>>>(r, n, sop, sv,
                                                                agg, ctl);
    WALK_CHECK();
    switch_walk_tile_prefix_kernel<<<1, kScanT, 0, s>>>(r, lay.tiles, agg,
                                                        pre, ctl);
    WALK_CHECK();
    switch_walk_tile_apply_kernel<<<lay.tiles, kScanT, 0, s>>>(
        mode, r, n, rg, S, R, sk, pm, sop, sv, cu, out, pre, ctl);
    WALK_CHECK();
  }
  if (mode == kAffine) return 0;
  if (mode == kSerial) {
    switch_walk_fallback_prep_kernel<<<blocks, kThreads, 0, s>>>(n, sk, pm,
                                                                 ent, out,
                                                                 ctl);
    WALK_CHECK();
  }
  switch_walk_kernel<<<1, 1, 0, s>>>(mode, n, of, q, cu, out, okb, sk, pm,
                                     ent, ctl);
  WALK_CHECK();
  switch_walk_writeback_kernel<<<blocks, kThreads, 0, s>>>(mode, rg, S, R,
                                                           sk, pm, cu, n,
                                                           ctl);
  WALK_CHECK();
#undef WALK_CHECK
  return 0;
}

}  // extern "C"
