// The scan layer's fused kernels of giddy_tpu_torch, which never write a
// column's decoded form: the filter (K16) and the aggregate (K17) that read
// a packed column (nbit, dzbf, for), and the filter on run tables (K19,
// rle and rpe). Plain C interface, bound with ctypes by
// giddy_tpu_torch/kernels/_build.py. K16 and K17 stage tiles of packed
// words in shared memory with bulk async copies and fold them there
// (walk_tiles below); thread c of a tile reads its lane through
// gt::SmemLaneReader, adds the group's frame reference (FOR; 0 otherwise)
// with a uint32 wrap, and folds the lane's 32 values in registers.
//
// Comparisons and min/max run on an order key (order_key below, the
// counterpart of giddy_tpu/aggregate.py:33-52 _key_map_traced): an int32
// whose signed order is the logical dtype's. The key is a bijection of the
// payload, so eq/ne and the four order compares of giddy_tpu/query.py:51-69
// _cmp (narrow sign-extension, IEEE total order for floats) hold on keys.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch (0 on success), the
// error of a refused shared-memory opt-in, or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "lmp.cuh"

namespace gt {

// The logical dtype's kind: numpy's 'u', 'i', 'f'.
enum class Kind { kUnsigned = 0, kSigned = 1, kFloat = 2 };
enum class Op { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };
enum class Agg { kSum = 0, kMin = 1, kMax = 2 };

// sext is the prmt selector that sign-extends a payload of the logical
// dtype's width (sext_selector): a narrow signed payload is stored zero-
// extended. A float key flips the magnitude bits of negatives (IEEE total
// order, re-biased to signed); an unsigned key flips the sign bit.
__device__ __forceinline__ uint32_t sext_selector(int width) {
  // result bytes: 0 (and 1) as they are, then the sign of the top payload byte
  return width == 8 ? 0x8880u : width == 16 ? 0x9910u : 0x3210u;
}

template <Kind K, bool kNarrow>
__device__ __forceinline__ int32_t order_key(uint32_t u, uint32_t sext) {
  if constexpr (K == Kind::kSigned) {
    if constexpr (!kNarrow) return static_cast<int32_t>(u);
    uint32_t r;
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(u), "r"(sext));
    return static_cast<int32_t>(r);
  } else if constexpr (K == Kind::kFloat) {
    const int32_t s = static_cast<int32_t>(u);
    return s ^ ((s >> 31) & 0x7FFFFFFF);
  } else {
    return static_cast<int32_t>(u ^ 0x80000000u);
  }
}

// Calls f(std::bool_constant<narrow>), narrow when a signed payload is
// narrower than 32 bits (sign-extended for its key, its sign bit below
// bit 31). The kernels branch on it once, before the walk, so the slot
// loops of a 32-bit column carry no sign extension.
template <Kind K, typename F>
__device__ __forceinline__ void by_width(int width, F&& f) {
  if (K == Kind::kSigned && width < 32) {
    f(std::bool_constant<K == Kind::kSigned>{});
  } else {
    f(std::false_type{});
  }
}

// word | bit where a <op> b: a compare into a predicate and a predicated
// OR (the compiler's select-then-OR is one instruction more a slot).
template <Op O>
__device__ __forceinline__ uint32_t or_if(uint32_t word, int32_t a, int32_t b, uint32_t bit) {
#define GT_OR_IF(CMP)                                                                                    \
  asm("{\n\t.reg .pred p;\n\tsetp." CMP ".s32 p, %1, %2;\n\t@p or.b32 %0, %0, %3;\n\t}" \
      : "+r"(word)                                                                                       \
      : "r"(a), "r"(b), "r"(bit))
  if constexpr (O == Op::kEq) GT_OR_IF("eq");
  if constexpr (O == Op::kNe) GT_OR_IF("ne");
  if constexpr (O == Op::kLt) GT_OR_IF("lt");
  if constexpr (O == Op::kLe) GT_OR_IF("le");
  if constexpr (O == Op::kGt) GT_OR_IF("gt");
  if constexpr (O == Op::kGe) GT_OR_IF("ge");
#undef GT_OR_IF
  return word;
}

// The staged walk of K16 and K17. A tile is one group's packed words for
// kTileLanes lanes: lane c's word w lies at g * bits * kLanes + w * kLanes
// + c, so the tile of lanes [j * 256, j * 256 + 256) is `bits` contiguous
// 1 KB pieces, 4 KB apart, plus the group's 1 KB of validity words for
// those lanes when the column is nullable. In shared memory the tile is
// dense: word w of the tile's lane c at w * kTileLanes + c, validity word
// at bits * kTileLanes + c, so a warp reads 32 consecutive words, one a
// bank.
//
// Each block is persistent: it walks tiles t = blockIdx.x + k * gridDim.x,
// tile t being lanes (t % 4) * 256 of group t / 4, through a ring of
// `stages` tiles in dynamic shared memory with one mbarrier a stage. Warp
// 0 issues the pieces of local tile k + stages - 1 (one 1 KB
// cp.async.bulk a lane, the barrier expecting their bytes) before the
// block waits for tile k, so stages - 1 tiles of every block are in
// flight while it folds one (>= 16 KB an SM at every B; the wrapper picks
// stages and grid, kernels/_wrap.scan_plan). The bulk copy, not cp.async
// in 16-byte pieces: one instruction moves a piece, and the barrier counts
// its bytes, so no thread waits on a copy group. The __syncthreads() after
// each fold frees the stage that the next iteration refills. The frame
// reference of the next tile is loaded into a register a tile ahead.
constexpr int kTilesPerGroup = kLanes / kTileLanes;
constexpr int kPieceBytes = kTileLanes * 4;
constexpr int kBarrierBytes = 128;  // the stages' mbarriers, ahead of the ring
constexpr int kMaxStages = kBarrierBytes / 8;

// Every thread of the block calls it once. fold(g, lane, tile, ref) folds
// the thread's lane of the staged tile (tile points at its word 0 of the
// stage; validity words, when staged, at tile[bits * kTileLanes]).
template <typename Fold>
__device__ __forceinline__ void walk_tiles(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                                           const uint32_t* __restrict__ valid, long long ng, int bits, int stages,
                                           Fold&& fold) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kBarrierBytes);
  const int pieces = bits + (valid != nullptr);
  const int stage_words = pieces * kTileLanes;
  const long long tiles = ng * kTilesPerGroup;
  const long long first = blockIdx.x, step = gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) barrier_init(bars + s);
    barrier_init_fence();
  }
  __syncthreads();
  // warp 0: the tile t into stage s
  const auto issue = [&](long long t, int s) {
    const long long g = t / kTilesPerGroup;
    const int j = static_cast<int>(t % kTilesPerGroup) * kTileLanes;
    uint64_t* bar = bars + s;
    uint32_t* dst = ring + s * stage_words;
    const int lane = threadIdx.x;
    if (lane == 0) barrier_expect(bar, static_cast<uint32_t>(pieces) * kPieceBytes);
    __syncwarp();
    for (int w = lane; w < pieces; w += 32) {
      const uint32_t* src =
          w < bits ? packed + (g * bits + w) * kLanes + j : valid + g * kLanes + j;  // w == bits: validity
      bulk_load(dst + w * kTileLanes, src, kPieceBytes, bar);
    }
  };
  const auto ref_of = [&](long long t) -> uint32_t {
    return refs_g != nullptr && t < tiles ? static_cast<uint32_t>(__ldg(refs_g + t / kTilesPerGroup)) : 0u;
  };
  // Tile t = first + k * step is this block's tile k; ahead = its tile k +
  // stages - 1, in stage fill. No division in the loop: the stage and the
  // barrier's phase parity advance with k.
  long long ahead = first;
  for (int s = 0; s < stages - 1; ++s, ahead += step) {
    if (threadIdx.x < 32 && ahead < tiles) issue(ahead, s);
  }
  int stage = 0, fill = stages - 1;
  uint32_t parity = 0;
  uint32_t ref_next = ref_of(first);
  for (long long t = first; t < tiles; t += step, ahead += step) {
    if (threadIdx.x < 32 && ahead < tiles) issue(ahead, fill);
    const uint32_t ref = ref_next;
    ref_next = ref_of(t + step);
    barrier_wait(bars + stage, parity);
    fold(t / kTilesPerGroup, static_cast<int>(t % kTilesPerGroup) * kTileLanes + static_cast<int>(threadIdx.x),
         ring + stage * stage_words + threadIdx.x, ref);
    __syncthreads();
    fill = stage;  // the stage just freed takes the next tile ahead
    if (++stage == stages) {
      stage = 0;
      parity ^= 1u;
    }
  }
}

// K16. Replaces the Pallas kernel at giddy_tpu/query.py:72
// _epilogue_filter_call (body :88-96, call :115-122): fused LMP unpack (+
// the group's FOR reference), compare with a runtime scalar, LMP(1) bitmap
// out: bit i of word [g, c] = pred(value at g * GROUP + i * 1024 + c).
// Bound: device-memory bytes. A value reads B/8 bytes of packed words and
// writes 1 bit; at configs[0] (9 bits, 2^28 values) that is 302 MB in and
// 33.5 MB out, 0.1002 ms at 3.35 TB/s.
// The first design (one block of 1024 threads a group, each lane walked by
// gt::LaneReader from device memory) ran at 0.46 of that bound. One load
// in flight a warp (~1.1 MB on the card, where HBM needs ~2 MB) was the
// suspect, but staging alone did not move it: the same LaneReader walk
// over tiles staged as below ran no faster. What bounded it was the fold's
// integer instructions, ~17 a slot (the walk's offset arithmetic and
// branch, the mask, the ref add, the key's shifts, a compare, a select and
// an OR), against 16 integer lanes in each of an SM's four schedulers.
// This design stages tiles through walk_tiles and cuts a slot to ~10
// instructions: gt::SmemLaneReader takes every offset from a kernel
// argument (two shared-memory loads, a funnel shift, the mask), the ref add
// runs on the multiply-add pipe, a 32-bit signed key needs no sign
// extension (by_width), and the hit is a compare and a predicated OR.
// Measured (scripts/fold_ab_torch.py; H100 SXM at 700 W): 0.1295 ms at
// configs[0], 0.77 of the bound, against the first design's 0.2189; the
// two loads a slot (64 KB of shared-memory reads a 9 KB tile) and the
// integer pipe are now both near their rates. Thread c stores its word
// once, a coalesced 4-byte store. key is the staged comparison value's
// order key, a kernel argument. The optional validity words (nullable
// columns) are staged with the tile and ANDed in before the store. Pad
// bits past n are whatever the compare gives, as in the reference. Op and
// Kind are template arguments, so the slot loop has no branch on them.
template <Kind K, Op O>
__global__ void __launch_bounds__(kTileLanes, 4)
    filter_fold_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                       const uint32_t* __restrict__ valid, uint32_t* __restrict__ out, long long ng, int bits,
                       int stages, int width, int32_t key, __grid_constant__ const LaneSlots slots) {
  const uint32_t sext = sext_selector(width);
  by_width<K>(width, [&](auto narrow) {
    constexpr bool kNarrow = decltype(narrow)::value;
    walk_tiles(packed, refs_g, valid, ng, bits, stages, [&](long long g, int lane, const uint32_t* tile, uint32_t ref) {
      const SmemLaneReader r{reinterpret_cast<const unsigned char*>(tile), slots};
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        word = or_if<O>(word, order_key<K, kNarrow>(r.slot(i) + ref, sext), key, 1u << i);
      }
      if (valid != nullptr) word &= tile[bits * kTileLanes];
      out[g * kLanes + lane] = word;
    });
  });
}

// K17. Replaces the Pallas kernel at giddy_tpu/aggregate.py:104
// _epilogue_agg_call (body :124-148 through _slot_fold :70-101, call
// :175-183): fused unpack (+ ref), then per (group, lane) the sum as (lo,
// hi, neg) -- lo the unsigned sum mod 2^32, hi its carries out, neg the
// count of sign bits (signed kinds) -- or the min / max order key, from
// INT_MAX / INT_MIN. A value takes part when its position is < n and, for
// the sum of a nullable column, when its validity bit is set (min/max take
// no validity: the canonical fill repeats valid values only).
// Bound: device-memory bytes. A value reads B/8 bytes; the partials are
// 3 x 4 B a lane for the sum (at configs[0] 302 MB in, 3 x 33.5 MB out,
// 0.1202 ms at 3.35 TB/s), 4 B a lane for min/max. The first design, K16's
// lane walk from device memory, ran at 0.40 of it, bound like K16's by its
// integer instructions. This one is K16's staged walk and slot reader,
// with the sum in one 64-bit register (lo and its carries) and the slot
// tests (position < n, validity) skipped by warps whose lanes take every
// slot. Measured (scripts/fold_ab_torch.py; H100 SXM at 700 W): sum
// 0.1524 ms at configs[0], 0.79 of the bound (first design 0.3004), min
// 0.1302 (0.2437). One coalesced store of each partial per lane. The host
// finishes the exact sum in 64-bit integers; folding the lanes further
// inside the block, which would cut the 100 MB of sum partials, changes
// what the kernel returns and is left for a later change (ROADMAP, queue
// 1 item 10).
template <Kind K, Agg A>
__global__ void __launch_bounds__(kTileLanes, 4)
    agg_fold_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                    const uint32_t* __restrict__ valid, uint32_t* __restrict__ out0, uint32_t* __restrict__ out1,
                    uint32_t* __restrict__ out2, long long ng, int bits, int stages, int width, long long n,
                    __grid_constant__ const LaneSlots slots) {
  const uint32_t sext = sext_selector(width);
  by_width<K>(width, [&](auto narrow) {
    [[maybe_unused]] constexpr bool kNarrow = decltype(narrow)::value;
    walk_tiles(packed, refs_g, valid, ng, bits, stages, [&](long long g, int lane, const uint32_t* tile, uint32_t ref) {
      const SmemLaneReader r{reinterpret_cast<const unsigned char*>(tile), slots};
      // slot i sits at position g * GROUP + i * kLanes + lane: the lane's
      // first `live` slots are < n (all 32 in every group but the last)
      const long long rest = n - (g * kGroup + lane);
      const int live = rest <= 0 ? 0 : rest >= kGroup ? kSlots : static_cast<int>((rest + kLanes - 1) / kLanes);
      const size_t o = g * kLanes + lane;
      if constexpr (A == Agg::kSum) {
        uint32_t take = live == kSlots ? 0xFFFFFFFFu : (1u << live) - 1u;
        if (valid != nullptr) take &= tile[bits * kTileLanes];
        unsigned long long sum = 0;  // lo: the sum mod 2^32, hi: its carries out
        uint32_t neg = 0;
        const auto fold = [&](auto every) {
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            const uint32_t x = r.slot(i) + ref;
            const uint32_t v = decltype(every)::value || (take >> i) & 1u ? x : 0u;
            if constexpr (K == Kind::kSigned) neg += kNarrow ? (v >> (width - 1)) & 1u : v >> 31;
            sum += v;
          }
        };
        // a warp whose lanes take every slot (no nulls, not the last group)
        // tests no slot; the same for min and max below
        if (__all_sync(kFullMask, take == 0xFFFFFFFFu)) {
          fold(std::true_type{});
        } else {
          fold(std::false_type{});
        }
        out0[o] = static_cast<uint32_t>(sum);
        out1[o] = static_cast<uint32_t>(sum >> 32);
        out2[o] = neg;
      } else {
        int32_t acc = A == Agg::kMax ? INT_MIN : INT_MAX;
        const auto fold = [&](auto every) {
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            const int32_t k = order_key<K, kNarrow>(r.slot(i) + ref, sext);
            if (decltype(every)::value || i < live) acc = A == Agg::kMax ? max(acc, k) : min(acc, k);
          }
        };
        if (__all_sync(kFullMask, live == kSlots)) {
          fold(std::true_type{});
        } else {
          fold(std::false_type{});
        }
        out0[o] = static_cast<uint32_t>(acc);
      }
    });
  });
}

// K19. Replaces no TPU kernel: the reference scans rle and rpe columns on
// its general path (giddy_tpu/query.py:310-320: decode, compare, pack), and
// the port did the same with K5 and torch ops. A predicate on a run-length
// column is a predicate on its runs. K19 reads the tile-form run tables of
// the host prep (kernels/rle.py tile_prep, K5's input) and writes the
// LMP(1) bitmap: bit i of word [g, c] = order_key(value at position
// g * GROUP + i * 1024 + c) <op> key, the value being K5's, vals[#{m <
// w_pad - 1 : ends[m] <= j}] at tile position j (pad positions too),
// ANDed with the validity word when one is given. The decoded column never
// exists.
// Bound: device-memory bytes, the 4 bytes a word written and the tables
// read once. At SSB lineorder SF 100 (600M rows, 18,312 groups of one
// tile of 8 runs) that is 75 MB out and 1.2 MB in, 22.8 us at 3.35 TB/s;
// the general path moved ~15 GB a call for the same bitmap.
// Design: a warp owns a quarter group, 256 words, 8 a lane, and visits the
// tiles its words' positions lie in (W >= 1024: every tile, each covering
// S = W / 1024 consecutive slots of every lane; W = 512: the 32 tiles of
// its half of the lanes, one slot each). For each tile it
// (1) compares each entry's value once, entry 32 q + lane in lane `lane`,
//     one ballot a 32 entries giving the tile's hit bits h;
// (2) keeps the entries m < w_pad - 1 at which the hit flips (h[m] !=
//     h[m + 1]) and whose end lies before W, their ends compacted in order
//     into the warp's slice of shared memory: F flips. As the ends do not
//     decrease, position j holds h[0] XOR the parity of the flips at ends
//     <= j (h[m] ^ h[m + 1] telescopes to K5's run), so no run is searched;
// (3) sets the tile's S bits of each of its words from h[0], then, where
//     F <= 2 S, XORs in for each flip at e the bits of the slots whose
//     position is >= e (the slots from ceil((e - c) / 1024): a contiguous
//     range), F steps a word; else, slot by slot, marks the flips that fall
//     among the warp's 256 positions of the slot in eight 32-bit window
//     masks (an XOR reduction across the warp a window, 32 flips a round)
//     and counts the rest below it, so that each bit is the parity of a
//     popcount: no search, no dependent load. The choice is the warp's.
// A column clustered on its key flips at most twice for a range predicate,
// so nearly every tile takes h[0] alone and the stores bound the kernel.
// A first design searched the flips at each position (7 dependent shared
// loads a bit): 0.296 ms at T = 32 of w_pad 128 over 2^26 rows, 2.5 times
// K5 (H100 SXM at 700 W). Each thread stores its 8 words once, each a
// coalesced warp store.
constexpr int kRunFilterWarps = 8;                         // warps a block
constexpr int kRunFilterLanes = kLanes / 4;                // words a warp: a quarter group
constexpr int kRunFilterWords = kRunFilterLanes / 32;      // words a thread
constexpr int kRunTableMax = 128;                          // the largest w_pad, CHAIN_HARD of the host prep

bool valid_run_table(int w_shift, int w_pad);  // csrc/run_decode.cu, K5's check of the same tables

// Bits b .. 31 of a word, none for b >= 32.
__device__ __forceinline__ uint32_t bits_from(int b) { return b >= 32 ? 0u : ~0u << b; }

template <Kind K, Op O>
__global__ void __launch_bounds__(32 * kRunFilterWarps)
    run_filter_kernel(const int32_t* __restrict__ ends_w, const uint32_t* __restrict__ vals_w,
                      const uint32_t* __restrict__ valid, uint32_t* __restrict__ out, long long ng, int w_shift,
                      int w_pad, int width, int32_t key) {
  __shared__ int32_t flips[kRunFilterWarps][kRunTableMax];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long unit = static_cast<long long>(blockIdx.x) * kRunFilterWarps + warp;  // a quarter group
  if (unit >= 4 * ng) return;
  const long long g = unit >> 2;
  const int c0 = static_cast<int>(unit & 3) * kRunFilterLanes + lane;  // the thread's word k is lane c0 + 32 k
  const uint32_t sext = sext_selector(width);
  const int tiles = kGroup >> w_shift;
  const bool halves = w_shift < 10;  // W = 512: slot i of lane c lies in tile 2 i + c / 512
  const int visits = halves ? kSlots : tiles;
  const int span = halves ? 1 : 1 << (w_shift - 10);  // S
  const int entries = (w_pad + 31) >> 5;              // entries a lane
  const int jc = halves ? c0 & 511 : c0;              // the position in its tile of the thread's word 0 at slot 0
  const int window = jc - lane;                       // of the warp's: its words are at window + 32 k + lane
  int32_t* fl = flips[warp];
  uint32_t words[kRunFilterWords] = {};
#pragma unroll 1
  for (int v = 0; v < visits; ++v) {
    const long long row = g * tiles + (halves ? 2 * v + (c0 >> 9) : v);
    int32_t e[4];
    uint32_t hit[5] = {};  // hit[4]: no entries past the table
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = 32 * q + lane;
      e[q] = INT_MAX;
      bool h = false;
      if (q < entries) {
        if (m < w_pad) {
          e[q] = __ldg(ends_w + row * w_pad + m);
          const int32_t k = order_key<K, K == Kind::kSigned>(__ldg(vals_w + row * w_pad + m), sext);
          h = or_if<O>(0u, k, key, 1u) != 0u;
        }
        hit[q] = __ballot_sync(kFullMask, h);
      }
    }
    __syncwarp();  // the tile before has read its flips
    int count = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < entries) {
        const int m = 32 * q + lane;
        const uint32_t next = lane < 31 ? hit[q] >> (lane + 1) : hit[q + 1];
        const bool flip = m < w_pad - 1 && e[q] < (1 << w_shift) && (((hit[q] >> lane) ^ next) & 1u);
        const uint32_t ballot = __ballot_sync(kFullMask, flip);
        if (flip) fl[count + __popc(ballot & ((1u << lane) - 1u))] = max(e[q], 0);
        count += __popc(ballot);
      }
    }
    __syncwarp();
    const int k0 = v * span;  // the tile's first slot
    const uint32_t tile_bits = span == kSlots ? ~0u : ((1u << span) - 1u) << k0;
    const bool h0 = hit[0] & 1u;
#pragma unroll
    for (int k = 0; k < kRunFilterWords; ++k) words[k] |= h0 ? tile_bits : 0u;
    if (count <= 2 * span) {
#pragma unroll 1
      for (int f = 0; f < count; ++f) {
        const int32_t end = fl[f];
#pragma unroll
        for (int k = 0; k < kRunFilterWords; ++k) {
          words[k] ^= tile_bits & bits_from(k0 + ((end - (jc + 32 * k) + 1023) >> 10));
        }
      }
    } else {
      const uint32_t upto = (2u << lane) - 1u;  // bits 0 .. lane
#pragma unroll 1
      for (int s = 0; s < span; ++s) {
        const int first = s * 1024 + window;  // the warp's positions of slot k0 + s: first .. first + 255
        uint32_t below = 0;                   // its parity: the flips before them
        uint32_t marks[kRunFilterWords] = {};
#pragma unroll 1
        for (int f = lane; f - lane < count; f += 32) {
          const int d = f < count ? fl[f] - first : kRunFilterLanes;
          below ^= __ballot_sync(kFullMask, d < 0);
#pragma unroll
          for (int k = 0; k < kRunFilterWords; ++k) {
            marks[k] ^= __reduce_xor_sync(kFullMask, d >> 5 == k ? 1u << (d & 31) : 0u);
          }
        }
        uint32_t parity = __popc(below) & 1u;
#pragma unroll
        for (int k = 0; k < kRunFilterWords; ++k) {
          words[k] ^= (parity ^ (__popc(marks[k] & upto) & 1u)) << (k0 + s);
          parity ^= __popc(marks[k]) & 1u;
        }
      }
    }
  }
  const size_t o = g * kLanes + c0;
#pragma unroll
  for (int k = 0; k < kRunFilterWords; ++k) {
    out[o + 32 * k] = valid != nullptr ? words[k] & __ldg(valid + o + 32 * k) : words[k];
  }
}

using FilterKernel = void (*)(const uint32_t*, const int32_t*, const uint32_t*, uint32_t*, long long, int, int, int,
                              int32_t, LaneSlots);
using RunFilterKernel = void (*)(const int32_t*, const uint32_t*, const uint32_t*, uint32_t*, long long, int, int, int,
                                 int32_t);
using AggKernel = void (*)(const uint32_t*, const int32_t*, const uint32_t*, uint32_t*, uint32_t*, uint32_t*,
                           long long, int, int, int, long long, LaneSlots);

template <Kind K>
FilterKernel filter_instance(int op) {
  switch (op) {
    case 0: return filter_fold_kernel<K, Op::kEq>;
    case 1: return filter_fold_kernel<K, Op::kNe>;
    case 2: return filter_fold_kernel<K, Op::kLt>;
    case 3: return filter_fold_kernel<K, Op::kLe>;
    case 4: return filter_fold_kernel<K, Op::kGt>;
    case 5: return filter_fold_kernel<K, Op::kGe>;
    default: return nullptr;
  }
}

template <Kind K>
AggKernel agg_instance(int agg) {
  switch (agg) {
    case 0: return agg_fold_kernel<K, Agg::kSum>;
    case 1: return agg_fold_kernel<K, Agg::kMin>;
    case 2: return agg_fold_kernel<K, Agg::kMax>;
    default: return nullptr;
  }
}

template <Kind K>
RunFilterKernel run_filter_instance(int op) {
  switch (op) {
    case 0: return run_filter_kernel<K, Op::kEq>;
    case 1: return run_filter_kernel<K, Op::kNe>;
    case 2: return run_filter_kernel<K, Op::kLt>;
    case 3: return run_filter_kernel<K, Op::kLe>;
    case 4: return run_filter_kernel<K, Op::kGt>;
    case 5: return run_filter_kernel<K, Op::kGe>;
    default: return nullptr;
  }
}

// Picks the instance for a runtime (kind, op or agg): kind 0 'u', 1 'i', 2 'f'.
template <typename KernelT, typename F>
KernelT by_kind(int kind, F&& pick) {
  switch (kind) {
    case 0: return pick(std::integral_constant<Kind, Kind::kUnsigned>{});
    case 1: return pick(std::integral_constant<Kind, Kind::kSigned>{});
    case 2: return pick(std::integral_constant<Kind, Kind::kFloat>{});
    default: return nullptr;
  }
}

inline bool valid_itemsize(int itemsize) { return itemsize == 1 || itemsize == 2 || itemsize == 4; }

// Checks a walk's stages and grid, lets kernel take the ring's dynamic
// shared memory (gt::allow_staging; an error when the ring does not fit)
// and launches it.
template <typename KernelT, typename... Args>
int launch_walk(KernelT kernel, long long ng, int bits, bool nullable, int stages, int grid, void* stream,
                Args... args) {
  if (stages < 2 || stages > kMaxStages || grid < 1 || grid > ng * kTilesPerGroup) return cudaErrorInvalidValue;
  const size_t smem = kBarrierBytes + static_cast<size_t>(stages) * (bits + nullable) * kPieceBytes;
  const cudaError_t err = allow_staging(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTileLanes, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace gt

extern "C" {

// packed: (ng, bits * 1024) words; refs_g: (ng,) int32 or nullptr; valid:
// (ng, 1024) words or nullptr; out: (ng, 1024) words. packed and valid are
// 16-byte aligned (the bulk copies' requirement). kind as above, itemsize
// the logical dtype's bytes, op 0-5 = eq, ne, lt, le, gt, ge, key the
// comparison value's order key; stages (2-16) the ring's depth and grid
// (1 to 4 * ng) the persistent blocks, as kernels/_wrap.scan_plan picks
// them.
int gt_filter_fold(const void* packed, const void* refs_g, const void* valid, void* out, long long ng, int bits,
                   int kind, int itemsize, int op, int key, int stages, int grid, void* stream) {
  if (!gt::valid(ng, bits) || !gt::valid_itemsize(itemsize)) return cudaErrorInvalidValue;
  const gt::FilterKernel kernel =
      gt::by_kind<gt::FilterKernel>(kind, [&](auto k) { return gt::filter_instance<decltype(k)::value>(op); });
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return gt::launch_walk(kernel, ng, bits, valid != nullptr, stages, grid, stream,
                         static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(refs_g),
                         static_cast<const uint32_t*>(valid), static_cast<uint32_t*>(out), ng, bits, stages,
                         8 * itemsize, static_cast<int32_t>(key), gt::lane_slots(bits));
}

// agg 0 = sum (out0, out1, out2 = lo, hi, neg), 1 = min, 2 = max (out0 =
// keys; out1, out2 unused); n the column's length, 0 <= n <= ng * GROUP;
// the rest as gt_filter_fold.
int gt_agg_fold(const void* packed, const void* refs_g, const void* valid, void* out0, void* out1, void* out2,
                long long ng, int bits, long long n, int kind, int itemsize, int agg, int stages, int grid,
                void* stream) {
  if (!gt::valid(ng, bits) || !gt::valid_itemsize(itemsize) || n < 0 || n > ng * gt::kGroup)
    return cudaErrorInvalidValue;
  if (agg == 0 && (out1 == nullptr || out2 == nullptr)) return cudaErrorInvalidValue;
  const gt::AggKernel kernel =
      gt::by_kind<gt::AggKernel>(kind, [&](auto k) { return gt::agg_instance<decltype(k)::value>(agg); });
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return gt::launch_walk(kernel, ng, bits, valid != nullptr, stages, grid, stream,
                         static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(refs_g),
                         static_cast<const uint32_t*>(valid), static_cast<uint32_t*>(out0),
                         static_cast<uint32_t*>(out1), static_cast<uint32_t*>(out2), ng, bits, stages,
                         8 * itemsize, n, gt::lane_slots(bits));
}

// ends_w, vals_w: the tile-form run tables, (ng << (15 - w_shift), w_pad)
// int32, tile t of group g in row g * T + t; valid: (ng, 1024) words or
// nullptr; out: (ng, 1024) words. w_shift 9-15 (W = 2^w_shift positions a
// tile), w_pad a power of two <= 128; kind, itemsize, op and key as
// gt_filter_fold. A block of 8 warps, a warp a quarter group.
int gt_run_filter(const void* ends_w, const void* vals_w, const void* valid, void* out, long long ng, int w_shift,
                  int w_pad, int kind, int itemsize, int op, int key, void* stream) {
  if (!gt::valid(ng, 1) || !gt::valid_run_table(w_shift, w_pad) || !gt::valid_itemsize(itemsize))
    return cudaErrorInvalidValue;
  const gt::RunFilterKernel kernel =
      gt::by_kind<gt::RunFilterKernel>(kind, [&](auto k) { return gt::run_filter_instance<decltype(k)::value>(op); });
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const long long blocks = (4 * ng + gt::kRunFilterWarps - 1) / gt::kRunFilterWarps;
  kernel<<<static_cast<unsigned>(blocks), 32 * gt::kRunFilterWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ends_w), static_cast<const uint32_t*>(vals_w), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), ng, w_shift, w_pad, 8 * itemsize, static_cast<int32_t>(key));
  return cudaGetLastError();
}

}  // extern "C"
