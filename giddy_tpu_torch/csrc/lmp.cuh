// Lane-major packed-group (LMP) reading and writing on the device (FORMAT.md
// §0.1).
//
// A group holds GROUP = 32 * 1024 values. Lane c of the group is CUDA thread
// c of the block that decodes it. The lane's B-bit values live in B words at
// word offsets w * 1024 + c of the group's packed row, so a warp's loads of
// word w touch 32 neighbouring words (one 128-byte line). Slot i of the lane
// is bits [i*B, (i+1)*B) of those B words, stitched across two words where
// it straddles one, and decodes to linear position i * 1024 + c, so a
// warp's stores of slot i are coalesced too.
//
// LaneWriter is the inverse, for the pack of device encode (K18). Also
// here: the block-row scan every per-GROUP prefix kernel shares, the
// fused dictionary stage (Lut), the exception phase of K9 and K12
// (patch_group), the bulk async copies and mbarriers of the staging
// kernels, and the host-side argument checks, shared-memory opt-ins,
// output-type and table-mode dispatch of the entry points.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace gt {

constexpr int kLanes = 1024;
constexpr int kSlots = 32;
constexpr int kGroup = kLanes * kSlots;

// Unsigned zigzag -> signed value, as uint32 bits (FORMAT.md §0.2).
__device__ __forceinline__ uint32_t unzigzag(uint32_t z) { return (z >> 1) ^ (0u - (z & 1u)); }

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Combines of the block-row scan: Scan::T is the value scanned and
// Scan::combine an associative, commutative operation on it. Scan::span(t,
// k), with lane l of a warp holding the scan t of warp l's 32 values of the
// row, gives every lane the scan of warps 0 .. k-1 (warp reductions, no
// shuffles). All wrap mod 2^32.
struct AddScan {
  using T = uint32_t;
  static __device__ __forceinline__ T combine(T a, T b) { return a + b; }
  static __device__ __forceinline__ T span(T t, int k) {
    return __reduce_add_sync(kFullMask, static_cast<int>(threadIdx.x & 31) < k ? t : 0u);
  }
};

struct XorScan {
  using T = uint32_t;
  static __device__ __forceinline__ T combine(T a, T b) { return a ^ b; }
  static __device__ __forceinline__ T span(T t, int k) {
    return __reduce_xor_sync(kFullMask, static_cast<int>(threadIdx.x & 31) < k ? t : 0u);
  }
};

// Two prefix sums side by side (delta2's sum(s_k) and sum(k * s_k), K7's
// scan of its chunk totals).
struct PairAddScan {
  using T = uint2;
  static __device__ __forceinline__ T combine(T a, T b) { return make_uint2(a.x + b.x, a.y + b.y); }
  static __device__ __forceinline__ T span(T t, int k) {
    const bool in = static_cast<int>(threadIdx.x & 31) < k;
    return make_uint2(__reduce_add_sync(kFullMask, in ? t.x : 0u), __reduce_add_sync(kFullMask, in ? t.y : 0u));
  }
};

__device__ __forceinline__ uint32_t shfl_up(uint32_t v, int d) { return __shfl_up_sync(kFullMask, v, d); }
__device__ __forceinline__ uint2 shfl_up(uint2 v, int d) { return make_uint2(shfl_up(v.x, d), shfl_up(v.y, d)); }

// One row of a per-GROUP inclusive scan. A group's linear order is 32 rows
// (slots) of 1024 values, value row * 1024 + c in thread c, so the group's
// scan is 32 block scans with a carry from row to row. Every thread of the
// block calls this once per row, rows in order, with its value x; it
// returns carry (+) the scan of the row up to this thread and moves carry
// past the whole row. carry starts as the scan of what comes before the
// group (an anchor, or the identity).
//
// Per row: a 5-step __shfl_up_sync warp scan, the 32 warp totals through
// shared memory, one __syncthreads; every warp then reduces the 32 totals
// itself (Scan::span, __reduce_*_sync), so there is no second barrier. The
// shuffle unit is what bounds these kernels on the H100 (one warp shuffle
// per clock per SM), and the reductions take the place of a second 5-step
// shuffle scan and two broadcasts per warp and row. The totals are
// double-buffered by row parity (totals[2][32] in shared memory), which
// keeps a fast warp writing row i+1 from racing a slow warp still reading
// row i.
template <typename Scan>
__device__ __forceinline__ typename Scan::T block_row_scan(typename Scan::T x, typename Scan::T& carry,
                                                           typename Scan::T (*totals)[32], int row) {
  using T = typename Scan::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = shfl_up(x, off);
    if (lane >= off) x = Scan::combine(y, x);
  }
  T* row_totals = totals[row & 1];
  if (lane == 31) row_totals[warp] = x;
  __syncthreads();
  const T t = row_totals[lane];
  const T before = Scan::span(t, warp);  // warps 0 .. warp-1 of the row
  const T row_total = Scan::span(t, 32);
  const T out = Scan::combine(carry, warp > 0 ? Scan::combine(before, x) : x);
  carry = Scan::combine(carry, row_total);
  return out;
}

inline bool valid(long long ng, int bits) { return ng >= 1 && ng <= INT_MAX && bits >= 1 && bits <= 32; }

// Calls f with a value of the output element type that out_bytes names:
// 4 stores the uint32 payload, 2 and 1 its low 16 or 8 bits.
template <typename F>
int dispatch_out(int out_bytes, F&& f) {
  switch (out_bytes) {
    case 4: return f(uint32_t{});
    case 2: return f(uint16_t{});
    case 1: return f(uint8_t{});
    default: return cudaErrorInvalidValue;
  }
}

// Reads the 32 slots of one lane in order, loading each of its B words from
// device memory exactly once. B is a runtime value in [1, 32].
struct LaneReader {
  const uint32_t* words;  // the lane's word 0; word w is words[w * kLanes]
  int bits;
  uint32_t mask;
  uint32_t cur;  // word w
  int w;
  int s;  // bit offset of the next slot in cur, always in [0, 31]

  __device__ __forceinline__ LaneReader(const uint32_t* lane_words, int b)
      : words(lane_words),
        bits(b),
        mask(b == 32 ? 0xFFFFFFFFu : ((1u << b) - 1u)),
        cur(__ldg(lane_words)),
        w(0),
        s(0) {}

  __device__ __forceinline__ uint32_t next() {
    uint32_t v = cur >> s;  // s < 32: never a shift by the word width
    const int end = s + bits;
    if (end >= 32) {  // the slot uses up word w
      ++w;
      // after the last slot w == bits: there is no word to load
      const uint32_t nxt = w < bits ? __ldg(words + (size_t)w * kLanes) : 0u;
      // straddling slot: end > 32 forces s >= 1, so 32 - s is in [1, 31]
      if (end > 32) v |= nxt << (32 - s);
      cur = nxt;
      s = end - 32;
    } else {
      s = end;
    }
    return v & mask;
  }
};

// Lanes of a tile of K16 and K17 (csrc/scan_epilogue.cu): the tile of a
// group's packed words that a block stages in shared memory.
constexpr int kTileLanes = 256;

// Where the 32 slots of an LMP(B) lane lie in its words, the same for
// every lane: slot i is bits [s, s + B) of word w0 and, where it
// straddles, the low bits of word w0 + 1, with (w0, s) = divmod(i * B,
// 32). Built on the host (lane_slots) and passed as a kernel argument, so
// each entry is a uniform operand of the slot's instructions.
struct LaneSlots {
  uint32_t lo[kSlots];     // byte offset of word w0 in a tile lane: w0 * kTileLanes * 4
  uint32_t hi[kSlots];     // of word w0 + 1 where slot i straddles, else of w0 again
  uint32_t shift[kSlots];  // s
  uint32_t mask;           // the low B bits
};

inline LaneSlots lane_slots(int bits) {
  LaneSlots t{};
  for (int i = 0; i < kSlots; ++i) {
    const int o = i * bits, w = o >> 5, s = o & 31;
    t.lo[i] = static_cast<uint32_t>(w * kTileLanes * 4);
    t.hi[i] = static_cast<uint32_t>((s + bits > 32 ? w + 1 : w) * kTileLanes * 4);
    t.shift[i] = static_cast<uint32_t>(s);
  }
  t.mask = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  return t;
}

// Reads slot i of one lane of a tile staged in shared memory, word w of
// the lane at words[w * kTileLanes] (K16, K17): two loads (word w0 twice
// where the slot does not straddle), a funnel shift and the mask. Every
// offset is a kernel argument, uniform across the warp, so the vector
// pipes do no offset arithmetic and take no branch; LaneReader's walk
// carries its bit offset in a register and branches at every slot.
struct SmemLaneReader {
  const unsigned char* words;  // the lane's word 0, in shared memory
  const LaneSlots& at;

  __device__ __forceinline__ uint32_t slot(int i) const {
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(words + at.lo[i]);
    const uint32_t hi = *reinterpret_cast<const uint32_t*>(words + at.hi[i]);
    return __funnelshift_r(lo, hi, at.shift[i]) & at.mask;
  }
};

// Writes the 32 slots of one lane in order, the inverse of LaneReader: slot
// i is ORed into the word at the bit offset (w0, s) = divmod(i * B, 32),
// as v << s into word w0 and, where it straddles, v >> (32 - s) into word
// w0 + 1 (giddy_tpu/kernels/encode.py:28-42 pack_lanes_to). Each finished
// word is stored once, at words[w * kLanes], so a warp's stores of word w
// coalesce. B is a template argument: with put() called for i = 0..31 in
// a fully unrolled loop every offset is a constant. Values are not masked
// to B bits, as in the reference, so an out-of-range value spills into the
// bits after its slot the same way on both. s + B > 32 forces s >= 1, so
// no shift is by 32.
template <int B>
struct LaneWriter {
  static_assert(B >= 1 && B <= 32, "LMP width");
  uint32_t* words;  // the lane's word 0; word w is words[w * kLanes]
  uint32_t cur = 0u;  // the word being filled

  __device__ __forceinline__ explicit LaneWriter(uint32_t* lane_words) : words(lane_words) {}

  __device__ __forceinline__ void put(int i, uint32_t v) {
    const int w0 = (i * B) >> 5;
    const int s = (i * B) & 31;
    cur |= v << s;
    if (s + B >= 32) {  // the slot fills word w0; slot 31 always ends word B - 1
      words[static_cast<size_t>(w0) * kLanes] = cur;
      cur = s + B > 32 ? v >> (32 - s) : 0u;
    }
  }
};

// The fused dictionary stage of cascade decode. Replaces the gather_lut
// stage that giddy_tpu/kernels/cascade.py:30 passes into its inner kernels
// (common.py:196-214, lanes.py:124). A kernel templated on Lut<M> maps
// every value it would store through values[min(code, d - 1)] (K4's clamp
// for malformed codes) while the code is still 32 bits wide; only the
// looked-up value is narrowed to the store type. kNone is the plain kernel;
// kShared reads a copy of the table in the block's dynamic shared memory,
// kGlobal reads it through the read-only cache.
enum class LutMode { kNone, kShared, kGlobal };

template <LutMode M>
struct Lut {
  const uint32_t* table;
  uint32_t last;  // d - 1

  // Every thread of the block constructs it once, before any lookup. In
  // kShared mode the block copies the d entries into smem and waits.
  __device__ __forceinline__ Lut(const uint32_t* values, uint32_t d, uint32_t* smem) : table(values), last(d - 1u) {
    if constexpr (M == LutMode::kShared) {
      for (uint32_t j = threadIdx.x; j < d; j += blockDim.x) smem[j] = __ldg(values + j);
      __syncthreads();
      table = smem;
    }
  }

  __device__ __forceinline__ uint32_t operator()(uint32_t code) const {
    if constexpr (M == LutMode::kNone) {
      return code;
    } else if constexpr (M == LutMode::kShared) {
      return table[min(code, last)];
    } else {
      return __ldg(table + min(code, last));
    }
  }
};

// The body of K1, K2 and phase 1 of K9: thread c unpacks lane c of group
// blockIdx.x, adds ref (wrapping; 0 for a plain unpack), maps each value
// through the table and stores it at T. Loads and stores are warp-
// coalesced by the LMP layout and each word is read once.
template <typename T, LutMode M>
__device__ __forceinline__ void unpack_store_lane(const uint32_t* __restrict__ packed, T* __restrict__ out, int bits,
                                                  uint32_t ref, const Lut<M>& map) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  LaneReader r(packed + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) o[i * kLanes] = static_cast<T>(map(r.next() + ref));
}

// The exception phase of K9 and K12: writes the exceptions of group
// blockIdx.x, out[pos[j]] = T(val[j]), over the values the block has just
// stored. pos is strictly ascending, so the group's exceptions are the
// range [lo, hi) of the stream: threads 0 and 1 binary-search pos for the
// group's first and one-past-last position and pass lo and hi through
// shared memory. One __syncthreads() then orders the block's own device-
// memory writes, so an exception lands after the value it replaces, and
// the block's threads write the range (a narrow store truncates val). A
// position outside the group (malformed input) is dropped. Every thread of
// the block calls it once, after its stores.
template <typename T>
__device__ __forceinline__ void patch_group(const int32_t* __restrict__ pos, const uint32_t* __restrict__ val,
                                            T* __restrict__ out, uint32_t count) {
  __shared__ uint32_t range[2];
  if (count == 0) return;
  const long long first = static_cast<long long>(blockIdx.x) * kGroup;
  if (threadIdx.x < 2) {
    const long long key = first + threadIdx.x * kGroup;
    uint32_t lo = 0, hi = count;  // first j with pos[j] >= key
    while (lo < hi) {
      const uint32_t mid = lo + (hi - lo) / 2;
      if (__ldg(pos + mid) < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    range[threadIdx.x] = lo;
  }
  __syncthreads();
  const uint32_t end = range[1];
  for (uint32_t j = range[0] + threadIdx.x; j < end; j += kLanes) {
    const long long p = __ldg(pos + j);
    if (p >= first && p < first + kGroup) out[p] = static_cast<T>(__ldg(val + j));
  }
}

// Bulk async copies from device memory into shared memory (K13, K14, K16,
// K17): one thread starts a copy of a contiguous run of bytes, and an
// mbarrier in shared memory counts the bytes as they land, so no thread
// spends registers or instructions on the copy and none waits on a copy
// group.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase at one arrival (the expect below) and
// the bytes it expects. After the block's inits, one fence makes them
// visible to the copies (barrier_init_fence).
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from device memory to shared memory, both
// 16-byte aligned; completes on bar's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// Most shared memory one block may opt in to on the current device.
inline int shared_optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return optin;
}

// Lets kernel take `smem` bytes of dynamic shared memory. Without the
// attribute a kernel may take 48 KB less its static shared memory, so a
// kernel with static shared memory (K3's and K6's warp totals, K7's chunk
// table, the dzbv rank table) needs it below 48 KB of dynamic shared memory
// too: it is set for every launch that takes any.
template <typename K>
cudaError_t allow_shared(K kernel, size_t smem) {
  if (smem == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// The opt-in of the staging kernels (K13, K14, K16, K17): kernel may take
// `smem` bytes of dynamic shared memory (an error when they do not fit),
// with the carveout at its most shared memory, so that an SM holds as many
// of its blocks as the staged bytes allow.
template <typename K>
cudaError_t allow_staging(K kernel, size_t smem) {
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// Picks the instance of a LUT-templated kernel for one launch. family is
// {kernel<kNone>, kernel<kShared>, kernel<kGlobal>}. Without a table
// (lut == nullptr) it is kNone; with a d-entry table it is kShared when 4*d
// bytes fit beside the kernel's static shared memory and its own dynamic
// shared memory (`own` bytes, the table after them) in one block, kGlobal
// otherwise. *smem is the dynamic shared memory to launch with, and the
// kernel is opted in to it.
template <typename K>
cudaError_t choose_lut(const K (&family)[3], const void* lut, long long d, K* kernel, size_t* smem, size_t own = 0) {
  *kernel = family[0];
  *smem = own;
  if (lut != nullptr) {
    if (d < 1 || d > 0xFFFFFFFFLL) return cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, family[1]);
    if (err != cudaSuccess) return err;
    const size_t table = static_cast<size_t>(d) * sizeof(uint32_t);
    if (attr.sharedSizeBytes + own + table <= static_cast<size_t>(shared_optin_bytes())) {
      *kernel = family[1];
      *smem = own + table;
    } else {
      *kernel = family[2];
    }
  }
  return allow_shared(*kernel, *smem);
}

}  // namespace gt
