// The scan layer's two fused kernels of giddy_tpu_torch: the filter (K16)
// and the aggregate (K17) that read a packed column (nbit, dzbf, for) and
// never write its decoded form. Plain C interface, bound with ctypes by
// giddy_tpu_torch/kernels/_build.py. Both run one block of 1024 threads per
// GROUP (grid = number of groups); thread c reads lane c of the group
// through gt::LaneReader, as K1 and K2 do, adds the group's frame
// reference (FOR; 0 otherwise) with a uint32 wrap, and folds the lane's 32
// values in registers.
//
// Comparisons and min/max run on an order key (order_key below, the
// counterpart of giddy_tpu/aggregate.py:33-52 _key_map_traced): an int32
// whose signed order is the logical dtype's. The key is a bijection of the
// payload, so eq/ne and the four order compares of giddy_tpu/query.py:51-69
// _cmp (narrow sign-extension, IEEE total order for floats) hold on keys.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.

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

// shift = 32 - 8 * itemsize: a narrow signed payload is stored zero-
// extended, so the shift pair sign-extends it. A float key flips the
// magnitude bits of negatives (IEEE total order, re-biased to signed); an
// unsigned key flips the sign bit.
template <Kind K>
__device__ __forceinline__ int32_t order_key(uint32_t u, int shift) {
  if constexpr (K == Kind::kSigned) {
    return static_cast<int32_t>(u << shift) >> shift;
  } else if constexpr (K == Kind::kFloat) {
    const int32_t s = static_cast<int32_t>(u);
    return s ^ ((s >> 31) & 0x7FFFFFFF);
  } else {
    return static_cast<int32_t>(u ^ 0x80000000u);
  }
}

template <Op O>
__device__ __forceinline__ bool holds(int32_t a, int32_t b) {
  if constexpr (O == Op::kEq) return a == b;
  if constexpr (O == Op::kNe) return a != b;
  if constexpr (O == Op::kLt) return a < b;
  if constexpr (O == Op::kLe) return a <= b;
  if constexpr (O == Op::kGt) return a > b;
  return a >= b;
}

// K16. Replaces the Pallas kernel at giddy_tpu/query.py:72
// _epilogue_filter_call (body :88-96, call :115-122): fused LMP unpack (+
// the group's FOR reference), compare with a runtime scalar, LMP(1) bitmap
// out: bit i of word [g, c] = pred(value at g * GROUP + i * 1024 + c).
// Bound: device-memory bytes. A value reads B/8 bytes of packed words and
// writes 1 bit; at configs[0] (9 bits, 2^28 values) that is 302 MB in and
// 33.5 MB out, ~0.10 ms at 3.35 TB/s. The operations (unpack 3, ref add,
// key 1-2, compare, shift, OR) stay well under the bytes' time. Design:
// thread c ORs hit << i into one register word and stores it once, a
// coalesced 4-byte store per lane (1/32 of a decode's bytes); each packed
// word is read once (LaneReader). key is the staged comparison value's
// order key, a kernel argument: no tensor is read for it. The optional
// validity words (nullable columns) are ANDed in before the store, so a
// nullable scan is one launch. Pad bits past n are whatever the compare
// gives, as in the reference. Op and Kind are template arguments, so the
// slot loop has no branch on them.
template <Kind K, Op O>
__global__ void __launch_bounds__(kLanes)
    filter_fold_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                       const uint32_t* __restrict__ valid, uint32_t* __restrict__ out, int bits, int shift,
                       int32_t key) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t ref = refs_g != nullptr ? static_cast<uint32_t>(__ldg(refs_g + g)) : 0u;
  LaneReader r(packed + g * bits * kLanes + c, bits);
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) word |= static_cast<uint32_t>(holds<O>(order_key<K>(r.next() + ref, shift), key)) << i;
  if (valid != nullptr) word &= __ldg(valid + g * kLanes + c);
  out[g * kLanes + c] = word;
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
// ~0.12 ms at 3.35 TB/s), 4 B a lane for min/max. Design: the same lane
// walk as K16, the accumulators in registers, one coalesced store of each
// partial per lane. The host finishes the exact sum in 64-bit integers;
// folding lanes further inside the block is left for a later change.
template <Kind K, Agg A>
__global__ void __launch_bounds__(kLanes)
    agg_fold_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                    const uint32_t* __restrict__ valid, uint32_t* __restrict__ out0, uint32_t* __restrict__ out1,
                    uint32_t* __restrict__ out2, int bits, int width, long long n) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t ref = refs_g != nullptr ? static_cast<uint32_t>(__ldg(refs_g + g)) : 0u;
  LaneReader r(packed + g * bits * kLanes + c, bits);
  // position of slot i: first + i * kLanes; every slot of a full group is < n
  const long long first = static_cast<long long>(g) * kGroup + c;
  if constexpr (A == Agg::kSum) {
    const uint32_t vw = valid != nullptr ? __ldg(valid + g * kLanes + c) : 0xFFFFFFFFu;
    uint32_t lo = 0, hi = 0, neg = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      uint32_t v = r.next() + ref;
      const bool live = first + i * kLanes < n && ((vw >> i) & 1u);
      v = live ? v : 0u;
      if constexpr (K == Kind::kSigned) neg += (v >> (width - 1)) & 1u;
      const uint32_t lo2 = lo + v;
      hi += lo2 < lo ? 1u : 0u;  // carry out
      lo = lo2;
    }
    out0[g * kLanes + c] = lo;
    out1[g * kLanes + c] = hi;
    out2[g * kLanes + c] = neg;
  } else {
    int32_t acc = A == Agg::kMax ? INT_MIN : INT_MAX;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int32_t k = order_key<K>(r.next() + ref, 32 - width);
      if (first + i * kLanes < n) acc = A == Agg::kMax ? max(acc, k) : min(acc, k);
    }
    out0[g * kLanes + c] = static_cast<uint32_t>(acc);
  }
}

using FilterKernel = void (*)(const uint32_t*, const int32_t*, const uint32_t*, uint32_t*, int, int, int32_t);
using AggKernel = void (*)(const uint32_t*, const int32_t*, const uint32_t*, uint32_t*, uint32_t*, uint32_t*, int,
                           int, long long);

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

}  // namespace gt

using gt::kLanes;

extern "C" {

// packed: (ng, bits * 1024) words; refs_g: (ng,) int32 or nullptr; valid:
// (ng, 1024) words or nullptr; out: (ng, 1024) words. kind as above,
// itemsize the logical dtype's bytes, op 0-5 = eq, ne, lt, le, gt, ge, key
// the comparison value's order key.
int gt_filter_fold(const void* packed, const void* refs_g, const void* valid, void* out, long long ng, int bits,
                   int kind, int itemsize, int op, int key, void* stream) {
  if (!gt::valid(ng, bits) || !gt::valid_itemsize(itemsize)) return cudaErrorInvalidValue;
  const gt::FilterKernel kernel =
      gt::by_kind<gt::FilterKernel>(kind, [&](auto k) { return gt::filter_instance<decltype(k)::value>(op); });
  if (kernel == nullptr) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(refs_g), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), bits, 32 - 8 * itemsize, static_cast<int32_t>(key));
  return cudaGetLastError();
}

// agg 0 = sum (out0, out1, out2 = lo, hi, neg), 1 = min, 2 = max (out0 =
// keys; out1, out2 unused); n the column's length, 0 <= n <= ng * GROUP.
int gt_agg_fold(const void* packed, const void* refs_g, const void* valid, void* out0, void* out1, void* out2,
                long long ng, int bits, long long n, int kind, int itemsize, int agg, void* stream) {
  if (!gt::valid(ng, bits) || !gt::valid_itemsize(itemsize) || n < 0 || n > ng * gt::kGroup)
    return cudaErrorInvalidValue;
  if (agg == 0 && (out1 == nullptr || out2 == nullptr)) return cudaErrorInvalidValue;
  const gt::AggKernel kernel =
      gt::by_kind<gt::AggKernel>(kind, [&](auto k) { return gt::agg_instance<decltype(k)::value>(agg); });
  if (kernel == nullptr) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(refs_g), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1), static_cast<uint32_t*>(out2), bits, 8 * itemsize, n);
  return cudaGetLastError();
}

}  // extern "C"
