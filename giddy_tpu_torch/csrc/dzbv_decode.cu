// dzbv decode (discard zero bytes, variable width; FORMAT.md §1.10) of
// giddy_tpu_torch: K13, K14 and K15, one kernel for each stream form the
// host prep gives the byte planes (giddy_tpu_torch/kernels/dzbv.py). Same
// conventions as lmp_decode.cu: plain C interface bound with ctypes by
// giddy_tpu_torch/kernels/_build.py; one block of 1024 threads per GROUP
// (grid = number of groups), thread c decodes lane c, positions
// p = i * 1024 + c of its group for slots i = 0..31, and stores slot i at
// g * 32768 + p, so stores are warp-coalesced; every entry point launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take. out_bytes 4/2/1 stores the uint32 payload or
// its low 16/8 bits (the logical result of a narrow column).
//
// Value p of a group has w(p) - 1 in the LMP(2) widths stream and byte 0
// in the LMP(8) plane 0. For each plane k = 1..3 that is present, a value
// with w - 1 >= k takes byte k from the plane's stream at its rank among
// those values: within its 128-value tile (K13), within its group (K14) or
// within the column (K15). The three kernels are one template: every thread
// loads its lane's 32 width codes once (two words, 2 bits a slot); phase 1
// takes, for each slot and plane, one __ballot_sync and writes the warp's
// popcount into a 32 x 32 (slot, warp) table in shared memory, three planes
// in 16-bit fields of a uint64; after one __syncthreads() K14 and K15 turn
// the table into an exclusive scan in linear order (slot-major, so the
// group's order), with two more barriers. Phase 2 takes the ballots again
// and ranks each value as the table entry before its warp plus its
// in-warp prefix popcount, then loads its byte straight from device memory
// through the read-only cache: consecutive ranks are consecutive words of
// every form's layout, so a warp's loads of a plane fall in one or two
// 128-byte lines. The TPU reference's MXU byte-field scans, 128-lane gather
// windows and roll networks (giddy_tpu/kernels/dzbv.py, lanes.py) are TPU
// design and have no counterpart here.
// Bound: device-memory bytes, 0.25 (widths) + 1 (plane 0) + the plane bytes
// read and 4, 2 or 1 written a value; the operations (ballots, popcounts,
// addresses) are below that at 3 planes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lmp.cuh"

namespace gt {

// The streams of byte planes 1..3 (plane k at index k - 1; nullptr where
// the plane is absent) and each one's shape: the tile stride s_k in bytes
// (tile form), the row width w4_k in units of 1024 words (group-row form),
// or the stream's row count (on-disk form).
struct DzbvPlanes {
  const uint32_t* words[3];
  long long shape[3];
};

enum class DzbvForm { kTile, kGroup, kPlane };

// Lane c's 32 width codes w - 1 of group g: slot i in bits 2i, 2i+1 (LMP(2)
// holds slots 0..15 in word 0 and 16..31 in word 1 of the lane).
__device__ __forceinline__ uint64_t lane_width_codes(const uint32_t* __restrict__ widths, size_t g, int c) {
  const uint32_t* w = widths + g * 2 * kLanes + c;
  return static_cast<uint64_t>(__ldg(w)) | (static_cast<uint64_t>(__ldg(w + kLanes)) << 32);
}

__device__ __forceinline__ uint32_t code_at(uint64_t codes, int i) {
  return static_cast<uint32_t>(codes >> (2 * i)) & 3u;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* word, uint32_t pos) {
  return (__ldg(word) >> (8 * pos)) & 0xFFu;
}

// Byte k+1 of the value of slot i, warp `warp` of group g, at `rank` among
// the values of its tile (kTile), group (kGroup) or column (kPlane: offset
// is the group's first rank in the plane). Each address is clamped into its
// stream, as the plain versions clamp, so malformed streams read nothing
// outside it; a group row's bytes past its w4 * 4096 read 0.
template <DzbvForm F>
__device__ __forceinline__ uint32_t plane_byte(const DzbvPlanes& planes, int k, size_t g, int i, int warp,
                                               uint32_t rank, long long offset) {
  const uint32_t* words = planes.words[k];
  if constexpr (F == DzbvForm::kTile) {
    // tile t = i * 8 + warp / 4 (positions [128 t, 128 t + 128)); its bytes
    // start at t * s of the group's row of 256 * s bytes, T8-packed: byte q
    // in word (q / 512) * 128 + q % 128, bits 8 * ((q / 128) % 4)
    const uint32_t s = static_cast<uint32_t>(planes.shape[k]);
    const uint32_t q = min((static_cast<uint32_t>(i) * 8u + (warp >> 2)) * s + rank, 256u * s - 1u);
    return byte_of(words + g * 64 * s + (q >> 9) * 128 + (q & 127u), (q >> 7) & 3u);
  } else if constexpr (F == DzbvForm::kGroup) {
    // LMP(8) of the group's front-compacted bytes, cut to w4 * 1024 words:
    // byte m at slot m / 1024 of lane m % 1024
    const long long w4 = planes.shape[k];
    if ((rank >> 12) >= w4) return 0u;
    return byte_of(words + g * w4 * kLanes + (rank >> 12) * kLanes + (rank & 1023u), (rank >> 10) & 3u);
  } else {
    // LMP(8) of the whole plane: byte r in group r / 32768 of the stream
    const long long r = min(offset + rank, planes.shape[k] * kGroup - 1);
    const uint32_t m = static_cast<uint32_t>(r & (kGroup - 1));
    return byte_of(words + (r >> 15) * (8 * kLanes) + (m >> 12) * kLanes + (m & 1023u), (m >> 10) & 3u);
  }
}

// K13 (kTile), K14 (kGroup) and K15's decode (kPlane; offsets is (3, ng)
// int64, each group's first rank in planes 1..3). K13 replaces
// giddy_tpu/kernels/dzbv.py:340 _tile_pass_call (body :354-438), K14
// :461 _single_pass_call (body :471-502) and K15 the two-pass plane decode
// of :512 _unpack_call and :519 _decode_xla (the unpacks, the cumsum rank
// and the take in one pass after the count kernel below).
template <typename T, DzbvForm F>
__global__ void __launch_bounds__(kLanes)
    dzbv_decode_kernel(const uint32_t* __restrict__ widths, const uint32_t* __restrict__ plane0, DzbvPlanes planes,
                       const long long* __restrict__ offsets, T* __restrict__ out) {
  __shared__ uint64_t table[kSlots * 32];  // (slot, warp) -> three 16-bit counts
  __shared__ uint64_t warp_sums[32];
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  bool has[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) has[k] = planes.words[k] != nullptr;
  if (!has[0] && !has[1] && !has[2]) {  // every value is one byte wide
    unpack_store_lane<T, LutMode::kNone>(plane0, out, 8, 0u, Lut<LutMode::kNone>(nullptr, 0u, nullptr));
    return;
  }
  const uint64_t codes = lane_width_codes(widths, g, c);

  // phase 1: each warp's count of the values wider than k + 1 bytes, by slot
#pragma unroll 4
  for (int i = 0; i < kSlots; ++i) {
    const uint32_t code = code_at(codes, i);
    uint64_t cnt = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (has[k]) cnt |= static_cast<uint64_t>(__popc(__ballot_sync(kFullMask, code > static_cast<uint32_t>(k)))) << (16 * k);
    if (lane == 0) table[i * 32 + warp] = cnt;
  }
  __syncthreads();
  if constexpr (F != DzbvForm::kTile) {
    // exclusive scan of the 1024 entries in (slot, warp) order, entry c in
    // thread c; a group's counts are <= 32768, so no 16-bit field carries
    const uint64_t x = table[c];
    uint64_t incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint64_t y = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    const uint64_t t = warp_sums[lane];
    const uint32_t lo = __reduce_add_sync(kFullMask, lane < warp ? static_cast<uint32_t>(t) : 0u);
    const uint32_t hi = __reduce_add_sync(kFullMask, lane < warp ? static_cast<uint32_t>(t >> 32) : 0u);
    table[c] = ((static_cast<uint64_t>(hi) << 32) | lo) + incl - x;
    __syncthreads();
  }

  // phase 2: rank, byte loads, store
  long long offset[3] = {0, 0, 0};
  if constexpr (F == DzbvForm::kPlane) {
#pragma unroll
    for (int k = 0; k < 3; ++k) offset[k] = __ldg(offsets + k * gridDim.x + g);
  }
  const unsigned below = (1u << lane) - 1u;
  LaneReader b0(plane0 + g * 8 * kLanes + c, 8);
  T* o = out + g * kGroup + c;
#pragma unroll 2
  for (int i = 0; i < kSlots; ++i) {
    const uint32_t code = code_at(codes, i);
    uint32_t v = b0.next();
    uint64_t before = 0;  // the selected values before this warp's, per plane
    if constexpr (F == DzbvForm::kTile) {
      for (int w = warp & ~3; w < warp; ++w) before += table[i * 32 + w];
    } else {
      before = table[i * 32 + warp];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (!has[k]) continue;
      const unsigned ballot = __ballot_sync(kFullMask, code > static_cast<uint32_t>(k));
      if (code > static_cast<uint32_t>(k)) {
        const uint32_t rank = (static_cast<uint32_t>(before >> (16 * k)) & 0xFFFFu) + __popc(ballot & below);
        v |= plane_byte<F>(planes, k, g, i, warp, rank, offset[k]) << (8 * (k + 1));
      }
    }
    o[i * kLanes] = static_cast<T>(v);
  }
}

// The first pass of K15: each group's count of the values with w - 1 >= k,
// k = 1..3, into counts (3, ng) int32 (plane-major, so that the scan over
// the groups runs along rows). Reads only the widths: per lane, popcounts
// of the 2-bit codes (b0 | b1, b1, b0 & b1), then a block sum.
__global__ void __launch_bounds__(kLanes)
    dzbv_plane_counts_kernel(const uint32_t* __restrict__ widths, int32_t* __restrict__ counts) {
  __shared__ uint32_t part[3][32];
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  const uint64_t codes = lane_width_codes(widths, g, c);
  const uint64_t b0 = codes & 0x5555555555555555ull;
  const uint64_t b1 = (codes >> 1) & 0x5555555555555555ull;
  const uint32_t n[3] = {static_cast<uint32_t>(__popcll(b0 | b1)), static_cast<uint32_t>(__popcll(b1)),
                         static_cast<uint32_t>(__popcll(b0 & b1))};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint32_t s = __reduce_add_sync(kFullMask, n[k]);
    if (lane == 0) part[k][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t s = __reduce_add_sync(kFullMask, part[k][lane]);
      if (lane == 0) counts[k * gridDim.x + g] = static_cast<int32_t>(s);
    }
  }
}

// Checks the three planes' shapes for the form and launches the decode.
template <DzbvForm F>
int launch_dzbv(const void* widths, const void* plane0, const void* p1, const void* p2, const void* p3, long long a1,
                long long a2, long long a3, const void* offsets, void* out, long long ng, int out_bytes,
                void* stream) {
  if (!valid(ng, 1) || widths == nullptr || plane0 == nullptr || out == nullptr) return cudaErrorInvalidValue;
  DzbvPlanes planes;
  const void* p[3] = {p1, p2, p3};
  const long long a[3] = {a1, a2, a3};
  for (int k = 0; k < 3; ++k) {
    planes.words[k] = static_cast<const uint32_t*>(p[k]);
    planes.shape[k] = p[k] != nullptr ? a[k] : 0;
    if (p[k] == nullptr) continue;
    bool ok;
    if constexpr (F == DzbvForm::kTile) {
      ok = a[k] >= 8 && a[k] <= 128 && a[k] % 8 == 0;
    } else if constexpr (F == DzbvForm::kGroup) {
      ok = a[k] >= 1 && a[k] <= 8;
    } else {
      ok = a[k] >= 1 && a[k] <= INT_MAX && offsets != nullptr;
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  return dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    dzbv_decode_kernel<T, F><<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(widths), static_cast<const uint32_t*>(plane0), planes,
        static_cast<const long long*>(offsets), static_cast<T*>(out));
    return cudaGetLastError();
  });
}

}  // namespace gt

using gt::kLanes;

extern "C" {

// t1..t3: the trow streams (ng, 64 * s_k) of planes 1..3, nullptr where
// absent; s1..s3 their strides.
int gt_dzbv_tile_decode(const void* widths, const void* plane0, const void* t1, const void* t2, const void* t3,
                        long long s1, long long s2, long long s3, void* out, long long ng, int out_bytes,
                        void* stream) {
  return gt::launch_dzbv<gt::DzbvForm::kTile>(widths, plane0, t1, t2, t3, s1, s2, s3, nullptr, out, ng, out_bytes,
                                              stream);
}

// r1..r3: the prow streams (ng, w4_k * 1024) of planes 1..3, nullptr where
// absent; w1..w3 their w4_k.
int gt_dzbv_group_decode(const void* widths, const void* plane0, const void* r1, const void* r2, const void* r3,
                         long long w1, long long w2, long long w3, void* out, long long ng, int out_bytes,
                         void* stream) {
  return gt::launch_dzbv<gt::DzbvForm::kGroup>(widths, plane0, r1, r2, r3, w1, w2, w3, nullptr, out, ng,
                                               out_bytes, stream);
}

// counts: (3, ng) int32.
int gt_dzbv_plane_counts(const void* widths, void* counts, long long ng, void* stream) {
  if (!gt::valid(ng, 1) || widths == nullptr || counts == nullptr) return cudaErrorInvalidValue;
  gt::dzbv_plane_counts_kernel<<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(widths), static_cast<int32_t*>(counts));
  return cudaGetLastError();
}

// q1..q3: the on-disk plane streams (rows_k, 8192) of planes 1..3, nullptr
// where absent; n1..n3 their row counts; offsets: (3, ng) int64, the
// exclusive scan over the groups of gt_dzbv_plane_counts.
int gt_dzbv_plane_decode(const void* widths, const void* plane0, const void* q1, const void* q2, const void* q3,
                         long long n1, long long n2, long long n3, const void* offsets, void* out, long long ng,
                         int out_bytes, void* stream) {
  return gt::launch_dzbv<gt::DzbvForm::kPlane>(widths, plane0, q1, q2, q3, n1, n2, n3, offsets, out, ng, out_bytes,
                                               stream);
}

}  // extern "C"
