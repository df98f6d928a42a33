// Run expansion (rle, rpe) and the per-group scan family (dense cumsum
// rows, delta2, xordelta) of giddy_tpu_torch. Same conventions as
// lmp_decode.cu: plain C interface bound with ctypes by
// giddy_tpu_torch/kernels/_build.py; K6-K8 launch one block of 1024
// threads per GROUP (grid = number of groups), thread c owning positions
// i * 1024 + c (K7: 16 consecutive positions in its scan), K5 blocks of 8
// warps, each warp over 1024 consecutive positions; every entry point
// launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take. out_bytes 4/2/1 stores the uint32 payload or
// its low 16/8 bits. All arithmetic wraps mod 2^32 (FORMAT.md §0). K5, K6
// and K7 take an optional table (lut, d), the fused dictionary stage of
// cascade decode (gt::Lut, lmp.cuh); lut = nullptr launches the plain kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "lmp.cuh"

namespace gt {

constexpr int kRunPadMax = 128;  // largest w_pad: CHAIN_HARD of the host prep

// K5. Replaces both Pallas run expansions of giddy_tpu/kernels/rle.py,
// _chain_call (:153, the select chain, w_pad <= 16) and _rank_call (:216,
// the 7-probe search, 16 < w_pad <= 128); their split is a TPU cost
// choice, and one kernel serves both here.
// Input: the tile form of the host prep. Group g owns rows g*T .. g*T+T-1
// of ends_w / vals_w (rows, w_pad), tile t covering positions
// [t*W, (t+1)*W) of the group (T <= 64: W >= 512), ends tile-relative,
// exclusive and non-decreasing (any int32: an end below 0 counts at every
// position, one at or past W at none). Output at tile position j: vals[r]
// with r = #{m < w_pad - 1 : ends[m] <= j}, the select chain's result.
// Bound: device-memory bytes: the stores (4, 2 or 1 bytes a value) and
// the real runs' ends and values; the tables' padding is the prep's.
// Design: no block-wide staging and no search (staging a group's tables
// before any store, at one block of 1024 threads an SM, and a binary
// search of log2(w_pad) dependent shared loads a quad held a kernel of that
// shape to 0.49 of its bound at T 32 of w_pad 128; PERF.md §5). A warp
// owns 1024 consecutive positions of a group, one or two spans of one tile
// (W >= 1024: part of a tile; W = 512: two tiles), and for each span:
// (1) reads the tile's w_pad ends, E = max(1, w_pad / 32) a lane in one
//     vector load, and counts with two warp reductions the runs that end
//     before the span (`carry`) and those that end before its end
//     (`last`): the span selects runs carry .. last only, so
// (2) only the lanes that hold one of those read their values, mapped
//     through the table (Lut kGlobal: expansion only selects run values, so
//     this equals mapping the output), into the warp's slice of shared
//     memory;
// (3) marks each run end m inside the span in a byte strip of the span
//     (zeroed first): strip[end - span start] = m + 1, written by the last
//     of equal ends only, so equal ends follow the #{ends <= j} rule;
// (4) walks the span in steps of 128 positions: lane l reads the strip's 4
//     bytes of positions 4l .. 4l+3 in one shared load, takes their running
//     max and a 5-shuffle max-scan across the warp, seeded by the carry from
//     the step before: at each position that is #{ends <= j} (the ends are
//     non-decreasing), the run index. It gathers the 4 values from shared
//     memory and writes them as one 16-, 8- or 4-byte store (warp stores
//     stay coalesced; one 4-byte store a value reached only 56% of a plain
//     fill of the same bytes on the H100, PERF.md).
// Warps never wait for each other (only __syncwarp), so one warp's table
// loads overlap the others' stores; blocks are small (8 warps, 12 KiB of
// static shared memory) and 8 fit an SM at <= 32 registers a thread.
constexpr int kRunWarps = 8;  // warps a block
constexpr int kRunThreads = 32 * kRunWarps;
constexpr int kRunSpan = kGroup / 32;  // positions a warp: 1024
constexpr int kRunStep = 128;          // positions a warp step: 4 a lane

template <typename T>
struct Quad;  // four values of T, packed into one vector store
template <>
struct Quad<uint32_t> {
  using V = uint4;
  static __device__ __forceinline__ V pack(const uint32_t* v) { return make_uint4(v[0], v[1], v[2], v[3]); }
};
template <>
struct Quad<uint16_t> {
  using V = uint2;
  static __device__ __forceinline__ V pack(const uint32_t* v) {
    return make_uint2((v[0] & 0xFFFFu) | (v[1] << 16), (v[2] & 0xFFFFu) | (v[3] << 16));
  }
};
template <>
struct Quad<uint8_t> {
  using V = uint32_t;
  static __device__ __forceinline__ V pack(const uint32_t* v) {
    return (v[0] & 0xFFu) | ((v[1] & 0xFFu) << 8) | ((v[2] & 0xFFu) << 16) | (v[3] << 24);
  }
};

// x = p[0 .. E-1], one vector load (p is 4E-byte aligned).
template <int E, typename U>
__device__ __forceinline__ void load_entries(const U* p, U (&x)[E]) {
  static_assert(sizeof(U) == 4, "32-bit table entries");
  if constexpr (E == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = static_cast<U>(v.x), x[1] = static_cast<U>(v.y), x[2] = static_cast<U>(v.z), x[3] = static_cast<U>(v.w);
  } else if constexpr (E == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = static_cast<U>(v.x), x[1] = static_cast<U>(v.y);
  } else {
    x[0] = __ldg(p);
  }
}

// E entries a lane: w_pad = 32 * E, or w_pad <= 32 for E = 1 (lanes at or
// past w_pad hold none).
template <typename T, LutMode M, int E>
__global__ void __launch_bounds__(kRunThreads, 2048 / kRunThreads)
    run_strip_kernel(const int32_t* __restrict__ ends_w, const uint32_t* __restrict__ vals_w, T* __restrict__ out,
                     int w_shift, int w_pad, const uint32_t* __restrict__ lut, uint32_t d) {
  static_assert(M != LutMode::kShared, "K5 maps its run table, with no shared copy of the dictionary");
  __shared__ __align__(16) uint8_t strips[kRunWarps][kRunSpan];
  __shared__ __align__(16) uint32_t runs[kRunWarps][32 * E];
  const Lut<M> map(lut, d, nullptr);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t span_id = static_cast<size_t>(blockIdx.x) * kRunWarps + warp;
  const size_t g = span_id >> 5;
  const int p0 = static_cast<int>(span_id & 31) * kRunSpan;
  const int width = 1 << w_shift;
  const int len = min(width, kRunSpan);  // positions a span: 512 or 1024
  uint8_t* strip = strips[warp];
  uint32_t* vals = runs[warp];
  using V = typename Quad<T>::V;
  for (int p = p0; p < p0 + kRunSpan; p += len) {
    const int start = p & (width - 1);  // the span's first position in its tile
    const size_t row = (g << (15 - w_shift)) + (p >> w_shift);  // g * T + tile
    int32_t e[E];
    if (E * lane < w_pad) {
      load_entries<E>(ends_w + row * w_pad + E * lane, e);
    } else {
      e[0] = INT_MAX;  // E = 1 only: no entry, never counted
    }
    const int32_t after = __shfl_down_sync(kFullMask, e[0], 1);  // lane l+1's first end
    int before = 0, upto = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const bool counted = E * lane + k < w_pad - 1;  // the last entry is never counted
      before += counted && e[k] < start;
      upto += counted && e[k] < start + len;
    }
    const int carry0 = __reduce_add_sync(kFullMask, before);
    const int last = __reduce_add_sync(kFullMask, upto);  // <= w_pad - 1
    __syncwarp();  // the span before has read its strip and values
    if (E * lane <= last && E * lane + E - 1 >= carry0) {
      uint32_t v[E];
      load_entries<E>(vals_w + row * w_pad + E * lane, v);
#pragma unroll
      for (int k = 0; k < E; ++k) vals[E * lane + k] = map(v[k]);
    }
    for (int b = 16 * lane; b < len; b += 16 * 32) *reinterpret_cast<uint4*>(strip + b) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int m = E * lane + k;
      const int32_t next = k + 1 < E ? e[min(k + 1, E - 1)] : after;
      if (m < w_pad - 1 && e[k] >= start && e[k] < start + len && (m + 1 == w_pad - 1 || next != e[k]))
        strip[e[k] - start] = static_cast<uint8_t>(m + 1);
    }
    __syncwarp();
    int carry = carry0;
    V* o = reinterpret_cast<V*>(out + g * kGroup + p) + lane;
    for (int s = 0; s < len; s += kRunStep) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(strip + s + 4 * lane);
      int r[4];
      r[0] = w & 0xFFu;
      r[1] = max(r[0], static_cast<int>((w >> 8) & 0xFFu));
      r[2] = max(r[1], static_cast<int>((w >> 16) & 0xFFu));
      r[3] = max(r[2], static_cast<int>(w >> 24));
      int scan = r[3];  // inclusive max over lanes 0 .. lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) scan = max(scan, __shfl_up_sync(kFullMask, scan, off));
      const int prev = __shfl_up_sync(kFullMask, scan, 1);
      const int base = lane == 0 ? carry : max(carry, prev);
      carry = max(carry, __shfl_sync(kFullMask, scan, 31));
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = vals[max(base, r[k])];
      o[s / 4] = Quad<T>::pack(v);
    }
  }
}

// K6. Replaces giddy_tpu/kernels/rle.py:305 _cumsum_rows_call (the dense
// per-GROUP cumsum after rle/rpe's scatter form, and scan.group_prefix_sum).
// Bound: device-memory bytes, 4 in and 4 (or 2, 1) out per value. Design:
// each thread loads its 32 values up front (32 independent loads in
// flight), then the block-row scan of lmp.cuh runs over them. With a table
// (rle/rpe's scatter form under cascade) each sum is mapped after the scan:
// the scattered jumps are differences of codes, so not before it.
template <typename T, LutMode M>
__global__ void __launch_bounds__(kLanes)
    cumsum_rows_kernel(const uint32_t* __restrict__ in, T* __restrict__ out, const uint32_t* __restrict__ lut,
                       uint32_t d) {
  extern __shared__ uint32_t lut_smem[];
  __shared__ uint32_t warp_totals[2][32];
  const Lut<M> map(lut, d, lut_smem);
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t* x = in + g * kGroup + c;
  uint32_t v[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) v[i] = __ldg(x + i * kLanes);
  T* o = out + g * kGroup + c;
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
    o[i * kLanes] = static_cast<T>(map(block_row_scan<AddScan>(v[i], carry, warp_totals, i)));
}

// K7. Replaces giddy_tpu/kernels/delta2.py:27 (body :32: unpack, unzigzag,
// lanes.py:490 signed_double_cumsum, then anchor + slope * (j+1)).
// Bound: device-memory bytes, as K3. With v_j the output at position j of
// the group, v_j = v_{j-1} + slope + S_j (S_j = sum_{k<=j} s_k, v_{-1} =
// anchor), and a run of positions starting at j0 needs only the exclusive
// sums A = sum_{k<j0} s_k and B = sum_{k<j0} k * s_k:
// v_{j0-1} = anchor + j0 * (slope + A) - B, all mod 2^32.
// Design: a warp-transposed serial scan, in two passes of 16 slots. A chunk
// is 16 consecutive positions, half of one slot of a warp's 32 lanes. In
// each pass (1) each warp unpacks and unzigzags its lanes' 16 slots into
// its own 16 x 33-word buffer in shared memory, slot i of lane m at [i][m];
// (2) lane l sums chunk (slot l / 2, half l % 2) of its warp, (sum s,
// sum j * s), into the pass's table in (slot, warp, half) order, the
// group's order; (3) one exclusive scan of the pass's 1024 chunk sums,
// carried on from the first pass (a shuffle scan a warp, the warp totals
// through shared memory: three barriers a pass, where the block-row scan of
// K3 takes one a slot); (4) lane l runs its chunk from the carry with two
// adds a value, maps it through the table and writes it back in place;
// (5) lane m stores row i's word m at i * 1024 + 32w + m, warp-coalesced.
// The +1 word of padding keeps every buffer access free of bank conflicts.
// What bounds it: instructions first. A block-row scan of the pair a slot
// took 107 warp instructions a slot and issue-bound the kernel; this takes
// 598 a pass of 16 slots in SASS, the unpack's word-load branch included,
// which runs B times in 32 slots. 66 KB of buffers and 17 KB of tables a
// block: two blocks of 1024 threads an SM, whose barriers and loads overlap
// (one pass of 32 slots in 132 KB, one block an SM, ran 1.29x as long on
// an H100 80GB HBM3 at 700 W; PERF.md); a cascade table goes after the
// buffers (choose_lut's `own` bytes).
constexpr int kChunkRow = kSlots + 1;  // words of a buffer row, padded
constexpr int kPassSlots = kSlots / 2;  // slots a pass
constexpr int kChunk = kPassSlots;      // values a chunk
constexpr int kTableRow = 2 * 32 + 2;   // chunk entries of one slot (warp, half), padded
constexpr size_t kDelta2Buffers = sizeof(uint32_t) * 32 * kPassSlots * kChunkRow;  // the 32 warps' buffers

template <typename T, LutMode M>
__global__ void __launch_bounds__(kLanes, 2)
    delta2_decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ anchors,
                         const int32_t* __restrict__ slopes, T* __restrict__ out, int bits,
                         const uint32_t* __restrict__ lut, uint32_t d) {
  extern __shared__ uint32_t buffers[];              // the warps' buffers, then (kShared) the table
  __shared__ uint2 chunks[2][kPassSlots * kTableRow];  // by pass: (slot, warp, half) -> chunk sums, then their scan
  __shared__ uint2 warp_totals[2][32];
  const Lut<M> map(lut, d, buffers + kDelta2Buffers / sizeof(uint32_t));
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  const int row = lane >> 1, half = lane & 1;  // this lane's chunk in a pass
  uint32_t* buf = buffers + warp * kPassSlots * kChunkRow;
  uint32_t* chunk = buf + row * kChunkRow + half * kChunk;
  const int at = row * kTableRow + 2 * warp + half;  // its entry in a pass's table
  const uint32_t anchor = static_cast<uint32_t>(__ldg(anchors + g));
  const uint32_t slope = static_cast<uint32_t>(__ldg(slopes + g));
  LaneReader r(packed + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
  uint2 carry = make_uint2(0u, 0u);  // the sums of the first pass
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    // (1) slot 16 * pass + i of this lane to [i][lane]
#pragma unroll
    for (int i = 0; i < kPassSlots; ++i) buf[i * kChunkRow + lane] = unzigzag(r.next());
    __syncwarp();

    // (2) this lane's chunk: positions j0 .. j0 + 15
    const uint32_t j0 = static_cast<uint32_t>((pass * kPassSlots + row) * kLanes + warp * 32 + half * kChunk);
    uint32_t sum = 0, ksum = 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      sum += chunk[k];
      ksum += static_cast<uint32_t>(k) * chunk[k];
    }
    uint2* table = chunks[pass];
    table[at] = make_uint2(sum, j0 * sum + ksum);
    __syncthreads();

    // (3) exclusive scan of the pass's chunks: thread c takes chunk c
    {
      uint2* entry = table + (c >> 6) * kTableRow + (c & 63);
      const uint2 x = *entry;
      uint2 incl = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint2 y = shfl_up(incl, off);
        if (lane >= off) incl = PairAddScan::combine(y, incl);
      }
      if (lane == 31) warp_totals[pass][warp] = incl;
      __syncthreads();
      const uint2 t = warp_totals[pass][lane];
      const uint2 before = PairAddScan::span(t, warp);  // warps 0 .. warp-1
      const uint2 total = PairAddScan::span(t, 32);
      *entry = make_uint2(carry.x + before.x + incl.x - x.x, carry.y + before.y + incl.y - x.y);
      carry = PairAddScan::combine(carry, total);
      __syncthreads();
    }

    // (4) the chunk from its carry, mapped, back in place
    {
      const uint2 in = table[at];
      uint32_t step = slope + in.x;             // slope + S_{j0-1}
      uint32_t v = anchor + j0 * step - in.y;  // v_{j0-1}
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        step += chunk[k];
        v += step;
        chunk[k] = map(v);
      }
    }
    __syncwarp();

    // (5) slot 16 * pass + i of this lane
#pragma unroll
    for (int i = 0; i < kPassSlots; ++i) o[(pass * kPassSlots + i) * kLanes] = static_cast<T>(buf[i * kChunkRow + lane]);
  }
}

// K8. Replaces giddy_tpu/kernels/xordelta.py:18 (body :22: unpack,
// lanes.py:589 group_cumxor, XOR the anchor). Stores the uint32 payload
// only: xordelta has no narrow store in the reference.
// Bound: device-memory bytes, as K3. Design: K3 with the add swapped for
// XOR (block_row_scan<XorScan>), the anchor as the starting carry.
__global__ void __launch_bounds__(kLanes)
    xordelta_decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ anchors,
                           uint32_t* __restrict__ out, int bits) {
  __shared__ uint32_t warp_totals[2][32];
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  uint32_t carry = static_cast<uint32_t>(__ldg(anchors + g));
  LaneReader r(packed + g * bits * kLanes + c, bits);
  uint32_t* o = out + g * kGroup + c;
  for (int i = 0; i < kSlots; ++i) o[i * kLanes] = block_row_scan<XorScan>(r.next(), carry, warp_totals, i);
}

bool valid_run_table(int w_shift, int w_pad) {
  const bool pow2 = w_pad >= 1 && (w_pad & (w_pad - 1)) == 0;
  return w_shift >= 9 && w_shift <= 15 && pow2 && w_pad <= kRunPadMax;
}

// K5: a grid of warps, 32 a group, each over 1024 positions; the instance
// with E = max(1, w_pad / 32) entries a lane.
template <typename T>
int launch_run_expand(const void* ends_w, const void* vals_w, void* out, long long ng, int w_shift, int w_pad,
                      const void* lut, long long d, cudaStream_t stream) {
  using K = void (*)(const int32_t*, const uint32_t*, T*, int, int, const uint32_t*, uint32_t);
  const bool mapped = lut != nullptr;
  K kernel;
  switch (w_pad) {
    case 64: kernel = mapped ? run_strip_kernel<T, LutMode::kGlobal, 2> : run_strip_kernel<T, LutMode::kNone, 2>; break;
    case 128: kernel = mapped ? run_strip_kernel<T, LutMode::kGlobal, 4> : run_strip_kernel<T, LutMode::kNone, 4>; break;
    default: kernel = mapped ? run_strip_kernel<T, LutMode::kGlobal, 1> : run_strip_kernel<T, LutMode::kNone, 1>;
  }
  const long long blocks = ng * 32 / kRunWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kRunThreads, 0, stream>>>(
      static_cast<const int32_t*>(ends_w), static_cast<const uint32_t*>(vals_w), static_cast<T*>(out), w_shift,
      w_pad, static_cast<const uint32_t*>(lut), static_cast<uint32_t>(d));
  return cudaGetLastError();
}

}  // namespace gt

using gt::kLanes;

extern "C" {

int gt_run_expand(const void* ends_w, const void* vals_w, void* out, long long ng, int w_shift, int w_pad,
                  int out_bytes, const void* lut, long long d, void* stream) {
  if (!gt::valid(ng, 1) || !gt::valid_run_table(w_shift, w_pad)) return cudaErrorInvalidValue;
  if (lut != nullptr && (d < 1 || d > 0xFFFFFFFFLL)) return cudaErrorInvalidValue;
  const uintptr_t vector = sizeof(uint32_t) * (w_pad > 32 ? w_pad / 32 : 1);  // bytes a lane loads at once
  if (reinterpret_cast<uintptr_t>(ends_w) % vector || reinterpret_cast<uintptr_t>(vals_w) % vector)
    return cudaErrorMisalignedAddress;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    return gt::launch_run_expand<decltype(tag)>(ends_w, vals_w, out, ng, w_shift, w_pad, lut, d,
                                                static_cast<cudaStream_t>(stream));
  });
}

int gt_cumsum_rows(const void* in, void* out, long long ng, int out_bytes, const void* lut, long long d,
                   void* stream) {
  if (!gt::valid(ng, 1)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    using K = void (*)(const uint32_t*, T*, const uint32_t*, uint32_t);
    const K family[3] = {gt::cumsum_rows_kernel<T, gt::LutMode::kNone>, gt::cumsum_rows_kernel<T, gt::LutMode::kShared>,
                         gt::cumsum_rows_kernel<T, gt::LutMode::kGlobal>};
    K kernel;
    size_t smem;
    const cudaError_t err = gt::choose_lut(family, lut, d, &kernel, &smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(ng), kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<T*>(out), static_cast<const uint32_t*>(lut),
        static_cast<uint32_t>(d));
    return cudaGetLastError();
  });
}

int gt_delta2_decode(const void* packed, const void* anchors, const void* slopes, void* out, long long ng, int bits,
                     int out_bytes, const void* lut, long long d, void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    using K = void (*)(const uint32_t*, const int32_t*, const int32_t*, T*, int, const uint32_t*, uint32_t);
    const K family[3] = {gt::delta2_decode_kernel<T, gt::LutMode::kNone>,
                         gt::delta2_decode_kernel<T, gt::LutMode::kShared>,
                         gt::delta2_decode_kernel<T, gt::LutMode::kGlobal>};
    K kernel;
    size_t smem;
    const cudaError_t err = gt::choose_lut(family, lut, d, &kernel, &smem, gt::kDelta2Buffers);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(ng), kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(anchors),
        static_cast<const int32_t*>(slopes), static_cast<T*>(out), bits, static_cast<const uint32_t*>(lut),
        static_cast<uint32_t>(d));
    return cudaGetLastError();
  });
}

// 1 when K7 (uint32 store) keeps a d-entry cascade table in shared memory
// on the current device, beside its buffers and chunk table; 0 when it
// reads it from global memory, or on an error.
int gt_delta2_shared(long long d) {
  using K = void (*)(const uint32_t*, const int32_t*, const int32_t*, uint32_t*, int, const uint32_t*, uint32_t);
  const K family[3] = {gt::delta2_decode_kernel<uint32_t, gt::LutMode::kNone>,
                       gt::delta2_decode_kernel<uint32_t, gt::LutMode::kShared>,
                       gt::delta2_decode_kernel<uint32_t, gt::LutMode::kGlobal>};
  K kernel;
  size_t smem;
  const uint32_t probe = 0;
  if (gt::choose_lut(family, &probe, d, &kernel, &smem, gt::kDelta2Buffers) != cudaSuccess) return 0;
  return kernel == family[1];
}

int gt_xordelta_decode(const void* packed, const void* anchors, void* out, long long ng, int bits, void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  gt::xordelta_decode_kernel<<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(anchors), static_cast<uint32_t*>(out), bits);
  return cudaGetLastError();
}

}  // extern "C"
