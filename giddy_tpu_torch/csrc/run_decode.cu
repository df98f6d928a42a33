// Run expansion (rle, rpe) and the per-group scan family (dense cumsum
// rows, delta2, xordelta) of giddy_tpu_torch. Same conventions as
// lmp_decode.cu: plain C interface bound with ctypes by
// giddy_tpu_torch/kernels/_build.py; one block of 1024 threads per GROUP
// (grid = number of groups), thread c owning positions i * 1024 + c (K5:
// four neighbouring positions per step; K7: 16 consecutive positions in
// its scan); every entry point launches on the
// stream it is given, allocates nothing, and
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take. out_bytes 4/2/1 stores the uint32 payload or
// its low 16/8 bits. All arithmetic wraps mod 2^32 (FORMAT.md §0). K5, K6
// and K7 take an optional table (lut, d), the fused dictionary stage of
// cascade decode (gt::Lut, lmp.cuh); lut = nullptr launches the plain kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "lmp.cuh"

namespace gt {

// Largest run table one group may bring: T tiles of w_pad runs, T <= 64
// (tile width W >= 512) and w_pad <= 128 (CHAIN_HARD of the host prep).
constexpr int kRunTableMax = 8192;
constexpr int kRunPadMax = 128;

// K5. Replaces both Pallas run expansions of giddy_tpu/kernels/rle.py,
// _chain_call (:153, the select chain) and _rank_call (:216, the 7-probe
// search); their split is a TPU cost choice.
// Input: the tile form of the host prep. Group g owns rows g*T .. g*T+T-1
// of ends_w / vals_w (rows, w_pad), tile t covering positions
// [t*W, (t+1)*W) of the group, ends tile-relative, exclusive and
// non-decreasing. Output at tile position j: vals[r] with
// r = #{m < w_pad - 1 : ends[m] <= j}, the select chain's result.
// Bound: device-memory stores (4, 2 or 1 bytes a value; the tables are a
// few percent of that). Design: the block stages its group's T*w_pad-entry
// tables in dynamic shared memory (at most 64 KB for both). Thread c then
// writes 4 neighbouring positions q .. q+3, q = 4 * (i * 1024 + c), as one
// 16-, 8- or 4-byte store (warp stores stay coalesced): a binary search of
// log2(w_pad) probes finds the run at q (libgiddy's per-thread search,
// SURVEY.md CS-4), and the next three positions step forward from it.
// Neighbouring threads search one tile for neighbouring j, so probes mostly
// broadcast. With a table, the block maps the run values through it while
// staging them (Lut kGlobal): expansion only selects run values, so this
// equals mapping the output, at T*w_pad lookups a group instead of 32768. On NVIDIA H100 80GB HBM3, 700.00 W, the vector store took K5
// from 0.153 ms to 0.105 ms at configs[3] (PERF.md): with one 4-byte store
// per value the kernel reached only 56% of a plain fill of the same bytes.
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

template <typename T, LutMode M>
__global__ void __launch_bounds__(kLanes)
    run_expand_kernel(const int32_t* __restrict__ ends_w, const uint32_t* __restrict__ vals_w,
                      T* __restrict__ out, int w_shift, int w_pad, const uint32_t* __restrict__ lut, uint32_t d) {
  static_assert(M != LutMode::kShared, "K5 maps its run table, with no shared copy of the dictionary");
  extern __shared__ uint32_t tables[];
  const Lut<M> map(lut, d, nullptr);
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const int entries = (kGroup >> w_shift) * w_pad;
  int32_t* ends = reinterpret_cast<int32_t*>(tables);
  uint32_t* vals = tables + entries;
  for (int k = c; k < entries; k += kLanes) {
    ends[k] = __ldg(ends_w + g * entries + k);
    vals[k] = map(__ldg(vals_w + g * entries + k));
  }
  __syncthreads();
  const int w_mask = (1 << w_shift) - 1;
  using V = typename Quad<T>::V;
  V* o = reinterpret_cast<V*>(out + g * kGroup) + c;
  for (int i = 0; i < kGroup / (4 * kLanes); ++i) {
    const int q = 4 * (i * kLanes + c);  // q .. q+3 lie in one tile: W >= 512
    const int32_t* e = ends + (q >> w_shift) * w_pad;
    const uint32_t* tv = vals + (q >> w_shift) * w_pad;
    const int j = q & w_mask;
    int r = 0;
    for (int step = w_pad >> 1; step > 0; step >>= 1)
      if (e[r + step - 1] <= j) r += step;
    uint32_t v[4];
    v[0] = tv[r];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      while (r < w_pad - 1 && e[r] <= j + k) ++r;
      v[k] = tv[r];
    }
    o[i * kLanes] = Quad<T>::pack(v);
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
  return w_shift >= 9 && w_shift <= 15 && pow2 && w_pad <= kRunPadMax &&
         (kGroup >> w_shift) * w_pad <= kRunTableMax;
}

}  // namespace gt

using gt::kLanes;

extern "C" {

int gt_run_expand(const void* ends_w, const void* vals_w, void* out, long long ng, int w_shift, int w_pad,
                  int out_bytes, const void* lut, long long d, void* stream) {
  if (!gt::valid(ng, 1) || !gt::valid_run_table(w_shift, w_pad)) return cudaErrorInvalidValue;
  if (lut != nullptr && (d < 1 || d > 0xFFFFFFFFLL)) return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(uint32_t) * static_cast<size_t>((gt::kGroup >> w_shift) * w_pad);
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    auto kernel = lut == nullptr ? gt::run_expand_kernel<T, gt::LutMode::kNone>
                                 : gt::run_expand_kernel<T, gt::LutMode::kGlobal>;
    const cudaError_t err = gt::allow_shared(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(ng), kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ends_w), static_cast<const uint32_t*>(vals_w), static_cast<T*>(out), w_shift,
        w_pad, static_cast<const uint32_t*>(lut), static_cast<uint32_t>(d));
    return cudaGetLastError();
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
