// dzbv decode (discard zero bytes, variable width; FORMAT.md §1.10) of
// giddy_tpu_torch: K13, K14 and K15, one kernel template (dzbv_staged_kernel)
// with a form for each stream form the host prep gives the byte planes
// (giddy_tpu_torch/kernels/dzbv.py). Same conventions as lmp_decode.cu:
// plain C interface bound with ctypes by giddy_tpu_torch/kernels/_build.py;
// one block of 1024 threads per GROUP (grid = number of groups), thread c
// decodes lane c, positions p = i * 1024 + c of its group for slots
// i = 0..31, and stores slot i at g * 32768 + p, so stores are
// warp-coalesced; every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() after the launch, the
// error of a refused shared-memory opt-in, or cudaErrorInvalidValue for
// arguments it does not take. out_bytes 4/2/1 stores the uint32 payload or
// its low 16/8 bits (the logical result of a narrow column).
//
// Value p of a group has w(p) - 1 in the LMP(2) widths stream and byte 0
// in the LMP(8) plane 0. For each plane k = 1..3 that is present, a value
// with w - 1 >= k takes byte k from the plane's stream at its rank among
// those values: within its 128-value tile (K13), within its group (K14) or
// within the column (K15, from each group's first rank, which a count
// kernel and a torch cumsum over the groups give first). All three rank
// alike: every thread loads its lane's 32 width codes once (two words, 2
// bits a slot); phase 1 takes, for each slot and plane, one ballot and
// writes the warp's popcount into a 32 x 32 (slot, warp) table in shared
// memory, three planes in 16-bit fields of a uint64; after one
// __syncthreads() the table becomes an exclusive scan (K14 and K15: of all
// 1024 entries in (slot, warp) order, the group's order, with two more
// barriers; K13: of each tile's four warps, plus the tile's first byte in
// its row). Phase 2 takes the ballots again and ranks each value as its
// warp's table entry plus its in-warp prefix popcount. The TPU reference's
// MXU byte-field scans, 128-lane gather windows and roll networks
// (giddy_tpu/kernels/dzbv.py, lanes.py) are TPU design and have no
// counterpart here.
// Bound: device-memory bytes, 0.25 (widths) + 1 (plane 0) + the plane bytes
// read and 4, 2 or 1 written a value; the operations (ballots, popcounts,
// addresses) are below that at 3 planes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lmp.cuh"

namespace gt {

// Lane c's 32 width codes w - 1 of group g: slot i in bits 2i, 2i+1 (LMP(2)
// holds slots 0..15 in word 0 and 16..31 in word 1 of the lane).
__device__ __forceinline__ uint64_t lane_width_codes(const uint32_t* __restrict__ widths, size_t g, int c) {
  const uint32_t* w = widths + g * 2 * kLanes + c;
  return static_cast<uint64_t>(__ldg(w)) | (static_cast<uint64_t>(__ldg(w + kLanes)) << 32);
}

// -- K13, K14 and K15: each group's plane bytes staged in shared memory ----
//
// K13 replaces giddy_tpu/kernels/dzbv.py:340 _tile_pass_call (body
// :354-438), K14 :461 _single_pass_call (body :471-502), K15 :512
// _unpack_call and :519 _decode_xla (the unpacks, the cumsum rank and the
// take). In each form a group's bytes of plane k are one contiguous run of
// its stream: K13's trow row of 256 * s_k bytes at byte g * 256 * s_k, K14's
// prow row of 4096 * w4_k bytes at g * 4096 * w4_k, and K15's window of the
// on-disk plane: the plane is LMP(8) of the column's bytes, so its rank r
// lies in 4 KB row r >> 12 (byte r & 4095 of the row, in word r & 1023 at
// byte (r >> 10) & 3, as in K14's rows), and the group's ranks [off_k,
// off_k + cnt_k) fill rows off_k >> 12 .. (off_k + cnt_k - 1) >> 12, at most
// 9. So warp 0 stages the block's rows in dynamic shared memory with bulk
// async copies (2 KB each, one mbarrier expecting all their bytes) before
// anything else; K15's warp 0 first reads the group's first rank and count
// in each plane (stage_windows) and expects the bytes of its own windows.
// Phase 1 and the table scan run while they land, and a second block on the
// SM, where one fits, is in its phase 2 meanwhile (K13/K14: <= 96 KB of rows
// + the 8.4 KB table a block, two blocks of 1024 threads an SM at every
// stride and row width; K15 sizes every block for 9 rows a plane, 36 KB:
// two blocks at one or two planes, one at three; kernels/_wrap.dzbv_plan).
// Once they land, each 4 KB (K13: 512 B) block is rotated into linear byte
// order in place (linearize), and phase 2 reads a value's byte with one byte
// load at the row's address plus its rank, clamped to the row (K15: to the
// window, which is the plain version's clamp to the stream's last byte): 32
// consecutive ranks fall in 8 consecutive words, a load without bank
// conflicts.
// What bounds it: instructions. The first design, one template for all
// three forms with a dependent 4-byte __ldg of each byte's word, ran at
// 0.26-0.31 of the byte bound at 2^26 with ~157 (K14, K15) and ~264 (K13)
// warp instructions a slot: per plane 64-bit address arithmetic, a range
// clamp, the load and a variable shift, in K13 a sum of 0-3 table entries;
// staging alone did not move it. This one runs ~48 (K14) and ~44 (K13) a
// slot, 0.74 of the bound, and K15, one block an SM at three planes,
// ~50 a slot and 0.54 with its count kernel and cumsum (H100 80GB HBM3,
// 700 W; scripts/profile_dzbv_torch.py; PERF.md): a
// slot's plane test is one predicate-setting AND on a lane mask
// (ballot_bit), K13 folds its tile's prefix and row offset into the table
// once, after phase 1, so every form reads one table entry a slot, and the
// load is branch-free. Staging whole rows also reads their padding (K13's
// strides and K14's row widths past a group's count, K15's parts of its
// first and last row that other groups own), which the bound, counting the
// compressed streams once, does not.

enum class DzbvForm { kTile, kGroup, kPlane };

constexpr uint32_t kStagePiece = 2048;  // bytes of one bulk copy; every row is a multiple
constexpr uint32_t kPlaneRow = 4096;    // K15: bytes of one row of an on-disk plane
constexpr uint32_t kPlaneWindow = 9 * kPlaneRow;  // K15: the most rows a group's ranks in one plane touch

// What a staged block needs to know of the planes, built on the host
// (stage_rows) and passed by value, so each field is a uniform operand:
// plane k (index k - 1) has a group row of bytes[k] bytes at rows[k] +
// g * bytes[k] (0 bytes where absent), staged at byte off[k] of the block's
// dynamic shared memory, the rows back to back in plane order. K15 reads
// its planes' streams at rows[k] and its windows' places from offsets and
// counts; bytes[k] is then the window's most, kPlaneWindow.
struct DzbvRows {
  const unsigned char* rows[3];
  uint32_t bytes[3];
  uint32_t off[3];
  // off + the row's last byte (0 where absent). K13 clamps a rank to it,
  // as the plain version clamps; K14 reads 0 past it.
  uint32_t last[3];
  uint32_t tile_lo;  // K13: s_1 | s_2 << 16, the row offsets a tile adds to the table's fields 0 and 1
  uint32_t tile_hi;  // K13: s_3, to field 2
  uint32_t total;    // bytes of dynamic shared memory a block: staged a group (K15: the most)
  // K15: each group's first rank and count of values in planes 1..3, (3, ng)
  // plane-major; and each plane stream's length in 4 KB rows
  const long long* offsets;
  const int32_t* counts;
  long long stream_rows[3];
};

// The even bits of x (bits 0, 2, .., 30) as bits 0..15.
__device__ __forceinline__ uint32_t even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// Lane c's slot masks of group g: bit i of mask k is set where the value of
// slot i is wider than k + 1 bytes (its code w - 1 > k) and plane k + 1 is
// present, so that a slot's test is one AND.
__device__ __forceinline__ void lane_plane_masks(const uint32_t* __restrict__ widths, size_t g, int c,
                                                 const bool (&has)[3], uint32_t (&mask)[3]) {
  const uint64_t codes = lane_width_codes(widths, g, c);
  const uint64_t b0 = codes, b1 = codes >> 1;
  const uint64_t wide[3] = {b0 | b1, b1, b0 & b1};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mask[k] = has[k] ? even_bits(static_cast<uint32_t>(wide[k])) | (even_bits(static_cast<uint32_t>(wide[k] >> 32)) << 16)
                     : 0u;
  }
}

// Rotates each staged 2^L-byte block into linear order in place, so that
// byte m of a row lies at byte off + m: K14's rows are LMP(8) cut to
// w4 * 1024 words, byte m of a 4 KB block in word m % 1024 at byte m / 1024
// (L = 12); K13's T8 rows hold byte m of a 512-byte block in word m % 128 at
// byte m / 128 (L = 9). A block's 16-byte quad q (words 4q .. 4q + 3) holds
// byte b of each at b * 2^(L-2) + 4q + i, so it gives the linear words
// b * 2^(L-4) + q: one 4 x 4 byte transpose (8 byte permutes) a quad. A
// block is 2^(L-4) quads, read by a team of 2^(L-9) warps before any of them
// writes it back: one warp, synced by __syncwarp (K13), or eight, by a
// named barrier a team (K14). Every thread of the block calls it once.
template <int L>
__device__ __forceinline__ void linearize(unsigned char* staged, uint32_t total, int c) {
  constexpr int kQuads = 1 << (L - 4);  // a block's quads: 32 or 256
  constexpr int kTeam = kQuads / 32;    // warps a block: 1 or 8
  const int team = (c >> 5) / kTeam;
  const int q = c & (kQuads - 1);
  for (uint32_t at = static_cast<uint32_t>(team) << L; at < total; at += (32u / kTeam) << L) {
    const uint4 w = reinterpret_cast<const uint4*>(staged + at)[q];
    if constexpr (kTeam == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(32 * kTeam) : "memory");
    }
    const uint32_t x01 = __byte_perm(w.x, w.y, 0x5140), x23 = __byte_perm(w.x, w.y, 0x7362);
    const uint32_t z01 = __byte_perm(w.z, w.w, 0x5140), z23 = __byte_perm(w.z, w.w, 0x7362);
    uint32_t* out = reinterpret_cast<uint32_t*>(staged + at) + q;
    out[0] = __byte_perm(x01, z01, 0x5410);
    out[kQuads] = __byte_perm(x01, z01, 0x7632);
    out[2 * kQuads] = __byte_perm(x23, z23, 0x5410);
    out[3 * kQuads] = __byte_perm(x23, z23, 0x7632);
  }
}

// __ballot_sync(kFullMask, (word & bit) != 0), the test one predicate-
// setting AND: through the intrinsic the compiler first makes it a 0/1
// register (a shift, an AND and a compare).
__device__ __forceinline__ unsigned ballot_bit(uint32_t word, uint32_t bit) {
  unsigned r;
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\t"
      "setp.ne.u32 p, t, 0;\n\t"
      "vote.sync.ballot.b32 %0, p, 0xffffffff;\n\t}"
      : "=r"(r)
      : "r"(word), "r"(bit));
  return r;
}

// The byte at a shared-memory address (the staged rows' addresses are
// uniform operands, so a byte's address is one add and one clamp).
__device__ __forceinline__ uint32_t shared_byte(uint32_t addr) {
  uint32_t b;
  asm("ld.shared.u8 %0, [%1];" : "=r"(b) : "r"(addr));
  return b;
}

// K15's staging, by warp 0 of the block: for each plane k present, the
// group's first rank r and count n of values in it, and from them the rows
// of the plane's stream that hold ranks r .. r + n - 1, clamped to the
// stream (a short, malformed stream: the plain version clamps a rank to the
// stream's last byte, which is then the window's last byte). The windows
// are staged back to back; window[k] and window[3 + k] take the staged
// offsets of the byte at rank r and of the window's last byte (any staged
// byte where n = 0: no value reads it) and window[6] the bytes staged,
// which the mbarrier expects. The source addresses are 64-bit, the shared
// offsets 32-bit (<= 3 windows of 36 KB).
template <int P>
__device__ __forceinline__ void stage_windows(const DzbvRows& rows, size_t g, int lane, unsigned char* staged,
                                              uint32_t* window, uint64_t* bar) {
  const size_t ng = gridDim.x;
  const unsigned char* src[3];
  uint32_t bytes[3];
  uint32_t at = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    src[k] = rows.rows[k];
    bytes[k] = 0;
    uint32_t first = 0, last = 0;
    if (rows.bytes[k] != 0) {
      const long long r = __ldg(rows.offsets + k * ng + g);
      const int n = __ldg(rows.counts + k * ng + g);
      if (n > 0) {
        const long long top = rows.stream_rows[k] - 1;
        const long long r0 = min(max(r >> 12, 0LL), top);
        const long long r1 = min(min(max((r + n - 1) >> 12, r0), top), r0 + kPlaneWindow / kPlaneRow - 1);
        bytes[k] = static_cast<uint32_t>(r1 - r0 + 1) * kPlaneRow;
        src[k] += r0 * kPlaneRow;
        first = at + static_cast<uint32_t>(min(max(r - r0 * kPlaneRow, 0LL), static_cast<long long>(bytes[k] - 1)));
        last = at + bytes[k] - 1;
      }
    }
    if (lane == 0) {
      window[k] = first;
      window[3 + k] = last;
    }
    at += bytes[k];
  }
  if (lane == 0) {
    window[6] = at;
    barrier_init(bar);
    barrier_init_fence();
    barrier_expect(bar, at);
  }
  __syncwarp();
  uint32_t to = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    for (uint32_t b = lane * kStagePiece; b < bytes[k]; b += 32 * kStagePiece)
      bulk_load(staged + to + b, src[k] + b, kStagePiece, bar);
    to += bytes[k];
  }
}

// P is the highest plane present (0: every value is one byte wide); a
// plane below it may be absent (bytes 0), and then no value reads it.
template <typename T, DzbvForm F, int P>
__global__ void __launch_bounds__(kLanes, 2)
    dzbv_staged_kernel(const uint32_t* __restrict__ widths, const uint32_t* __restrict__ plane0, const DzbvRows rows,
                       T* __restrict__ out) {
  if constexpr (P == 0) {
    unpack_store_lane<T, LutMode::kNone>(plane0, out, 8, 0u, Lut<LutMode::kNone>(nullptr, 0u, nullptr));
  } else {
    extern __shared__ __align__(128) unsigned char staged[];
    __shared__ uint64_t table[kSlots * 32];  // (slot, warp) -> three 16-bit fields
    __shared__ uint64_t bar;
    const size_t g = blockIdx.x;
    const int c = threadIdx.x;
    const int lane = c & 31;
    const int warp = c >> 5;
    // K15: the staged offsets of each plane's rank 0 and last byte, then
    // the bytes staged (stage_windows)
    uint32_t* window = nullptr;
    if constexpr (F == DzbvForm::kPlane) {
      __shared__ uint32_t group_window[7];
      window = group_window;
    }
    if (warp == 0) {  // the group's rows, first of all
      if constexpr (F == DzbvForm::kPlane) {
        stage_windows<P>(rows, g, lane, staged, window, &bar);
      } else {
        if (lane == 0) {
          barrier_init(&bar);
          barrier_init_fence();
          barrier_expect(&bar, rows.total);
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const unsigned char* src = rows.rows[k] + g * rows.bytes[k];
          for (uint32_t b = lane * kStagePiece; b < rows.bytes[k]; b += 32 * kStagePiece)
            bulk_load(staged + rows.off[k] + b, src + b, kStagePiece, &bar);
        }
      }
    }
    bool has[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) has[k] = rows.bytes[k] != 0;
    uint32_t mask[3];
    lane_plane_masks(widths, g, c, has, mask);

    // phase 1: each warp's count of the values wider than k + 1 bytes, by
    // slot. Four slots a turn of a rolled loop, with copies of the masks
    // shifted as it goes: unrolled, the compiler matches these tests with
    // phase 2's and keeps all 96 alive across the barriers, and spills.
    {
      uint32_t m[3] = {mask[0], mask[1], mask[2]};
      uint64_t* row = table + warp;
#pragma unroll 1
      for (int j = 0; j < kSlots / 4; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          uint64_t cnt = 0;
#pragma unroll
          for (int k = 0; k < P; ++k)
            cnt |= static_cast<uint64_t>(__popc(ballot_bit(m[k], 1u << b))) << (16 * k);
          if (lane == 0) row[b * 32] = cnt;
        }
#pragma unroll
        for (int k = 0; k < P; ++k) m[k] >>= 4;
        row += 4 * 32;
      }
    }
    __syncthreads();
    // entry c (slot c / 32, warp c % 32) in thread c
    const uint64_t x = table[c];
    uint64_t incl = x, entry;
    if constexpr (F == DzbvForm::kTile) {
      // the four warps of a tile are four neighbouring entries; tile
      // t = c / 4 starts at byte t * s_k of row k, and t * s_k plus the
      // tile's <= 96 values before its last warp stays below 2^16, so no
      // field carries
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const uint64_t y = __shfl_up_sync(kFullMask, incl, off, 4);
        if ((lane & 3) >= off) incl += y;
      }
      const uint32_t t = static_cast<uint32_t>(c) >> 2;
      entry = incl - x + ((static_cast<uint64_t>(t * rows.tile_hi) << 32) | (t * rows.tile_lo));
    } else {
      // exclusive scan of the 1024 entries in (slot, warp) order; a group's
      // counts are <= 32768, so no 16-bit field carries
      __shared__ uint64_t warp_sums[32];
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
      entry = ((static_cast<uint64_t>(hi) << 32) | lo) + incl - x;
    }
    barrier_wait(&bar, 0);
    linearize<F == DzbvForm::kTile ? 9 : 12>(staged, F == DzbvForm::kPlane ? window[6] : rows.total, c);
    table[c] = entry;
    __syncthreads();

    // phase 2: rank, one shared-memory byte a plane, store. first[k] and
    // last[k] are the shared-memory addresses of row k's first and last byte
    // (K15: of the window's byte at the group's rank 0, and of its last).
    const uint32_t base = smem_addr(staged);
    uint32_t first[3], last[3];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      first[k] = base + (F == DzbvForm::kPlane ? window[k] : rows.off[k]);
      last[k] = base + (F == DzbvForm::kPlane ? window[3 + k] : rows.last[k]);
    }
    const unsigned below = (1u << lane) - 1u;
    const uint32_t* p0 = plane0 + g * 8 * kLanes + c;
    T* o = out + g * kGroup + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bytes0 = __ldg(p0 + j * kLanes);  // plane 0 of slots 4j .. 4j + 3
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * j + b;
        const uint64_t e = table[i * 32 + warp];
        const uint32_t field[3] = {static_cast<uint32_t>(e) & 0xFFFFu, static_cast<uint32_t>(e) >> 16,
                                   static_cast<uint32_t>(e >> 32)};
        uint32_t v = __byte_perm(bytes0, 0u, 0x4440 | b);
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const bool sel = mask[k] & (1u << i);
          const unsigned ballot = ballot_bit(mask[k], 1u << i);
          const uint32_t at = field[k] + __popc(ballot & below) + first[k];
          // shared addresses and ranks are far below 2^31: a signed min is one instruction
          const uint32_t byte = shared_byte(min(static_cast<int>(at), static_cast<int>(last[k])));
          // byte k + 1 of v takes the plane's byte (selector nibble 4)
          const uint32_t insert = k == 0 ? 0x3240u : k == 1 ? 0x3410u : 0x4210u;
          if (F == DzbvForm::kGroup ? sel && at <= last[k] : sel) v = __byte_perm(v, byte, insert);
        }
        o[i * kLanes] = static_cast<T>(v);
      }
    }
  }
}

// The staged kernels' rows from the planes' streams and shapes (s_k for
// K13, w4_k for K14, the stream's rows of 32 KB for K15; nullptr where a
// plane is absent), and the highest plane present; false for a shape the
// form does not take.
template <DzbvForm F>
bool stage_rows(const void* const p[3], const long long a[3], DzbvRows* rows, int* top) {
  *rows = DzbvRows{};
  *top = 0;
  uint32_t off = 0;
  for (int k = 0; k < 3; ++k) {
    rows->rows[k] = static_cast<const unsigned char*>(p[k]);
    if (p[k] == nullptr) continue;
    uint32_t bytes;
    if constexpr (F == DzbvForm::kTile) {
      if (a[k] < 8 || a[k] > 128 || a[k] % 8 != 0) return false;
      bytes = 256u * static_cast<uint32_t>(a[k]);
      if (k < 2) {
        rows->tile_lo |= static_cast<uint32_t>(a[k]) << (16 * k);
      } else {
        rows->tile_hi = static_cast<uint32_t>(a[k]);
      }
    } else if constexpr (F == DzbvForm::kGroup) {
      if (a[k] < 1 || a[k] > 8) return false;
      bytes = 4096u * static_cast<uint32_t>(a[k]);
    } else {
      if (a[k] < 1 || a[k] > INT_MAX) return false;
      bytes = kPlaneWindow;
      rows->stream_rows[k] = a[k] * (kGroup / kPlaneRow);
    }
    rows->bytes[k] = bytes;
    rows->off[k] = off;
    rows->last[k] = off + bytes - 1u;
    off += bytes;
    *top = k + 1;
  }
  rows->total = off;
  return true;
}

// Checks the planes' shapes and alignment (the bulk copies need 16 bytes;
// K15's rows start at 4 KB multiples of its streams), and K15's ranks
// (offsets (3, ng) int64 and counts (3, ng) int32, needed where a plane is
// present), opts the kernel in to the staged rows' shared memory and
// launches it.
template <DzbvForm F>
int launch_staged(const void* widths, const void* plane0, const void* p1, const void* p2, const void* p3, long long a1,
                  long long a2, long long a3, const void* offsets, const void* counts, void* out, long long ng,
                  int out_bytes, void* stream) {
  if (!valid(ng, 1) || widths == nullptr || plane0 == nullptr || out == nullptr) return cudaErrorInvalidValue;
  const void* const p[3] = {p1, p2, p3};
  const long long a[3] = {a1, a2, a3};
  DzbvRows rows;
  int top;
  if (!stage_rows<F>(p, a, &rows, &top)) return cudaErrorInvalidValue;
  for (const void* q : p) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return cudaErrorInvalidValue;
  }
  if constexpr (F == DzbvForm::kPlane) {
    if (top > 0 && (offsets == nullptr || counts == nullptr)) return cudaErrorInvalidValue;
    rows.offsets = static_cast<const long long*>(offsets);
    rows.counts = static_cast<const int32_t*>(counts);
  }
  return dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    using Kernel = void (*)(const uint32_t*, const uint32_t*, DzbvRows, T*);
    const Kernel family[4] = {dzbv_staged_kernel<T, F, 0>, dzbv_staged_kernel<T, F, 1>, dzbv_staged_kernel<T, F, 2>,
                              dzbv_staged_kernel<T, F, 3>};
    const cudaError_t err = allow_staging(family[top], rows.total);
    if (err != cudaSuccess) return err;
    family[top]<<<static_cast<unsigned>(ng), kLanes, rows.total, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(widths), static_cast<const uint32_t*>(plane0), rows, static_cast<T*>(out));
    return cudaGetLastError();
  });
}

// -- K15's ranks ----------------------------------------------------------

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

}  // namespace gt

using gt::kLanes;

extern "C" {

// t1..t3: the trow streams (ng, 64 * s_k) of planes 1..3, nullptr where
// absent, 16-byte aligned (the bulk copies' requirement); s1..s3 their
// strides.
int gt_dzbv_tile_decode(const void* widths, const void* plane0, const void* t1, const void* t2, const void* t3,
                        long long s1, long long s2, long long s3, void* out, long long ng, int out_bytes,
                        void* stream) {
  return gt::launch_staged<gt::DzbvForm::kTile>(widths, plane0, t1, t2, t3, s1, s2, s3, nullptr, nullptr, out, ng,
                                                out_bytes, stream);
}

// r1..r3: the prow streams (ng, w4_k * 1024) of planes 1..3, nullptr where
// absent, 16-byte aligned; w1..w3 their w4_k.
int gt_dzbv_group_decode(const void* widths, const void* plane0, const void* r1, const void* r2, const void* r3,
                         long long w1, long long w2, long long w3, void* out, long long ng, int out_bytes,
                         void* stream) {
  return gt::launch_staged<gt::DzbvForm::kGroup>(widths, plane0, r1, r2, r3, w1, w2, w3, nullptr, nullptr, out, ng,
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
// where absent, 16-byte aligned; n1..n3 their row counts; counts: (3, ng)
// int32 of gt_dzbv_plane_counts, offsets: (3, ng) int64, their exclusive
// scan over the groups.
int gt_dzbv_plane_decode(const void* widths, const void* plane0, const void* q1, const void* q2, const void* q3,
                         long long n1, long long n2, long long n3, const void* offsets, const void* counts, void* out,
                         long long ng, int out_bytes, void* stream) {
  return gt::launch_staged<gt::DzbvForm::kPlane>(widths, plane0, q1, q2, q3, n1, n2, n3, offsets, counts, out, ng,
                                                 out_bytes, stream);
}

}  // extern "C"
