// The LMP pack of device encode (K18): the inverse of K1, with the value
// transform of the FOR and delta encoders fused in front of it. Plain C
// interface, bound with ctypes by giddy_tpu_torch/kernels/_build.py. One
// block of 1024 threads per GROUP (grid = number of groups); thread c packs
// lane c.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
//
// All arithmetic is uint32 and wraps mod 2^32 (FORMAT.md §0).

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "lmp.cuh"

namespace gt {

// What is done to each value before it is packed.
enum class Prologue : int {
  kNone = 0,         // nbit, dict codes: the value as it is
  kForSub = 1,       // FOR: v - refs[frame], frame = g / groups_per_frame
  kDeltaZigzag = 2,  // delta: zigzag(v[j] - v[j - 1]), 0 at j == 0 and j >= n
};

// K18. Replaces the Pallas kernel at giddy_tpu/kernels/encode.py:45
// (_pack_call; body pack_lanes_to :28-42, call :52-59), and folds into its
// one pass the jnp passes of delta_streams_device (:77-90: the difference
// with the previous value, the tail mask, the zigzag) and of
// for_streams_device (:104-109: the subtract of the frame's reference).
// The per-frame min and the delta anchors stay outside (kernels/encode.py).
// Bound: device-memory bytes. Each value reads 4 bytes and writes B/8;
// there are about 3 integer operations a value (shift, OR, a second shift
// and OR where a slot straddles), +1 for the FOR subtract, +6 for delta.
// Design: thread c loads slot i of its lane from v[g*GROUP + i*1024 + c],
// so a warp's loads coalesce, and gt::LaneWriter<B> stores each of the B
// output words once, coalesced across the warp. B is a template argument,
// so every shift is a constant and only the word being filled is live. The
// delta prologue reads v[j - 1] with a second load, from L1/L2: the
// neighbour's value, or the previous slot's last lane, or the previous
// group's last value.
template <int B, Prologue P>
__global__ void __launch_bounds__(kLanes)
    lmp_pack_kernel(const uint32_t* __restrict__ values, const uint32_t* __restrict__ refs,
                    uint32_t* __restrict__ packed, long long n, int groups_per_frame) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t* v = values + g * kGroup + c;
  uint32_t ref = 0u;
  if constexpr (P == Prologue::kForSub) ref = __ldg(refs + g / groups_per_frame);
  LaneWriter<B> out(packed + g * B * kLanes + c);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    uint32_t x = __ldg(v + i * kLanes);
    if constexpr (P == Prologue::kForSub) x -= ref;
    if constexpr (P == Prologue::kDeltaZigzag) {
      const long long j = static_cast<long long>(g) * kGroup + i * kLanes + c;
      const uint32_t prev = __ldg(v + i * kLanes - (j != 0));  // v[j - 1]; at j == 0 a valid address, unused
      const uint32_t d = (j == 0 || j >= n) ? 0u : x - prev;
      x = (d << 1) ^ (0u - (d >> 31));
    }
    out.put(i, x);
  }
}

using PackKernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*, long long, int);

// The instance of K18 for width bits (1..32) and prologue P.
template <Prologue P, int... I>
PackKernel pick_width(int bits, std::integer_sequence<int, I...>) {
  const PackKernel family[] = {lmp_pack_kernel<I + 1, P>...};
  return family[bits - 1];
}

template <Prologue P>
PackKernel pick(int bits) {
  return pick_width<P>(bits, std::make_integer_sequence<int, kSlots>{});
}

}  // namespace gt

extern "C" {

// values: (ng, GROUP) uint32; packed: (ng, bits * 1024) uint32 out;
// prologue: 0 none, 1 FOR subtract (refs: one per frame of
// groups_per_frame groups), 2 delta zigzag (n: the logical length).
int gt_lmp_pack(const void* values, const void* refs, void* packed, long long ng, int bits, int prologue,
                long long n, int groups_per_frame, void* stream) {
  if (!gt::valid(ng, bits) || groups_per_frame < 1) return cudaErrorInvalidValue;
  gt::PackKernel kernel;
  switch (prologue) {
    case 0: kernel = gt::pick<gt::Prologue::kNone>(bits); break;
    case 1:
      if (refs == nullptr) return cudaErrorInvalidValue;
      kernel = gt::pick<gt::Prologue::kForSub>(bits);
      break;
    case 2: kernel = gt::pick<gt::Prologue::kDeltaZigzag>(bits); break;
    default: return cudaErrorInvalidValue;
  }
  kernel<<<static_cast<unsigned>(ng), gt::kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const uint32_t*>(refs), static_cast<uint32_t*>(packed), n,
      groups_per_frame);
  return cudaGetLastError();
}

}  // extern "C"
