// The four single-column decode kernels of giddy_tpu_torch: LMP unpack
// (nbit, dzbf), FOR, delta and dict. Plain C interface, bound with ctypes by
// giddy_tpu_torch/kernels/_build.py. Every kernel runs one block of 1024
// threads per GROUP (grid = number of groups); thread c decodes lane c.
//
// K1, K2 and K3 also take an optional table (lut, d): the fused dictionary
// stage of cascade decode (gt::Lut, lmp.cuh); lut = nullptr launches the
// plain kernel. K4 is K1 with the dictionary as its table.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
//
// Output element type: out_bytes = 4 stores the uint32 payload, 2 and 1
// store its low 16 or 8 bits (the narrow store of int16/uint16 and
// int8/uint8 columns; truncation is the inverse of the format's
// zero-extension).
//
// All arithmetic is uint32 and wraps mod 2^32 (FORMAT.md §0).

#include <cuda_runtime.h>

#include <cstdint>

#include "lmp.cuh"

namespace gt {

// K1. Replaces the Pallas kernel at giddy_tpu/kernels/nbit.py:24 (the body
// of nbit.build, through common.row_blocked_call, common.py:159/:222) and
// lanes.py:39-92 (unpack_slot / unpack_to).
// Bound: device-memory bytes. Each value reads B/8 bytes and writes 4, 2
// or 1; there is one shift, one OR and one mask per value. Design: loads
// and stores are warp-coalesced by the LMP layout, each word is read once,
// and no intermediate touches device memory (unpack_store_lane, lmp.cuh).
// With a table (Lut kShared / kGlobal) it is also K4, and the LUT stage of
// cascade over nbit / dzbf.
template <typename T, LutMode M>
__global__ void __launch_bounds__(kLanes)
    lmp_unpack_kernel(const uint32_t* __restrict__ packed, T* __restrict__ out, int bits,
                      const uint32_t* __restrict__ lut, uint32_t d) {
  extern __shared__ uint32_t lut_smem[];
  const Lut<M> map(lut, d, lut_smem);
  unpack_store_lane(packed, out, bits, 0u, map);
}

// K2. Replaces the Pallas kernel at giddy_tpu/kernels/for_.py:36 (unpack,
// then add the group's frame reference, FORMAT.md §1.2).
// Bound: device-memory bytes, as K1; the per-group reference is one 4-byte
// load per thread. Design: K1 with the wrapping add fused before the store,
// so the offsets never reach device memory.
template <typename T, LutMode M>
__global__ void __launch_bounds__(kLanes)
    for_unpack_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                      T* __restrict__ out, int bits, const uint32_t* __restrict__ lut, uint32_t d) {
  extern __shared__ uint32_t lut_smem[];
  const Lut<M> map(lut, d, lut_smem);
  unpack_store_lane(packed, out, bits, static_cast<uint32_t>(__ldg(refs_g + blockIdx.x)), map);
}

// K3. Replaces the Pallas kernel at giddy_tpu/kernels/delta.py:23 (unpack,
// unzigzag, inclusive per-GROUP cumsum via lanes.py:391 signed_cumsum ->
// :365 group_cumsum, plus anchors[g]).
// Bound: device-memory bytes, as K1, once the scan keeps up. Design: the
// block-row scan of lmp.cuh (block_row_scan<AddScan>, one barrier per row)
// with the anchor as its starting carry. The MXU byte-plane trick of the
// TPU kernel is not carried over.
template <typename T, LutMode M>
__global__ void __launch_bounds__(kLanes)
    delta_decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ anchors,
                        T* __restrict__ out, int bits, const uint32_t* __restrict__ lut, uint32_t d) {
  extern __shared__ uint32_t lut_smem[];
  __shared__ uint32_t warp_totals[2][32];
  const Lut<M> map(lut, d, lut_smem);
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  uint32_t carry = static_cast<uint32_t>(__ldg(anchors + g));
  LaneReader r(packed + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
  for (int i = 0; i < kSlots; ++i)
    o[i * kLanes] = static_cast<T>(map(block_row_scan<AddScan>(unzigzag(r.next()), carry, warp_totals, i)));
}

// K4. Replaces the Pallas kernel at giddy_tpu/kernels/dict_.py:70 with its
// fused gather (common.py:202-212, lanes.py:124 gather_lut) and the
// unpack-then-take fallback (dict_.py:88-114): K1 with the dictionary as
// its table.
// Bound: device-memory bytes, as K1, while the dictionary lookups stay on
// chip. Design: when the 4*d-byte dictionary fits a block's shared memory,
// each block stages it there and gathers from it (Lut kShared); above that
// the lookups are read-only global loads, served by L1/L2 for the hot part
// of the dictionary (kGlobal). A code past the dictionary (malformed input)
// is clamped to d - 1 rather than read out of bounds.

template <typename T>
int launch_lmp_unpack(const void* packed, void* out, long long ng, int bits, const void* lut, long long d,
                      cudaStream_t stream) {
  using K = void (*)(const uint32_t*, T*, int, const uint32_t*, uint32_t);
  const K family[3] = {lmp_unpack_kernel<T, LutMode::kNone>, lmp_unpack_kernel<T, LutMode::kShared>,
                       lmp_unpack_kernel<T, LutMode::kGlobal>};
  K kernel;
  size_t smem;
  const cudaError_t err = choose_lut(family, lut, d, &kernel, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ng), kLanes, smem, stream>>>(static_cast<const uint32_t*>(packed),
                                                               static_cast<T*>(out), bits,
                                                               static_cast<const uint32_t*>(lut),
                                                               static_cast<uint32_t>(d));
  return cudaGetLastError();
}

// K2 and K3 take the same arguments: packed words, one int32 per group
// (refs_g or anchors), the output.
template <typename T>
using SideKernel = void (*)(const uint32_t*, const int32_t*, T*, int, const uint32_t*, uint32_t);

template <typename T>
int launch_side(const SideKernel<T> (&family)[3], const void* packed, const void* side, void* out, long long ng,
                int bits, const void* lut, long long d, cudaStream_t stream) {
  SideKernel<T> kernel;
  size_t smem;
  const cudaError_t err = choose_lut(family, lut, d, &kernel, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ng), kLanes, smem, stream>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(side), static_cast<T*>(out), bits,
      static_cast<const uint32_t*>(lut), static_cast<uint32_t>(d));
  return cudaGetLastError();
}

}  // namespace gt

using gt::kLanes;

extern "C" {

int gt_lmp_unpack(const void* packed, void* out, long long ng, int bits, int out_bytes, const void* lut, long long d,
                  void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    return gt::launch_lmp_unpack<decltype(tag)>(packed, out, ng, bits, lut, d, static_cast<cudaStream_t>(stream));
  });
}

int gt_for_unpack(const void* packed, const void* refs_g, void* out, long long ng, int bits, int out_bytes,
                  const void* lut, long long d, void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    const gt::SideKernel<T> family[3] = {gt::for_unpack_kernel<T, gt::LutMode::kNone>,
                                         gt::for_unpack_kernel<T, gt::LutMode::kShared>,
                                         gt::for_unpack_kernel<T, gt::LutMode::kGlobal>};
    return gt::launch_side<T>(family, packed, refs_g, out, ng, bits, lut, d, static_cast<cudaStream_t>(stream));
  });
}

int gt_delta_decode(const void* packed, const void* anchors, void* out, long long ng, int bits, int out_bytes,
                    const void* lut, long long d, void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    const gt::SideKernel<T> family[3] = {gt::delta_decode_kernel<T, gt::LutMode::kNone>,
                                         gt::delta_decode_kernel<T, gt::LutMode::kShared>,
                                         gt::delta_decode_kernel<T, gt::LutMode::kGlobal>};
    return gt::launch_side<T>(family, packed, anchors, out, ng, bits, lut, d, static_cast<cudaStream_t>(stream));
  });
}

int gt_dict_decode(const void* codes, const void* values, void* out, long long ng, int bits, long long d,
                   int out_bytes, void* stream) {
  if (!gt::valid(ng, bits) || values == nullptr) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    return gt::launch_lmp_unpack<decltype(tag)>(codes, out, ng, bits, values, d, static_cast<cudaStream_t>(stream));
  });
}

// 1 when a dictionary of d entries is staged in shared memory on the
// current device (K1 and K4 have no static shared memory of their own),
// 0 when the kernel reads it from global memory.
int gt_dict_shared(long long d) {
  return static_cast<size_t>(d) * sizeof(uint32_t) <= static_cast<size_t>(gt::shared_optin_bytes());
}

}  // extern "C"
