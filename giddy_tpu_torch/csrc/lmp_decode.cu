// The four single-column decode kernels of giddy_tpu_torch: LMP unpack
// (nbit, dzbf), FOR, delta and dict. Plain C interface, bound with ctypes by
// giddy_tpu_torch/kernels/_build.py. Every kernel runs one block of 1024
// threads per GROUP (grid = number of groups); thread c decodes lane c.
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
// and no intermediate touches device memory.
template <typename T>
__global__ void __launch_bounds__(kLanes)
    lmp_unpack_kernel(const uint32_t* __restrict__ packed, T* __restrict__ out, int bits) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  LaneReader r(packed + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) o[i * kLanes] = static_cast<T>(r.next());
}

// K2. Replaces the Pallas kernel at giddy_tpu/kernels/for_.py:36 (unpack,
// then add the group's frame reference, FORMAT.md §1.2).
// Bound: device-memory bytes, as K1; the per-group reference is one 4-byte
// load per thread. Design: K1 with the wrapping add fused before the store,
// so the offsets never reach device memory.
template <typename T>
__global__ void __launch_bounds__(kLanes)
    for_unpack_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                      T* __restrict__ out, int bits) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t ref = static_cast<uint32_t>(__ldg(refs_g + g));
  LaneReader r(packed + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) o[i * kLanes] = static_cast<T>(r.next() + ref);
}

// K3. Replaces the Pallas kernel at giddy_tpu/kernels/delta.py:23 (unpack,
// unzigzag, inclusive per-GROUP cumsum via lanes.py:391 signed_cumsum ->
// :365 group_cumsum, plus anchors[g]).
// Bound: device-memory bytes, as K1, once the scan keeps up. Design: the
// block-row scan of lmp.cuh (block_row_scan<AddScan>, one barrier per row)
// with the anchor as its starting carry. The MXU byte-plane trick of the
// TPU kernel is not carried over.
template <typename T>
__global__ void __launch_bounds__(kLanes)
    delta_decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ anchors,
                        T* __restrict__ out, int bits) {
  __shared__ uint32_t warp_totals[2][32];
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  uint32_t carry = static_cast<uint32_t>(__ldg(anchors + g));
  LaneReader r(packed + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
  for (int i = 0; i < kSlots; ++i)
    o[i * kLanes] = static_cast<T>(block_row_scan<AddScan>(unzigzag(r.next()), carry, warp_totals, i));
}

// K4. Replaces the Pallas kernel at giddy_tpu/kernels/dict_.py:70 with its
// fused gather (common.py:202-212, lanes.py:124 gather_lut) and the
// unpack-then-take fallback (dict_.py:88-114), in one kernel.
// Bound: device-memory bytes, as K1, while the dictionary lookups stay on
// chip. Design: when the 4*d-byte dictionary fits a block's shared memory
// (kShared), each block stages it there and gathers from it; above that the
// lookups are read-only global loads, served by L1/L2 for the hot part of
// the dictionary. A code past the dictionary (malformed input) is clamped
// to d - 1 rather than read out of bounds.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kLanes)
    dict_decode_kernel(const uint32_t* __restrict__ codes, const uint32_t* __restrict__ values,
                       T* __restrict__ out, int bits, uint32_t d) {
  extern __shared__ uint32_t table[];
  if (kShared) {
    for (uint32_t j = threadIdx.x; j < d; j += blockDim.x) table[j] = __ldg(values + j);
    __syncthreads();
  }
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  LaneReader r(codes + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const uint32_t code = min(r.next(), d - 1);
    o[i * kLanes] = static_cast<T>(kShared ? table[code] : __ldg(values + code));
  }
}

// Largest dictionary staged in shared memory: what one block may opt in to.
int dict_shared_max_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}

template <typename T>
int launch_dict(const void* codes, const void* values, void* out, long long ng, int bits,
                long long d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(uint32_t);
  const auto* c = static_cast<const uint32_t*>(codes);
  const auto* v = static_cast<const uint32_t*>(values);
  if (smem <= static_cast<size_t>(dict_shared_max_bytes())) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          dict_decode_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    dict_decode_kernel<T, true><<<static_cast<unsigned>(ng), kLanes, smem, stream>>>(
        c, v, static_cast<T*>(out), bits, static_cast<uint32_t>(d));
  } else {
    dict_decode_kernel<T, false><<<static_cast<unsigned>(ng), kLanes, 0, stream>>>(
        c, v, static_cast<T*>(out), bits, static_cast<uint32_t>(d));
  }
  return cudaGetLastError();
}

}  // namespace gt

using gt::kLanes;

extern "C" {

int gt_lmp_unpack(const void* packed, void* out, long long ng, int bits, int out_bytes, void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    gt::lmp_unpack_kernel<T><<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<T*>(out), bits);
    return cudaGetLastError();
  });
}

int gt_for_unpack(const void* packed, const void* refs_g, void* out, long long ng, int bits, int out_bytes,
                  void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    gt::for_unpack_kernel<T><<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(refs_g), static_cast<T*>(out), bits);
    return cudaGetLastError();
  });
}

int gt_delta_decode(const void* packed, const void* anchors, void* out, long long ng, int bits, int out_bytes,
                    void* stream) {
  if (!gt::valid(ng, bits)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    gt::delta_decode_kernel<T><<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(anchors), static_cast<T*>(out), bits);
    return cudaGetLastError();
  });
}

int gt_dict_decode(const void* codes, const void* values, void* out, long long ng, int bits, long long d,
                   int out_bytes, void* stream) {
  if (!gt::valid(ng, bits) || d < 1 || d > 0xFFFFFFFFLL) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    return gt::launch_dict<decltype(tag)>(codes, values, out, ng, bits, d, static_cast<cudaStream_t>(stream));
  });
}

// 1 when a dictionary of d entries is staged in shared memory on the
// current device, 0 when the kernel reads it from global memory.
int gt_dict_shared(long long d) {
  return static_cast<size_t>(d) * sizeof(uint32_t) <= static_cast<size_t>(gt::dict_shared_max_bytes());
}

}  // extern "C"
