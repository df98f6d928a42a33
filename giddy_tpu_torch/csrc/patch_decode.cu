// Exception-patched decode (FORMAT.md §1.11) of giddy_tpu_torch. Same
// conventions as lmp_decode.cu: plain C interface bound with ctypes by
// giddy_tpu_torch/kernels/_build.py; one block of 1024 threads per GROUP
// (grid = number of groups); the entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
// out_bytes 4/2/1 stores the uint32 payload or its low 16/8 bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "lmp.cuh"

namespace gt {

// K9. Replaces the Pallas kernel at giddy_tpu/kernels/patch.py:34 (bodies
// :45 for a FOR base, :56 for an nbit base) and the exception scatter after
// it (:81-92, `u.at[pos].set(val)`).
// Phase 1 is K2 (kFor) or K1: unpack lane c of the group's base words, add
// refs_g[g] for a FOR base, store at T (unpack_store_lane, lmp.cuh).
// Phase 2 writes the group's exceptions over it (patch_group, lmp.cuh; the
// positions are strictly ascending, FORMAT.md §1.11, and a narrow store
// truncates val, as patch.py:89-90 does). The same kernel serves both
// patch kinds: the compressed kind's positions come from K3.
// Bound: device-memory bytes: B/8 read and 4, 2 or 1 written a value, plus
// 8 bytes an exception.
template <typename T, bool kFor>
__global__ void __launch_bounds__(kLanes)
    patched_decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ refs_g,
                          const int32_t* __restrict__ pos, const uint32_t* __restrict__ val, T* __restrict__ out,
                          int bits, uint32_t count) {
  const uint32_t ref = kFor ? static_cast<uint32_t>(__ldg(refs_g + blockIdx.x)) : 0u;
  unpack_store_lane(packed, out, bits, ref, Lut<LutMode::kNone>(nullptr, 0u, nullptr));
  patch_group(pos, val, out, count);
}

}  // namespace gt

using gt::kLanes;

extern "C" {

// refs_g = nullptr decodes an nbit base, else a FOR base; count = 0 runs
// phase 1 only.
int gt_patched_decode(const void* packed, const void* refs_g, const void* pos, const void* val, void* out,
                      long long ng, int bits, long long count, int out_bytes, void* stream) {
  if (!gt::valid(ng, bits) || count < 0 || count > INT_MAX) return cudaErrorInvalidValue;
  if (count > 0 && (pos == nullptr || val == nullptr)) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    auto kernel = refs_g != nullptr ? gt::patched_decode_kernel<T, true> : gt::patched_decode_kernel<T, false>;
    kernel<<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(refs_g), static_cast<const int32_t*>(pos),
        static_cast<const uint32_t*>(val), static_cast<T*>(out), bits, static_cast<uint32_t>(count));
    return cudaGetLastError();
  });
}

}  // extern "C"
