// The per-value epilogue decoders of giddy_tpu_torch: model (FORMAT.md
// §1.7), incidence bitmaps (§1.8) and ALP floats (§1.16). Each unpacks LMP
// words and applies a per-value epilogue before the store. Same conventions
// as lmp_decode.cu: plain C interface bound with ctypes by
// giddy_tpu_torch/kernels/_build.py; one block of 1024 threads per GROUP
// (grid = number of groups), thread c decodes lane c and stores slot i at
// g * 32768 + i * 1024 + c, so loads and stores are warp-coalesced; every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take. out_bytes 4/2/1 stores the uint32 payload or
// its low 16/8 bits. All integer arithmetic wraps mod 2^32.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lmp.cuh"

namespace gt {

// K10. Replaces the Pallas kernel at giddy_tpu/kernels/model.py:51 (body
// :56-79): out = a_g + b_g*p (+ c_g*p*p) + unzigzag(residual), with p =
// i*1024 + c the position within the group and (a_g, b_g, c_g) the frame's
// polynomial shifted to the group start on the host (kernels/model.py
// prep). The reference's step form (base + step*i + step2*i*i) is a TPU
// vectorisation; the prediction from p is equally exact mod 2^32.
// Bound: device-memory bytes, B/8 read and 4, 2 or 1 written a value; the
// epilogue is a few integer multiply-adds a value.
template <typename T, bool kPoly2>
__global__ void __launch_bounds__(kLanes)
    model_decode_kernel(const uint32_t* __restrict__ packed, const uint32_t* __restrict__ a_g,
                        const uint32_t* __restrict__ b_g, const uint32_t* __restrict__ c_g, T* __restrict__ out,
                        int bits) {
  const size_t g = blockIdx.x;
  const uint32_t c = threadIdx.x;
  const uint32_t a = __ldg(a_g + g), b = __ldg(b_g + g);
  const uint32_t cc = kPoly2 ? __ldg(c_g + g) : 0u;
  LaneReader r(packed + g * bits * kLanes + c, bits);
  T* o = out + g * kGroup + c;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const uint32_t p = static_cast<uint32_t>(i) * kLanes + c;
    uint32_t pred = a + b * p;
    if constexpr (kPoly2) pred += cc * (p * p);
    o[i * kLanes] = static_cast<T>(pred + unzigzag(r.next()));
  }
}

// K11. Replaces the Pallas kernel at giddy_tpu/kernels/bitmap.py:25 (body
// :51-55, call :63) and its XLA loop above d = 64 (:31-43, a VMEM limit of
// the TPU): one kernel for every d >= 1. Thread c keeps its lane's 32
// values in registers; for each plane it loads one word (bitmaps are LMP(1),
// so slot i of lane c is bit i of word g*1024 + c of the plane: one
// coalesced 128-byte line a warp), reads values[dd] through the read-only
// cache (one address a warp), and adds bit * value to each accumulator. It
// sums rather than selects, as the oracle does, so a position with two
// incident bits (malformed input) decodes to the sum in both.
// Bound: bytes, d/8 read and 4, 2 or 1 written a value, below d ~ 23 on
// the H100; above that operations, about 3 a plane and value (shift, and,
// multiply-add).
template <typename T>
__global__ void __launch_bounds__(kLanes)
    bitmap_decode_kernel(const uint32_t* __restrict__ bitmaps, const uint32_t* __restrict__ values,
                         T* __restrict__ out, size_t plane_words, uint32_t d) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  uint32_t acc[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = 0u;
  const uint32_t* word = bitmaps + g * kLanes + c;
#pragma unroll 4
  for (uint32_t dd = 0; dd < d; ++dd) {
    const uint32_t w = __ldg(word + dd * plane_words);
    const uint32_t v = __ldg(values + dd);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) acc[i] += ((w >> i) & 1u) * v;
  }
  T* o = out + g * kGroup + c;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) o[i * kLanes] = static_cast<T>(acc[i]);
}

// K12. Replaces the Pallas kernel at giddy_tpu/kernels/alp.py:40 (body
// :47-61) and the exception scatter after it (:67-72). Phase 1 reads the
// offsets (B bits) and the corrections (B_c bits) with two LaneReaders side
// by side: enc = int32(v + refs_g[g]), m = f32(enc) * f32(10^-e), out =
// bits(m) + unzigzag(corr). Bit-exactness rests on two single, correctly
// rounded IEEE operations: __int2float_rn and __fmul_rn (which nothing may
// contract), built without fast-math or flush-to-zero flags. The scale is
// the host's f32(10^-e) as bits (scale_bits): exp10f and powf are not
// correctly rounded, so 10^-e is never computed here. Phase 2 writes the
// group's exceptions (patch_group, lmp.cuh; patch_pos is ascending).
// Bound: device-memory bytes, (B + B_c)/8 read and 4 written a value, plus
// 8 bytes an exception.
__global__ void __launch_bounds__(kLanes)
    alp_decode_kernel(const uint32_t* __restrict__ packed, const uint32_t* __restrict__ corr,
                      const uint32_t* __restrict__ refs_g, const int32_t* __restrict__ pos,
                      const uint32_t* __restrict__ val, uint32_t* __restrict__ out, int bits, int corr_bits,
                      uint32_t scale_bits, uint32_t count) {
  const size_t g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t ref = __ldg(refs_g + g);
  const float scale = __uint_as_float(scale_bits);
  LaneReader rv(packed + g * bits * kLanes + c, bits);
  LaneReader rc(corr + g * corr_bits * kLanes + c, corr_bits);
  uint32_t* o = out + g * kGroup + c;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int32_t enc = static_cast<int32_t>(rv.next() + ref);
    const float m = __fmul_rn(__int2float_rn(enc), scale);
    o[i * kLanes] = __float_as_uint(m) + unzigzag(rc.next());
  }
  patch_group(pos, val, out, count);
}

}  // namespace gt

using gt::kLanes;

extern "C" {

// c_g = nullptr decodes a linear column, else a poly2 one.
int gt_model_decode(const void* packed, const void* a_g, const void* b_g, const void* c_g, void* out, long long ng,
                    int bits, int out_bytes, void* stream) {
  if (!gt::valid(ng, bits) || a_g == nullptr || b_g == nullptr) return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    auto kernel = c_g != nullptr ? gt::model_decode_kernel<T, true> : gt::model_decode_kernel<T, false>;
    kernel<<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(a_g), static_cast<const uint32_t*>(b_g),
        static_cast<const uint32_t*>(c_g), static_cast<T*>(out), bits);
    return cudaGetLastError();
  });
}

// bitmaps is (d, ng * 1024) words, plane dd at dd * ng * 1024.
int gt_bitmap_decode(const void* bitmaps, const void* values, void* out, long long ng, long long d, int out_bytes,
                     void* stream) {
  if (ng < 1 || ng > INT_MAX || d < 1 || d > 0xFFFFFFFFLL || bitmaps == nullptr || values == nullptr)
    return cudaErrorInvalidValue;
  return gt::dispatch_out(out_bytes, [&](auto tag) -> int {
    using T = decltype(tag);
    gt::bitmap_decode_kernel<T><<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bitmaps), static_cast<const uint32_t*>(values), static_cast<T*>(out),
        static_cast<size_t>(ng) * kLanes, static_cast<uint32_t>(d));
    return cudaGetLastError();
  });
}

// scale_bits is the float32 f32(10^-e) as its bit pattern; count = 0 runs
// phase 1 only. The output is the float32 column's uint32 bits.
int gt_alp_decode(const void* packed, const void* corr, const void* refs_g, const void* pos, const void* val, void* out,
                  long long ng, int bits, int corr_bits, unsigned scale_bits, long long count, void* stream) {
  if (!gt::valid(ng, bits) || !gt::valid(ng, corr_bits) || refs_g == nullptr || count < 0 || count > INT_MAX)
    return cudaErrorInvalidValue;
  if (count > 0 && (pos == nullptr || val == nullptr)) return cudaErrorInvalidValue;
  gt::alp_decode_kernel<<<static_cast<unsigned>(ng), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(corr), static_cast<const uint32_t*>(refs_g),
      static_cast<const int32_t*>(pos), static_cast<const uint32_t*>(val), static_cast<uint32_t*>(out), bits,
      corr_bits, scale_bits, static_cast<uint32_t>(count));
  return cudaGetLastError();
}

}  // extern "C"
