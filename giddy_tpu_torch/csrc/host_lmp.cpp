// Host codec hot loops of the PyTorch port: lane-major packed-group (LMP)
// pack and unpack, the dzbv byte-plane split and zigzag, with OpenMP.
//
// The port's own copy of the C++ host codec beside the JAX reference
// (native/lmp.cpp), under the same extern "C" entry points. The NumPy code
// in giddy_tpu_torch/ref/lmp.py, ref/dzbv.py and util.py is normative: this
// file must give the same bytes (tests/test_torch_native.py holds it to
// both). Built with g++ by giddy_tpu_torch/native.py at first use; the CUDA
// build (kernels/_build.py) takes only csrc/*.cu.
//
// Layout (FORMAT.md §0.1): group g, lane c, slot i; value v[g*32768+i*1024+c]
// occupies bits [i*B, (i+1)*B) of lane c's little-endian 32*B-bit buffer;
// word w of the group is packed[g][w*1024 + c].

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int64_t LANES = 1024;
constexpr int64_t SLOTS = 32;
constexpr int64_t GROUP = LANES * SLOTS;
// Below 2^21 values (64 groups, ~1-2 ms of one core's work) a loop runs on
// the calling thread: waking the pool costs more than it saves there, and
// idle pool threads spin for a while after each region, which slows every
// other process on the host's cores (many small encodes, as tests make).
constexpr int64_t PAR_MIN_VALUES = int64_t(1) << 21;
}  // namespace

extern "C" {

// v has ng*GROUP values; words has ng*bits*LANES slots, which need not be
// initialised: each group's words are zeroed by the thread that packs it.
void lmp_pack_u32(const uint32_t* v, uint32_t* words, int64_t ng, int bits) {
#pragma omp parallel for schedule(static) if (ng * GROUP >= PAR_MIN_VALUES)
  for (int64_t g = 0; g < ng; ++g) {
    const uint32_t* vg = v + g * GROUP;
    uint32_t* wg = words + g * (int64_t)bits * LANES;
    std::memset(wg, 0, sizeof(uint32_t) * (size_t)bits * LANES);
    for (int i = 0; i < SLOTS; ++i) {
      const int64_t bit = (int64_t)i * bits;
      const int w0 = (int)(bit / 32), s = (int)(bit % 32);
      const uint32_t* row = vg + (int64_t)i * LANES;
      uint32_t* lo = wg + (int64_t)w0 * LANES;
      if (s + bits > 32) {
        uint32_t* hi = lo + LANES;
        for (int64_t c = 0; c < LANES; ++c) {
          lo[c] |= row[c] << s;
          hi[c] |= row[c] >> (32 - s);
        }
      } else if (s) {
        for (int64_t c = 0; c < LANES; ++c) lo[c] |= row[c] << s;
      } else {
        for (int64_t c = 0; c < LANES; ++c) lo[c] |= row[c];
      }
    }
  }
}

void lmp_unpack_u32(const uint32_t* words, uint32_t* v, int64_t ng, int bits) {
  const uint32_t mask = bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
#pragma omp parallel for schedule(static) if (ng * GROUP >= PAR_MIN_VALUES)
  for (int64_t g = 0; g < ng; ++g) {
    const uint32_t* wg = words + g * (int64_t)bits * LANES;
    uint32_t* vg = v + g * GROUP;
    for (int i = 0; i < SLOTS; ++i) {
      const int64_t bit = (int64_t)i * bits;
      const int w0 = (int)(bit / 32), s = (int)(bit % 32);
      const uint32_t* lo = wg + (int64_t)w0 * LANES;
      uint32_t* row = vg + (int64_t)i * LANES;
      if (s + bits > 32) {
        const uint32_t* hi = lo + LANES;
        for (int64_t c = 0; c < LANES; ++c)
          row[c] = ((lo[c] >> s) | (hi[c] << (32 - s))) & mask;
      } else if (s) {
        for (int64_t c = 0; c < LANES; ++c) row[c] = (lo[c] >> s) & mask;
      } else {
        for (int64_t c = 0; c < LANES; ++c) row[c] = lo[c] & mask;
      }
    }
  }
}

// dzbv byte-plane split (FORMAT.md §1.10), step 1: wm1[i] = byte width of
// u[i] minus one; counts[k-1] = number of values of width > k for k = 1..3
// (the compacted plane sizes the caller allocates before dzbv_fill).
void dzbv_widths(const uint32_t* u, int64_t n, uint32_t* wm1, int64_t* counts) {
  int64_t c1 = 0, c2 = 0, c3 = 0;
#pragma omp parallel for schedule(static) reduction(+ : c1, c2, c3) if (n >= PAR_MIN_VALUES)
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t x = u[i];
    const uint32_t w = x > 0xFFFFFFu ? 3u : x > 0xFFFFu ? 2u : x > 0xFFu ? 1u : 0u;
    wm1[i] = w;
    c1 += w >= 1; c2 += w >= 2; c3 += w >= 3;
  }
  counts[0] = c1; counts[1] = c2; counts[2] = c3;
}

// Step 2, the compacted fill: plane 0 gets byte 0 of every value; plane
// k > 0 gets byte k of the values of width > k, in value order. Parallel
// over chunks, with a serial exclusive scan of the chunks' counts between
// the two passes (so the order is stable).
void dzbv_fill(const uint32_t* u, const uint32_t* wm1, int64_t n,
               uint32_t* p0, uint32_t* p1, uint32_t* p2, uint32_t* p3) {
  constexpr int64_t CHUNK = 1 << 16;
  const int64_t nch = (n + CHUNK - 1) / CHUNK;
  std::vector<int64_t> off1(nch + 1, 0), off2(nch + 1, 0), off3(nch + 1, 0);
#pragma omp parallel for schedule(static) if (n >= PAR_MIN_VALUES)
  for (int64_t ch = 0; ch < nch; ++ch) {
    const int64_t a = ch * CHUNK, b = std::min(n, a + CHUNK);
    int64_t c1 = 0, c2 = 0, c3 = 0;
    for (int64_t i = a; i < b; ++i) {
      c1 += wm1[i] >= 1; c2 += wm1[i] >= 2; c3 += wm1[i] >= 3;
    }
    off1[ch + 1] = c1; off2[ch + 1] = c2; off3[ch + 1] = c3;
  }
  for (int64_t ch = 0; ch < nch; ++ch) {
    off1[ch + 1] += off1[ch]; off2[ch + 1] += off2[ch]; off3[ch + 1] += off3[ch];
  }
#pragma omp parallel for schedule(static) if (n >= PAR_MIN_VALUES)
  for (int64_t ch = 0; ch < nch; ++ch) {
    const int64_t a = ch * CHUNK, b = std::min(n, a + CHUNK);
    int64_t o1 = off1[ch], o2 = off2[ch], o3 = off3[ch];
    for (int64_t i = a; i < b; ++i) {
      const uint32_t x = u[i], w = wm1[i];
      p0[i] = x & 0xFFu;
      if (w >= 1) p1[o1++] = (x >> 8) & 0xFFu;
      if (w >= 2) p2[o2++] = (x >> 16) & 0xFFu;
      if (w >= 3) p3[o3++] = (x >> 24) & 0xFFu;
    }
  }
}

// ZigZag (FORMAT.md §0.2) for the delta, delta2 and alp encodes.
void zigzag_i32(const int32_t* d, uint32_t* z, int64_t n) {
#pragma omp parallel for schedule(static) if (n >= PAR_MIN_VALUES)
  for (int64_t i = 0; i < n; ++i)
    z[i] = ((uint32_t)d[i] << 1) ^ (uint32_t)(d[i] >> 31);
}

void unzigzag_u32(const uint32_t* z, int32_t* d, int64_t n) {
#pragma omp parallel for schedule(static) if (n >= PAR_MIN_VALUES)
  for (int64_t i = 0; i < n; ++i)
    d[i] = (int32_t)((z[i] >> 1) ^ (~(z[i] & 1u) + 1u));
}

}  // extern "C"
