// Lane-major packed-group (LMP) reading on the device (FORMAT.md §0.1).
//
// A group holds GROUP = 32 * 1024 values. Lane c of the group is CUDA thread
// c of the block that decodes it. The lane's B-bit values live in B words at
// word offsets w * 1024 + c of the group's packed row, so a warp's loads of
// word w touch 32 neighbouring words (one 128-byte line). Slot i of the lane
// is bits [i*B, (i+1)*B) of those B words, stitched across two words where
// it straddles one, and decodes to linear position i * 1024 + c, so a
// warp's stores of slot i are coalesced too.
#pragma once

#include <cstdint>

namespace gt {

constexpr int kLanes = 1024;
constexpr int kSlots = 32;
constexpr int kGroup = kLanes * kSlots;

// Reads the 32 slots of one lane in order, loading each of its B words from
// device memory exactly once. B is a runtime value in [1, 32].
struct LaneReader {
  const uint32_t* words;  // the lane's word 0; word w is words[w * kLanes]
  int bits;
  uint32_t mask;
  uint32_t cur;  // word w
  int w;
  int s;  // bit offset of the next slot in cur, always in [0, 31]

  __device__ __forceinline__ LaneReader(const uint32_t* lane_words, int b)
      : words(lane_words),
        bits(b),
        mask(b == 32 ? 0xFFFFFFFFu : ((1u << b) - 1u)),
        cur(__ldg(lane_words)),
        w(0),
        s(0) {}

  __device__ __forceinline__ uint32_t next() {
    uint32_t v = cur >> s;  // s < 32: never a shift by the word width
    const int end = s + bits;
    if (end >= 32) {  // the slot uses up word w
      ++w;
      // after the last slot w == bits: there is no word to load
      const uint32_t nxt = w < bits ? __ldg(words + (size_t)w * kLanes) : 0u;
      // straddling slot: end > 32 forces s >= 1, so 32 - s is in [1, 31]
      if (end > 32) v |= nxt << (32 - s);
      cur = nxt;
      s = end - 32;
    } else {
      s = end;
    }
    return v & mask;
  }
};

}  // namespace gt
