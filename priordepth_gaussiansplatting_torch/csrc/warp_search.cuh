// A lower-bound search by one warp, shared by K1 and K7
// (csrc/expand_pairs.cu, the owner of a block's first pair slot) and K4
// (csrc/segment_reduce.cu, the columns a block owns). Its plain form is
// ops/binning.py::warp_lower_bound_plain.
#pragma once

#include <cuda_runtime.h>

// The first position in ascending a[lo, hi) whose value is >= x (hi if
// none), found by the 32 lanes of a warp together: each round lane l tests
// a[lo + l * step] with step = ceil((hi - lo) / 32), and the count c of
// tests below x leaves (lo + (c - 1) step, lo + c step] (c = 0: lo itself),
// so 2.6M keys take five rounds of one load per lane. Every lane of the
// warp calls it with the same arguments and gets the same result.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int lo, int hi, int x) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int c = __popc(__ballot_sync(0xffffffffu, p < hi && a[p] < x));
    if (c == 0) {
      hi = lo;
    } else {
      const int next_lo = lo + (c - 1) * step + 1;
      hi = min(lo + c * step, hi);
      lo = next_lo;
    }
  }
  return lo;
}
