// What the tile compositor's forward (K2, composite_fwd.cu) and backward
// (K3, composite_bwd.cu) share: the block's pixel layout, the staging of a
// batch of pairs into shared memory, and the evaluation of one pair at one
// pixel. Both kernels walk a pixel's pairs through composite::evaluate and
// composite::outcome, so the 1/255 skip and the T < 1e-4 stop fall on the
// same pairs in both and K3's count of evaluated pairs is K2's.
//
// Layout. One block of 128 threads per 16x16 tile; warp w owns the 8x8
// quarter of the tile at column 8 (w % 2), row 8 (w / 2), and its lane l
// owns column l % 8 of rows 2 (l / 8) and 2 (l / 8) + 1 of that quarter, so
// the two pixels of a thread share dx and every staged word. Pairs are
// staged 128 at a time (one per thread) as three 16-byte records,
// {mx, my, ca, cb}, {cc, op, -, -} and {r, g, b, inverse depth}: a warp
// reads a pair's geometry with two 16-byte loads and its colour with a
// third.
//
// Which warps walk a pair. A pixel keeps a pair only if alpha >= 1/255,
// so only if power >= thr, with thr = log((1/255) / op) - 1e-3 (below it
// op e^power stays under 1/255 by a factor e^-1e-3, far beyond the
// rounding of expf, logf and the product), that is only if
// q = a dx^2 + 2 b dx dy + c dy^2 = -2 power <= -2 thr. The staging thread
// bounds q from below over each warp's quarter: 0 if it holds the mean,
// else the least of q on its four edges (on an edge, the ends' values and,
// where the line's minimiser lies on the edge, dy^2 (ac - b^2) / a, or
// dx^2 (ac - b^2) / c), and lists the pair for the warps whose bound is at
// most -2 thr with 3 % to spare: the float power differs from -q / 2 by at
// most 4u (1 + rho) / (1 - rho) of it, u = 2^-24 and rho = |b| / sqrt(ac)
// (1e-4 for rho^2 <= 0.99), and the bound's own rounding is of the same
// order. The quarter's corners are the pixels' dx and dy rounded as the
// walk rounds them, and rounding is monotonic, so every pixel's (dx, dy)
// lies in that box. A conic that is not positive definite with
// rho^2 <= 0.99, or values large enough to overflow the power, go to every
// warp. Each warp walks only the pairs listed for it; a pair it skips
// could not have been kept by any of its pixels, so every pixel's walk, and
// every output, is what walking all pairs gives. The count of evaluated
// pairs does not need the walk either: a pixel evaluates every pair of its
// range up to the one that stops it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace composite {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kRows = 10;         // the table's rows (ATTR_* order)
constexpr int kThreads = 128;     // two pixels per thread
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = kThreads;  // pairs staged at a time, one per thread
constexpr int kChunks = kBatch / 32;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// One batch of staged pairs and, per warp, the pairs it walks.
struct Staged {
  float4 geo[kBatch];  // mx, my, ca, cb
  float4 aux[kBatch];  // cc, op, unused, unused
  float4 col[kBatch];  // r, g, b, inverse depth
  // Bit j of list[w][c]: pair 32 c + j may be kept by a pixel of warp w.
  unsigned list[kWarps][kChunks];
};

// The thread's two pixels: column, first row (the second is one below) and
// the first pixel's index 16 row + column in the tile.
struct Pixels {
  int col, row, index;
};

__device__ __forceinline__ Pixels thread_pixels(int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int col = 8 * (warp & 1) + (lane & 7);
  const int row = 8 * (warp >> 1) + 2 * (lane >> 3);
  return {col, row, row * kTile + col};
}

// Powers below this cannot reach alpha 1/255 (NaN when op is not positive
// or is NaN; +inf when op is 0).
__device__ __forceinline__ float skip_threshold(float op) {
  return logf(kAlphaMin / op) - 1e-3f;
}

// The least of q(x, y) = a x^2 + 2 b x y + c y^2 over x in [x0, x1] at
// height y, or less: the ends' values and, where the minimiser -b y / a
// lies in the range (widened for its rounding), y^2 det / a.
__device__ __forceinline__ float edge_min(float a, float b, float c,
                                          float det, float x0, float x1,
                                          float y) {
  const float cyy = c * y * y;
  float m = fminf(a * x0 * x0 + 2.0f * b * x0 * y + cyy,
                  a * x1 * x1 + 2.0f * b * x1 * y + cyy);
  const float xs = -b * y / a;
  const float slack = 1e-3f * (1.0f + fabsf(x0) + fabsf(x1));
  if (xs >= x0 - slack && xs <= x1 + slack) m = fminf(m, y * y * det / a);
  return m;
}

// The warps of a tile whose top-left pixel is (tile_x0, tile_y0) that can
// keep a pair at (mx, my) with conic (a, b, c) and threshold thr (see the
// header note).
__device__ __forceinline__ unsigned keeping_warps(float mx, float my, float a,
                                                  float b, float c, float thr,
                                                  float tile_x0,
                                                  float tile_y0) {
  constexpr unsigned kAll = (1u << kWarps) - 1u;
  const bool in_range = fabsf(mx) < 1e8f && fabsf(my) < 1e8f &&
                        a < 1e12f && fabsf(b) < 1e12f && c < 1e12f;
  if (!in_range || !(a > 0.0f) || !(c > 0.0f)) return kAll;
  // thr >= 0: op < 1/255, so no pixel keeps the pair; NaN: op <= 0 or NaN.
  if (!(thr < 0.0f)) return thr >= 0.0f ? 0u : kAll;
  const float ac = a * c;
  const float det = ac - b * b;
  if (!(det >= 0.01f * ac)) return kAll;
  const float limit = -2.06f * thr;
  unsigned warps = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float left = tile_x0 + (float)(8 * (w & 1));
    const float top = tile_y0 + (float)(8 * (w >> 1));
    const float x0 = left - mx, x1 = (left + 7.0f) - mx;
    const float y0 = top - my, y1 = (top + 7.0f) - my;
    bool walk = x0 <= 0.0f && x1 >= 0.0f && y0 <= 0.0f && y1 >= 0.0f;
    if (!walk) {
      const float m = fminf(
          fminf(edge_min(a, b, c, det, x0, x1, y0),
                edge_min(a, b, c, det, x0, x1, y1)),
          fminf(edge_min(c, b, a, det, y0, y1, x0),
                edge_min(c, b, a, det, y0, y1, x1)));
      walk = m <= limit;
    }
    if (walk) warps |= 1u << w;
  }
  return warps;
}

// Stage pair k of the (kRows, L) table into this thread's slot when
// `valid`, and publish each warp's list of the batch's pairs. Every thread
// of the block calls it.
__device__ __forceinline__ void stage(Staged& s, const float* __restrict__ table,
                                      int L, int k, bool valid, float tile_x0,
                                      float tile_y0) {
  const int tid = threadIdx.x;
  unsigned warps = 0u;
  if (valid) {
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = table[(size_t)r * L + k];
    const float thr = skip_threshold(v[5]);
    s.geo[tid] = make_float4(v[0], v[1], v[2], v[3]);
    s.aux[tid] = make_float4(v[4], v[5], 0.0f, 0.0f);
    s.col[tid] = make_float4(v[6], v[7], v[8], v[9]);
    warps = keeping_warps(v[0], v[1], v[2], v[3], v[4], thr, tile_x0,
                          tile_y0);
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned bits = __ballot_sync(kFull, (warps >> w) & 1u);
    if ((tid & 31) == 0) s.list[w][tid >> 5] = bits;
  }
}

enum Outcome : int { kSkipped = 0, kKept = 1, kStopped = 2 };

// One pixel against one pair, in K2's arithmetic and order:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op e^power),
// skipped if power > 0 or alpha < 1/255. adxx = (a dx) dx and bdx = b dx
// are the column's terms, rounded as the full expression rounds them.
// Every value is computed without a branch (a warp walks a pair only when
// some lane of it may keep the pair, so the warp would take the expf path
// anyway); `hit` says whether the walk uses them.
struct Eval {
  float G, raw, alpha;  // e^power, op G, min(0.99, op G)
  bool hit;             // not skipped
};

__device__ __forceinline__ Eval evaluate(float adxx, float bdx, float4 aux,
                                         float dy) {
  Eval e;
  const float power = -0.5f * (adxx + aux.x * dy * dy) - bdx * dy;
  e.G = expf(power);
  e.raw = aux.y * e.G;
  e.alpha = fminf(kAlphaMax, e.raw);
  e.hit = !(power > 0.0f) && !(e.alpha < kAlphaMin);
  return e;
}

// What a live pixel with transmittance T does with an evaluated pair:
// test_t = T (1 - alpha), and it stops there if test_t < 1e-4.
__device__ __forceinline__ int outcome(const Eval& e, float T,
                                       float& test_t) {
  test_t = T * (1.0f - e.alpha);
  return !e.hit ? kSkipped : test_t < kTEps ? kStopped : kKept;
}

// Pairs a pixel evaluated: every pair of [start, end) up to the one that
// stopped it (stop < 0: none did).
__device__ __forceinline__ int evaluated(int stop, int start, int end) {
  return stop >= 0 ? stop - start + 1 : end - start;
}

}  // namespace composite
