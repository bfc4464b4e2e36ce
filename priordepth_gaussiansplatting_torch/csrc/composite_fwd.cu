// K2: forward alpha compositing of each 16x16 tile over its sorted pairs.
//
// Replaces the TPU kernel priordepth_gaussiansplatting_tpu/
// ops/rasterize_pallas.py::_fwd_kernel (built in _make_composite).
//
// What it computes, per pixel of a tile, front to back over the tile's
// pair range [tile_start, tile_end) of the (10, L) ATTR_*-ordered table:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op e^power);
//   the pair is skipped if power > 0 or alpha < 1/255; the walk stops
//   before the pair that would take T below 1e-4; colour and inverse depth
//   accumulate with weight alpha T, and T <- T (1 - alpha).
// Outputs, for listed tile b: colour (3, n, 256), inverse depth (n, 256),
// final T (n, 256) and the number of pairs each pixel evaluated (n, 256),
// pixel index = 16 * row + column within the tile. The background is added
// by the caller.
//
// K6, the band form (composite_fwd_bands_launch), replaces the same TPU
// kernel built with _make_composite(num_local_tiles=...) and called through
// rasterize_pallas.py::composite_bands: slot b composites global tile
// tile_ids[b] over its own range [slot_start[b], slot_end[b]), so a pad slot
// (id 0, empty range) composites nothing: colour and inverse depth 0, T 1,
// no pair evaluated. The arithmetic is K2's, in the same kernel.
//
// Bound on the H100: operations. Each (pixel, pair) evaluation is about 20
// f32 operations and one expf, while the table is read once per tile (10
// words per pair), and the kernel is bound by instruction issue. Design
// (composite_eval.cuh): one block of 128 threads per tile, two vertically
// adjacent pixels per thread, so the two share dx, the column's terms of
// the power and every shared-memory load; pairs staged 128 at a time as
// 16-byte records; each warp (an 8x8 quarter of the tile) walks only the
// pairs that can reach alpha 1/255 somewhere in its quarter, which the
// staging thread decides from the conic and the opacity; the evaluation
// and the accumulation run without branches, as selects. Each thread keeps
// its running products T in registers (the TPU kernel's log-space scan,
// triangular matmuls and bit-packed lanes have no counterpart); a warp
// stops walking once all its pixels have stopped, the block once all 256
// have. expf is the accurate one and -fmad=false keeps power and alpha
// rounded as the plain version rounds them, so the 1/255 and 1e-4 cut-offs
// fall on the same pairs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_eval.cuh"

namespace {

using namespace composite;

// kSlotRanges: ranges are indexed by slot b (K6) instead of by tile id (K2).
template <bool kSlotRanges>
__global__ void __launch_bounds__(kThreads) composite_fwd_kernel(
    const float* __restrict__ table, int L, const int* __restrict__ tile_start,
    const int* __restrict__ tile_end, const int* __restrict__ tile_ids,
    int n_tiles, int grid_x, float* __restrict__ color,
    float* __restrict__ invd, float* __restrict__ final_t,
    int* __restrict__ n_eval) {
  __shared__ Staged s;
  const int b = blockIdx.x;
  const int t = tile_ids != nullptr ? tile_ids[b] : b;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const Pixels pix = thread_pixels(tid);
  const float tile_x0 = (float)(tx * kTile);
  const float tile_y0 = (float)(ty * kTile);
  const float px = (float)(tx * kTile + pix.col);
  const float py[2] = {(float)(ty * kTile + pix.row),
                       (float)(ty * kTile + pix.row + 1)};
  const int start = tile_start[kSlotRanges ? b : t];
  const int end = tile_end[kSlotRanges ? b : t];

  float T[2] = {1.0f, 1.0f}, c0[2] = {0.0f, 0.0f}, c1[2] = {0.0f, 0.0f};
  float c2[2] = {0.0f, 0.0f}, d[2] = {0.0f, 0.0f};
  int stop[2] = {-1, -1};
  for (int batch = start; batch < end; batch += kBatch) {
    const bool live = stop[0] < 0 || stop[1] < 0;
    // Also the barrier that protects the previous batch's shared memory.
    if (__syncthreads_count(live) == 0) break;
    stage(s, table, L, batch + tid, batch + tid < end, tile_x0, tile_y0);
    __syncthreads();
    for (int c = 0; c < kChunks; ++c) {
      unsigned m = s.list[warp][c];
      if (m == 0u) continue;
      if (!__any_sync(kFull, stop[0] < 0 || stop[1] < 0)) break;
      while (m != 0u) {
        const int j = c * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const float4 geo = s.geo[j];
        const float4 aux = s.aux[j];
        const float4 rgbd = s.col[j];
        const float dx = px - geo.x;
        const float adxx = geo.z * dx * dx;
        const float bdx = geo.w * dx;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const Eval e = evaluate(adxx, bdx, aux, py[p] - geo.y);
          float test_t;
          const int out = outcome(e, T[p], test_t);
          const bool live = stop[p] < 0;
          if (live && out == kStopped) stop[p] = batch + j;
          const bool kept = live && out == kKept;
          const float w = e.alpha * T[p];
          c0[p] = kept ? c0[p] + w * rgbd.x : c0[p];
          c1[p] = kept ? c1[p] + w * rgbd.y : c1[p];
          c2[p] = kept ? c2[p] + w * rgbd.z : c2[p];
          d[p] = kept ? d[p] + w * rgbd.w : d[p];
          T[p] = kept ? test_t : T[p];
        }
      }
    }
  }
  const size_t plane = (size_t)n_tiles * kPix;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const size_t o = (size_t)b * kPix + pix.index + p * kTile;
    color[o] = c0[p];
    color[plane + o] = c1[p];
    color[2 * plane + o] = c2[p];
    invd[o] = d[p];
    final_t[o] = T[p];
    n_eval[o] = evaluated(stop[p], start, end);
  }
}

template <bool kSlotRanges>
int launch(const void* table, int L, const void* tile_start,
           const void* tile_end, const void* tile_ids, int n_tiles, int grid_x,
           void* color, void* invd, void* final_t, void* n_eval,
           void* stream) {
  if (n_tiles > 0) {
    composite_fwd_kernel<kSlotRanges>
        <<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, L, (const int*)tile_start, (const int*)tile_end,
        (const int*)tile_ids, n_tiles, grid_x, (float*)color, (float*)invd,
        (float*)final_t, (int*)n_eval);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2: ranges indexed by tile id; tile_ids may be null (all tiles).
extern "C" int composite_fwd_launch(const void* table, int L,
                                    const void* tile_start,
                                    const void* tile_end, const void* tile_ids,
                                    int n_tiles, int grid_x, void* color,
                                    void* invd, void* final_t, void* n_eval,
                                    void* stream) {
  return launch<false>(table, L, tile_start, tile_end, tile_ids, n_tiles,
                       grid_x, color, invd, final_t, n_eval, stream);
}

// K6: one range per slot; tile_ids holds the slots' global tile ids.
extern "C" int composite_fwd_bands_launch(const void* table, int L,
                                          const void* slot_start,
                                          const void* slot_end,
                                          const void* tile_ids, int n_slots,
                                          int grid_x, void* color, void* invd,
                                          void* final_t, void* n_eval,
                                          void* stream) {
  return launch<true>(table, L, slot_start, slot_end, tile_ids, n_slots,
                      grid_x, color, invd, final_t, n_eval, stream);
}

// Resident blocks per SM of K2 and K6's forward (out[0], out[1]) and the
// threads of a block (out[2]), from the CUDA occupancy calculator.
extern "C" int composite_fwd_occupancy(int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], composite_fwd_kernel<false>, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], composite_fwd_kernel<true>, kThreads, 0);
  }
  out[2] = kThreads;
  return (int)err;
}

extern "C" const char* composite_fwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
