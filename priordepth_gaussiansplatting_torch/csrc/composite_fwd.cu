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
// Bound on the H100: operations. Each (pixel, pair) evaluation costs about
// 20 f32 operations and one expf, while the table is read once per tile
// (10 words per pair, shared by 256 pixels). Design: one block per tile and
// one thread per pixel, as the CUDA rasterizer this system follows. The
// block stages batches of 256 pairs in shared memory, one pair per thread,
// so each pair is read from device memory once per tile. Each thread keeps
// its running product T in a register (the TPU kernel's log-space scan,
// triangular matmuls and bit-packed lanes have no counterpart), and the
// block leaves its loop as soon as every pixel has terminated
// (__syncthreads_count). expf is the accurate one (no fast math), and
// -fmad=false keeps power and alpha rounded as the plain version rounds
// them, so the 1/255 and 1e-4 cut-offs fall on the same pairs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kRows = 10;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

// kSlotRanges: ranges are indexed by slot b (K6) instead of by tile id (K2).
template <bool kSlotRanges>
__global__ void __launch_bounds__(kPix) composite_fwd_kernel(
    const float* __restrict__ table, int L, const int* __restrict__ tile_start,
    const int* __restrict__ tile_end, const int* __restrict__ tile_ids,
    int n_tiles, int grid_x, float* __restrict__ color,
    float* __restrict__ invd, float* __restrict__ final_t,
    int* __restrict__ n_eval) {
  __shared__ float s[kRows][kPix];
  const int b = blockIdx.x;
  const int t = tile_ids != nullptr ? tile_ids[b] : b;
  const int tid = threadIdx.x;
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const float px = (float)(tx * kTile + (tid % kTile));
  const float py = (float)(ty * kTile + (tid / kTile));
  const int start = tile_start[kSlotRanges ? b : t];
  const int end = tile_end[kSlotRanges ? b : t];

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f;
  int evaluated = 0;
  bool done = false;
  for (int batch = start; batch < end; batch += kPix) {
    // Also the barrier that protects the previous batch's shared rows.
    if (__syncthreads_count(!done) == 0) break;
    const int k = batch + tid;
    if (k < end) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r][tid] = table[(size_t)r * L + k];
    }
    __syncthreads();
    const int count = min(kPix, end - batch);
    for (int i = 0; i < count && !done; ++i) {
      const float dx = px - s[0][i];
      const float dy = py - s[1][i];
      const float power =
          -0.5f * (s[2][i] * dx * dx + s[4][i] * dy * dy) - s[3][i] * dx * dy;
      ++evaluated;
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaMax, s[5][i] * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 += w * s[6][i];
      c1 += w * s[7][i];
      c2 += w * s[8][i];
      d += w * s[9][i];
      T = test_t;
    }
  }
  const size_t o = (size_t)b * kPix + tid;
  const size_t plane = (size_t)n_tiles * kPix;
  color[o] = c0;
  color[plane + o] = c1;
  color[2 * plane + o] = c2;
  invd[o] = d;
  final_t[o] = T;
  n_eval[o] = evaluated;
}

template <bool kSlotRanges>
int launch(const void* table, int L, const void* tile_start,
           const void* tile_end, const void* tile_ids, int n_tiles, int grid_x,
           void* color, void* invd, void* final_t, void* n_eval,
           void* stream) {
  if (n_tiles > 0) {
    composite_fwd_kernel<kSlotRanges>
        <<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
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

extern "C" const char* composite_fwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
