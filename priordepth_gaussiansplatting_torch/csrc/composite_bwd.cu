// K3: backward of the tile compositor (K2): per-pair gradients.
//
// Replaces the TPU kernel priordepth_gaussiansplatting_tpu/
// ops/rasterize_pallas.py::_bwd_kernel (built in _make_composite).
//
// What it computes. For listed tile b with pixel cotangents dC (3), dD, dT
// and the forward's saved colour C, inverse depth D and final T, each pixel
// walks its tile's pairs front to back exactly as K2 does (same expression
// order, so under -fmad=false the 1/255 skip and the T < 1e-4 stop fall on
// K2's pairs), and for every kept pair k before the stop forms
//   rho_k    = sum_c dC_c rgb_kc + dD invd_k,
//   R_total  = sum_c dC_c C_c + dD D,     P_k = sum_{j<=k} w_j rho_j,
//   g_alpha  = T_k rho_k - (R_total - P_k + dT T_fin) / (1 - alpha_k)
//              (0 where op G >= 0.99: the clamp has no gradient),
//   d_power  = alpha_k g_alpha,
// and from it the pixel's share of the pair's gradient row, in ATTR_* order:
//   d_mx = d_power (ca dx + cb dy),   d_my = d_power (cc dy + cb dx),
//   d_ca = -d_power dx^2 / 2,         d_cb = -d_power dx dy,
//   d_cc = -d_power dy^2 / 2,         d_op = G g_alpha,
//   d_rgb = w_k dC,                   d_invd = w_k dD.
// This is the JAX kernel's forward sweep with suffix = R_total - prefix; it
// needs no division by (1 - alpha) to recover T, so it does not drift.
// Output: d_table (10, L) with each pair column written once, by the block
// of the tile that owns it, plus each pixel's count of evaluated pairs
// (n, 256), which must equal K2's n_eval. Columns no pixel reached stay as
// the caller allocated them (zeros).
//
// Bound on the H100: operations. Per (pixel, pair) evaluation about 20 f32
// operations and one expf, as K2, plus for each kept pair about 30 more and
// the reduction of its 10 values over the tile's 256 pixels. Design: one
// block per tile, one thread per pixel, pairs staged 256 at a time in
// shared memory as in K2. The per-pair sum over pixels is deterministic:
// each warp reduces the 10 values with __shfl_xor_sync in a fixed order
// (skipped when no lane of the warp touched the pair), the 8 warp partials
// go to shared memory, and one thread per pair adds them in warp order and
// writes the column. Every column belongs to exactly one tile, so no atomics
// are needed across blocks (the TPU kernel's read-modify-write of shared
// floored chunks has no counterpart). A warp whose pixels have all stopped
// leaves the batch early; the block leaves when all 256 have stopped.
//
// K6, the band form (composite_bwd_bands_launch), replaces the same TPU
// kernel built with _make_composite(num_local_tiles=...) for
// rasterize_pallas.py::composite_bands: slot b walks global tile tile_ids[b]
// over its own range [slot_start[b], slot_end[b]). A pad slot (id 0, empty
// range) writes nothing, and no column outside the band's ranges is
// written, so a band's table is zero off its own pairs and the bands'
// tables sum to the whole frame's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kRows = 10;
constexpr int kWarps = kPix / 32;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory: the staged pairs, then the warp partials.
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kRows * kPix + (size_t)kWarps * kRows * kPix);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// kSlotRanges: ranges are indexed by slot b (K6) instead of by tile id (K3).
template <bool kSlotRanges>
__global__ void __launch_bounds__(kPix) composite_bwd_kernel(
    const float* __restrict__ table, int L, const int* __restrict__ tile_start,
    const int* __restrict__ tile_end, const int* __restrict__ tile_ids,
    int n_tiles, int grid_x, const float* __restrict__ dC,
    const float* __restrict__ dD, const float* __restrict__ dT,
    const float* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ T_fin, float* __restrict__ d_table,
    int* __restrict__ n_eval) {
  extern __shared__ float smem[];
  float* s = smem;                     // [kRows][kPix] staged pair rows
  float* part = smem + kRows * kPix;   // [kWarps][kRows][kPix] warp sums
  __shared__ int warp_pairs[kWarps];   // pairs of the batch each warp summed

  const int b = blockIdx.x;
  const int t = tile_ids != nullptr ? tile_ids[b] : b;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const float px = (float)(tx * kTile + (tid % kTile));
  const float py = (float)(ty * kTile + (tid / kTile));
  const int start = tile_start[kSlotRanges ? b : t];
  const int end = tile_end[kSlotRanges ? b : t];

  const size_t o = (size_t)b * kPix + tid;
  const size_t plane = (size_t)n_tiles * kPix;
  const float g0 = dC[o];
  const float g1 = dC[plane + o];
  const float g2 = dC[2 * plane + o];
  const float gd = dD[o];
  const float r_total =
      g0 * C[o] + g1 * C[plane + o] + g2 * C[2 * plane + o] + gd * D[o];
  const float dt_tfin = dT[o] * T_fin[o];

  float T = 1.0f, prefix = 0.0f;
  int evaluated = 0;
  bool done = false;
  for (int batch = start; batch < end; batch += kPix) {
    // Also the barrier that protects the previous batch's shared memory.
    if (__syncthreads_count(!done) == 0) break;
    const int k = batch + tid;
    if (k < end) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r * kPix + tid] = table[(size_t)r * L + k];
    }
    __syncthreads();
    const int count = min(kPix, end - batch);
    int i = 0;
    for (; i < count; ++i) {
      if (__all_sync(kFull, done)) break;
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
      bool touched = false;
      if (!done) {
        // K2's arithmetic, in K2's order.
        const float dx = px - s[0 * kPix + i];
        const float dy = py - s[1 * kPix + i];
        const float ca = s[2 * kPix + i];
        const float cb = s[3 * kPix + i];
        const float cc = s[4 * kPix + i];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        ++evaluated;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float raw = s[5 * kPix + i] * G;
          const float alpha = fminf(kAlphaMax, raw);
          if (alpha >= kAlphaMin) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < kTEps) {
              done = true;
            } else {
              const float w = alpha * T;
              const float rho = g0 * s[6 * kPix + i] + g1 * s[7 * kPix + i] +
                                g2 * s[8 * kPix + i] + gd * s[9 * kPix + i];
              prefix += w * rho;
              const float suffix = r_total - prefix;
              float g_alpha = T * rho - (suffix + dt_tfin) / (1.0f - alpha);
              if (!(raw < kAlphaMax)) g_alpha = 0.0f;
              const float d_power = alpha * g_alpha;
              v[0] = d_power * (ca * dx + cb * dy);
              v[1] = d_power * (cc * dy + cb * dx);
              v[2] = -0.5f * d_power * dx * dx;
              v[3] = -d_power * dx * dy;
              v[4] = -0.5f * d_power * dy * dy;
              v[5] = G * g_alpha;
              v[6] = w * g0;
              v[7] = w * g1;
              v[8] = w * g2;
              v[9] = w * gd;
              T = test_t;
              touched = true;
            }
          }
        }
      }
      float mine = 0.0f;
      if (__any_sync(kFull, touched)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float sum = warp_sum(v[r]);
          if (lane == r) mine = sum;
        }
      }
      if (lane < kRows) part[(warp * kRows + lane) * kPix + i] = mine;
    }
    if (lane == 0) warp_pairs[warp] = i;
    __syncthreads();
    if (tid < count) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (tid < warp_pairs[w]) acc += part[(w * kRows + r) * kPix + tid];
        }
        d_table[(size_t)r * L + batch + tid] = acc;
      }
    }
  }
  n_eval[o] = evaluated;
}

template <bool kSlotRanges>
int launch(const void* table, int L, const void* tile_start,
           const void* tile_end, const void* tile_ids, int n_tiles, int grid_x,
           const void* dC, const void* dD, const void* dT, const void* C,
           const void* D, const void* T_fin, void* d_table, void* n_eval,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<kSlotRanges>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    composite_bwd_kernel<kSlotRanges>
        <<<n_tiles, kPix, kSmemBytes, (cudaStream_t)stream>>>(
        (const float*)table, L, (const int*)tile_start, (const int*)tile_end,
        (const int*)tile_ids, n_tiles, grid_x, (const float*)dC,
        (const float*)dD, (const float*)dT, (const float*)C, (const float*)D,
        (const float*)T_fin, (float*)d_table, (int*)n_eval);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K3: ranges indexed by tile id; tile_ids may be null (all tiles).
extern "C" int composite_bwd_launch(
    const void* table, int L, const void* tile_start, const void* tile_end,
    const void* tile_ids, int n_tiles, int grid_x, const void* dC,
    const void* dD, const void* dT, const void* C, const void* D,
    const void* T_fin, void* d_table, void* n_eval, void* stream) {
  return launch<false>(table, L, tile_start, tile_end, tile_ids, n_tiles,
                       grid_x, dC, dD, dT, C, D, T_fin, d_table, n_eval,
                       stream);
}

// K6: one range per slot; tile_ids holds the slots' global tile ids.
extern "C" int composite_bwd_bands_launch(
    const void* table, int L, const void* slot_start, const void* slot_end,
    const void* tile_ids, int n_slots, int grid_x, const void* dC,
    const void* dD, const void* dT, const void* C, const void* D,
    const void* T_fin, void* d_table, void* n_eval, void* stream) {
  return launch<true>(table, L, slot_start, slot_end, tile_ids, n_slots,
                      grid_x, dC, dD, dT, C, D, T_fin, d_table, n_eval,
                      stream);
}

extern "C" const char* composite_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
