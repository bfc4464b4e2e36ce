// K3: backward of the tile compositor (K2): per-pair gradients.
//
// Replaces the TPU kernel priordepth_gaussiansplatting_tpu/
// ops/rasterize_pallas.py::_bwd_kernel (built in _make_composite).
//
// What it computes. For listed tile b with pixel cotangents dC (3), dD, dT
// and the forward's saved colour C, inverse depth D and final T, each pixel
// walks its tile's pairs front to back exactly as K2 does (the same
// composite::evaluate, so under -fmad=false the 1/255 skip and the
// T < 1e-4 stop fall on K2's pairs), and for every kept pair k before the
// stop forms
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
// (n, 256), which equals K2's n_eval. Columns no pixel kept stay as the
// caller allocated them (zeros).
//
// Bound on the H100: operations. Per (pixel, pair) evaluation K2's ~20 f32
// operations and one expf, plus for each kept pair about 47 more and the
// sum of its 10 values over the tile's 256 pixels. Design: K2's walk
// (composite_eval.cuh: 128 threads, two pixels each, pairs staged 128 at a
// time as 16-byte records, each warp walking only the pairs its 8x8
// quarter can keep, the evaluation without branches), with 27 KB of shared
// memory a block. From the walk on, the gradient's products and sums are
// fused (fmaf) and its one division is __fdividef: they decide nothing, and
// the plain version is matched to the gradient rule. The per-pair sum over
// pixels is deterministic and costs a warp that kept nothing only its vote:
//   1. a thread adds its two pixels' rows (pixel 0 first);
//   2. a warp in which some lane kept the pair reduce-scatters the 10 rows
//      across its lanes in a fixed butterfly: at each xor step a lane sends
//      the half of its values that its partner keeps, 10 -> 5 -> 3 -> 2 ->
//      1 -> 1 values, 12 shuffles in all (a plain butterfly of each row
//      takes 50), leaving row r's warp sum in one lane;
//   3. those lanes store the warp's partial, and lane 0 sets the warp's bit
//      in the pair's mask in shared memory;
//   4. after the batch, each of the 128 threads takes one pair of it, adds
//      the partials of the warps in the pair's mask, in warp order, and
//      writes the column; a pair no warp kept is not written.
// Every column belongs to exactly one tile, so no atomics are needed across
// blocks (the TPU kernel's read-modify-write of shared floored chunks has
// no counterpart), and the sums' order depends only on the data.
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

#include "composite_eval.cuh"

namespace {

using namespace composite;

// One xor step of the reduce-scatter: of the N values a lane holds, lanes
// with the step's bit clear keep the first ceil(N/2) and those with it set
// the rest; each adds the partner's copy of the values it keeps.
template <int N>
__device__ __forceinline__ void scatter_step(const float (&in)[N],
                                             float (&out)[(N + 1) / 2],
                                             int bit, bool upper) {
  constexpr int kLow = (N + 1) / 2;
  constexpr int kHigh = N - kLow;
#pragma unroll
  for (int j = 0; j < kLow; ++j) {
    const float high = j < kHigh ? in[kLow + j] : 0.0f;
    const float send = upper ? in[j] : high;
    const float keep = upper ? high : in[j];
    out[j] = keep + __shfl_xor_sync(kFull, send, bit);
  }
}

// The warp's sum of row scatter_row(lane) of v, in that lane.
__device__ __forceinline__ float reduce_scatter(const float (&v)[kRows],
                                                int lane) {
  float a[5], b[3], c[2], d[1], e[1];
  scatter_step<10>(v, a, 16, lane & 16);
  scatter_step<5>(a, b, 8, lane & 8);
  scatter_step<3>(b, c, 4, lane & 4);
  scatter_step<2>(c, d, 2, lane & 2);
  scatter_step<1>(d, e, 1, lane & 1);
  return e[0];
}

// The row whose warp sum `lane` holds after reduce_scatter, or -1.
__device__ __forceinline__ int scatter_row(int lane) {
  if (lane & 1) return -1;
  int lo = 0, len = kRows, n = kRows;
  for (int bit = 16; bit >= 2; bit >>= 1) {
    const int low = (n + 1) / 2;
    if (lane & bit) {
      lo += low;
      len -= low;
    } else {
      len = min(len, low);
    }
    n = low;
  }
  return len > 0 ? lo : -1;
}

// kSlotRanges: ranges are indexed by slot b (K6) instead of by tile id (K3).
template <bool kSlotRanges>
__global__ void __launch_bounds__(kThreads) composite_bwd_kernel(
    const float* __restrict__ table, int L, const int* __restrict__ tile_start,
    const int* __restrict__ tile_end, const int* __restrict__ tile_ids,
    int n_tiles, int grid_x, const float* __restrict__ dC,
    const float* __restrict__ dD, const float* __restrict__ dT,
    const float* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ T_fin, float* __restrict__ d_table,
    int* __restrict__ n_eval) {
  __shared__ Staged s;
  // Warp partials (rows padded to spread the lanes' stores over banks) and
  // the warps that kept each pair.
  __shared__ float part[kWarps][kRows][kBatch + 1];
  __shared__ unsigned kept_by[kBatch];

  const int b = blockIdx.x;
  const int t = tile_ids != nullptr ? tile_ids[b] : b;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int my_row = scatter_row(lane);
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

  const size_t plane = (size_t)n_tiles * kPix;
  // Per pixel: the cotangents and R_total + dT T_fin.
  float g0[2], g1[2], g2[2], gd[2], rest[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const size_t o = (size_t)b * kPix + pix.index + p * kTile;
    g0[p] = dC[o];
    g1[p] = dC[plane + o];
    g2[p] = dC[2 * plane + o];
    gd[p] = dD[o];
    rest[p] = g0[p] * C[o] + g1[p] * C[plane + o] +
              g2[p] * C[2 * plane + o] + gd[p] * D[o] + dT[o] * T_fin[o];
  }

  float T[2] = {1.0f, 1.0f}, prefix[2] = {0.0f, 0.0f};
  int stop[2] = {-1, -1};
  for (int batch = start; batch < end; batch += kBatch) {
    const bool live = stop[0] < 0 || stop[1] < 0;
    // Also the barrier that protects the previous batch's shared memory.
    if (__syncthreads_count(live) == 0) break;
    stage(s, table, L, batch + tid, batch + tid < end, tile_x0, tile_y0);
    kept_by[tid] = 0u;
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
        const float adx = geo.z * dx;
        const float adxx = adx * dx;
        const float bdx = geo.w * dx;
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
        Eval e[2];
        float test_t[2];
        bool kept[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          e[p] = evaluate(adxx, bdx, aux, py[p] - geo.y);
          const int out = outcome(e[p], T[p], test_t[p]);
          const bool live = stop[p] < 0;
          if (live && out == kStopped) stop[p] = batch + j;
          kept[p] = live && out == kKept;
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (!kept[p]) continue;
          // The walk is evaluate's; from here the gradient's own products
          // and sums are fused and its division is the fast one.
          const float dy = py[p] - geo.y;
          const float alpha = e[p].alpha;
          const float w = alpha * T[p];
          const float rho = fmaf(gd[p], rgbd.w, fmaf(g2[p], rgbd.z,
                            fmaf(g1[p], rgbd.y, g0[p] * rgbd.x)));
          prefix[p] = fmaf(w, rho, prefix[p]);
          float g_alpha = fmaf(T[p], rho, -__fdividef(rest[p] - prefix[p],
                                                      1.0f - alpha));
          if (!(e[p].raw < kAlphaMax)) g_alpha = 0.0f;
          const float d_power = alpha * g_alpha;
          const float half_dp = -0.5f * d_power;
          v[0] = fmaf(d_power, fmaf(geo.w, dy, adx), v[0]);
          v[1] = fmaf(d_power, fmaf(aux.x, dy, bdx), v[1]);
          v[2] = fmaf(half_dp * dx, dx, v[2]);
          v[3] = fmaf(-d_power * dx, dy, v[3]);
          v[4] = fmaf(half_dp * dy, dy, v[4]);
          v[5] = fmaf(e[p].G, g_alpha, v[5]);
          v[6] = fmaf(w, g0[p], v[6]);
          v[7] = fmaf(w, g1[p], v[7]);
          v[8] = fmaf(w, g2[p], v[8]);
          v[9] = fmaf(w, gd[p], v[9]);
          T[p] = test_t[p];
        }
        const bool touched = kept[0] || kept[1];
        if (__any_sync(kFull, touched)) {
          const float sum = reduce_scatter(v, lane);
          if (my_row >= 0) part[warp][my_row][j] = sum;
          if (lane == 0) atomicOr(&kept_by[j], 1u << warp);
        }
      }
    }
    __syncthreads();
    const int j = tid;
    const unsigned warps = j < min(kBatch, end - batch) ? kept_by[j] : 0u;
    if (warps != 0u) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (warps & (1u << w)) acc += part[w][r][j];
        }
        d_table[(size_t)r * L + batch + j] = acc;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    n_eval[(size_t)b * kPix + pix.index + p * kTile] =
        evaluated(stop[p], start, end);
  }
}

template <bool kSlotRanges>
int launch(const void* table, int L, const void* tile_start,
           const void* tile_end, const void* tile_ids, int n_tiles, int grid_x,
           const void* dC, const void* dD, const void* dT, const void* C,
           const void* D, const void* T_fin, void* d_table, void* n_eval,
           void* stream) {
  if (n_tiles > 0) {
    composite_bwd_kernel<kSlotRanges>
        <<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
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

// Resident blocks per SM of K3 and K6's backward (out[0], out[1]) and the
// threads of a block (out[2]), from the CUDA occupancy calculator.
extern "C" int composite_bwd_occupancy(int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], composite_bwd_kernel<false>, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], composite_bwd_kernel<true>, kThreads, 0);
  }
  out[2] = kThreads;
  return (int)err;
}

extern "C" const char* composite_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
