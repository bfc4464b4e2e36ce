// K1: (Gaussian, tile) pair expansion with the exact ellipse-vs-tile cull,
// and K7 (second entry point, expand_tiles_launch): the same expansion
// without the attribute copy and without the cull.
//
// K1 replaces the TPU kernel priordepth_gaussiansplatting_tpu/ops/binning.py
// ::_expand_attrs_kernel_factory (launched from _bin_sorted_core); K7
// replaces ::_expand_kernel_factory (launched from bin_gaussians).
//
// What it computes, for every pair slot pos < min(total, p_cap):
//   * the owning Gaussian j in depth order: the last j whose exclusive pair
//     offset is <= pos (upper_bound - 1 over the ascending offsets; empty
//     rects sit at the tail with offset == total and are never chosen);
//   * rank = pos - offset_j, tile = base_j + (rank / nx_j) * grid_x
//     + rank % nx_j, all in integer arithmetic;
//   * j's 10 attribute rows (ATTR_* order), copied to the slot;
//   * the cull: keep the pair iff the minimum of j's conic quadratic over
//     the tile's 16x16 pixel box is <= 2 ln(255 op) + 1e-3 (the same closed
//     form and slack as the TPU kernel, in f32);
//   * tile id (num_tiles when culled or for padding slots), Gaussian id,
//     attributes, and a per-tile histogram of kept pairs (int32 atomics,
//     which are exact, so the histogram is deterministic).
// Slots pos >= min(total, p_cap) get tile num_tiles, id -1 and zero rows.
// The output index is pos, so a stable sort by tile id afterwards gives
// depth order within each tile, exactly the TPU kernel's pair order.
//
// Bound on the H100: bytes. Every slot up to p_cap writes 12 words (48
// bytes, the padding slots' -1 ids and zero rows included) and each
// Gaussian that owns a slot is read once (14 words); the cull is ~70 f32
// operations per slot, far below the byte time.
//
// Design. One thread per slot, 256 slots a block, so the load is balanced
// whatever a Gaussian's rect size. The first design searched each slot's
// owner alone (20 dependent loads over the 1M offsets) and then made 10
// separate 4-byte reads of the owner's attribute rows, which the
// neighbouring slots repeated. Now:
//   * warp 0 finds the owner j0 of the block's first slot by a 32-way
//     search (csrc/warp_search.cuh, four rounds for 1M offsets);
//   * the block's owners are j0, j0 + 1, ... up to the owner of its last
//     live slot: at most 256 (a live Gaussian owns at least one slot, the
//     live offsets ascend strictly). Thread t reads offset j0 + t, and the
//     block stages the owners' offsets, rect bases, widths, ids and 10
//     attribute rows in shared memory once, each row one coalesced read
//     (ops/binning.py::owner_window_plain is the plain form of the window);
//   * each slot finds its owner by a binary search over the window in
//     shared memory (8 steps) and reads its attributes from there.
// On the full scene (1M Gaussians, 2.6M slots) the staging is what pays:
// the search alone, or the histogram aggregated per warp
// (__match_any_sync, few tiles repeat within a warp), two slots a thread,
// streaming stores and the cull's per-Gaussian terms staged gained nothing
// measurable on the H100. What is left is the 48 bytes written per slot
// and the histogram's one global atomic per kept pair.
// Should the window not hold the block's owners (offsets that do not
// ascend strictly, which the depth sort does not produce), the block
// searches each slot's owner in device memory as the first design did, so
// the result follows the same rule. The TPU kernel's windowed DMA, its
// compare-matrix ranking and its one-hot MXU gathers have no counterpart.
// Writes are coalesced row by row.
//
// K7 keeps every live pair: per slot it writes the tile and the Gaussian id
// and bumps the tile's histogram bin. Its offsets are those of all N
// Gaussians in depth order, zero-count rects included: a run of equal
// offsets ends with the one Gaussian of the run that owns pairs, and the
// search's last-offset-<=-pos rule picks exactly it, so no slot below the
// total lands on a zero-width rect (and none divides by 0). The rect width
// is a full int, so rects of 256 tiles or more expand as any other. Bound:
// bytes, as K1's (8 written per slot, the owner's 16 read mostly from L2).
// K7 keeps the first design: one search per slot, one atomic per pair.
//
// Built with -fmad=false: the cull must round exactly as the plain PyTorch
// version (and the TPU reference) do, and a contracted multiply-add would
// round once where they round twice.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "warp_search.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kRows = 10;
constexpr int kThreads = 256;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float q_at(float ca, float cb, float cc, float dx,
                                      float dy) {
  return ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy;
}

// upper_bound(offsets[0, n), pos) - 1: the last Gaussian whose exclusive
// offset is <= pos. For pos < total it owns at least one pair.
__device__ __forceinline__ int owner(const int* __restrict__ offsets, int n,
                                     int pos) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= pos) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// The tile of pair slot pos of Gaussian j: row-major over j's rect.
__device__ __forceinline__ int tile_of(const int* __restrict__ offsets,
                                       const int* __restrict__ base,
                                       const int* __restrict__ nx, int j,
                                       int pos, int grid_x) {
  const int rank = pos - offsets[j];
  const int w = nx[j];
  const int q = rank / w;
  return base[j] + q * grid_x + (rank - q * w);
}

// Whether the pair of a Gaussian (attribute rows a) and `tile` is kept:
// the exact minimum of its conic quadratic over the tile's pixel box
// against 2 ln(255 op) + 1e-3.
__device__ __forceinline__ bool cull_keep(const float* a, int tile,
                                          int grid_x) {
  const float mx = a[0], my = a[1], ca = a[2], cb = a[3], cc = a[4],
              op = a[5];
  const int ty = tile / grid_x;
  const int tx = tile - ty * grid_x;
  const float dxl = (float)(tx * kTile) - mx;
  const float dxh = dxl + (float)(kTile - 1);
  const float dyl = (float)(ty * kTile) - my;
  const float dyh = dyl + (float)(kTile - 1);
  const bool inside = (dxl <= 0.0f) && (dxh >= 0.0f) && (dyl <= 0.0f) &&
                      (dyh >= 0.0f);
  const float ica = 1.0f / fmaxf(ca, 1e-12f);
  const float icc = 1.0f / fmaxf(cc, 1e-12f);
  const float qx0 = q_at(ca, cb, cc, dxl, clampf(-cb * dxl * icc, dyl, dyh));
  const float qx1 = q_at(ca, cb, cc, dxh, clampf(-cb * dxh * icc, dyl, dyh));
  const float qy0 = q_at(ca, cb, cc, clampf(-cb * dyl * ica, dxl, dxh), dyl);
  const float qy1 = q_at(ca, cb, cc, clampf(-cb * dyh * ica, dxl, dxh), dyh);
  const float qmin =
      inside ? 0.0f : fminf(fminf(qx0, qx1), fminf(qy0, qy1));
  const float tau = 2.0f * logf(fmaxf(op, 1e-12f) * 255.0f);
  return qmin <= tau + 1e-3f;
}

__global__ void __launch_bounds__(kThreads) expand_pairs_kernel(
    const int* __restrict__ offsets, const int* __restrict__ base,
    const int* __restrict__ nx, const int* __restrict__ gid,
    const float* __restrict__ attrs, const int* __restrict__ total, int n,
    int p_cap, int grid_x, int num_tiles, int* __restrict__ tile_out,
    int* __restrict__ gid_out, float* __restrict__ attrs_out,
    int* __restrict__ hist) {
  // The block's owners: offset, rect base, rect width, id, attribute rows.
  __shared__ int s_off[kThreads], s_base[kThreads], s_nx[kThreads],
      s_gid[kThreads];
  __shared__ float s_attr[kRows][kThreads];
  __shared__ int s_j0, s_spill;
  const int p0 = blockIdx.x * kThreads;
  const int pos = p0 + threadIdx.x;
  const int tot = min(*total, p_cap);
  const size_t p = (size_t)p_cap;
  if (p0 < tot) {
    if (threadIdx.x < 32) {
      const int j = warp_lower_bound(offsets, 0, n, p0 + 1) - 1;
      if (threadIdx.x == 0) s_j0 = j;
    }
    __syncthreads();
    const int j0 = s_j0;
    const int last = min(p0 + kThreads, tot) - 1;  // the last live slot
    const int jt = j0 + threadIdx.x;
    const int off = jt < n ? offsets[jt] : INT_MAX;
    s_off[threadIdx.x] = off;
    const int nw = __syncthreads_count(jt < n && off <= last);
    if (threadIdx.x < nw) {
      s_base[threadIdx.x] = base[jt];
      s_nx[threadIdx.x] = nx[jt];
      s_gid[threadIdx.x] = gid[jt];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s_attr[r][threadIdx.x] = attrs[(size_t)r * n + jt];
      }
    }
    if (threadIdx.x == 0) {
      const int after = j0 + kThreads;
      s_spill = nw == kThreads && after < n && offsets[after] <= last;
    }
    __syncthreads();
    if (pos < tot) {
      int o, b, w, g;
      float a[kRows];
      if (!s_spill) {
        int lo = 0, hi = nw;  // upper_bound(s_off[0, nw), pos) - 1
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_off[mid] <= pos) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        const int i = lo - 1;
        o = s_off[i];
        b = s_base[i];
        w = s_nx[i];
        g = s_gid[i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = s_attr[r][i];
      } else {
        const int j = owner(offsets, n, pos);
        o = offsets[j];
        b = base[j];
        w = nx[j];
        g = gid[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = attrs[(size_t)r * n + j];
      }
      const int rank = pos - o;
      const int q = rank / w;
      const int tile = b + q * grid_x + (rank - q * w);
      const bool hit = cull_keep(a, tile, grid_x);
      tile_out[pos] = hit ? tile : num_tiles;
      gid_out[pos] = g;
#pragma unroll
      for (int r = 0; r < kRows; ++r) attrs_out[r * p + pos] = a[r];
      if (hit) atomicAdd(&hist[tile], 1);
      return;
    }
  }
  if (pos < p_cap) {  // a padding slot
    tile_out[pos] = num_tiles;
    gid_out[pos] = -1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) attrs_out[r * p + pos] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) expand_tiles_kernel(
    const int* __restrict__ offsets, const int* __restrict__ base,
    const int* __restrict__ nx, const int* __restrict__ gid,
    const int* __restrict__ total, int n, int p_cap, int grid_x,
    int num_tiles, int* __restrict__ tile_out, int* __restrict__ gid_out,
    int* __restrict__ hist) {
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  if (pos >= p_cap) return;
  if (pos >= min(*total, p_cap)) {
    tile_out[pos] = num_tiles;
    gid_out[pos] = -1;
    return;
  }
  const int j = owner(offsets, n, pos);
  const int tile = tile_of(offsets, base, nx, j, pos, grid_x);
  tile_out[pos] = tile;
  gid_out[pos] = gid[j];
  atomicAdd(&hist[tile], 1);
}

}  // namespace

extern "C" int expand_pairs_launch(
    const void* offsets, const void* base, const void* nx, const void* gid,
    const void* attrs, const void* total, int n, int p_cap, int grid_x,
    int num_tiles, void* tile_out, void* gid_out, void* attrs_out, void* hist,
    void* stream) {
  if (p_cap > 0) {
    const int blocks = (p_cap + kThreads - 1) / kThreads;
    expand_pairs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)offsets, (const int*)base, (const int*)nx,
        (const int*)gid, (const float*)attrs, (const int*)total, n, p_cap,
        grid_x, num_tiles, (int*)tile_out, (int*)gid_out, (float*)attrs_out,
        (int*)hist);
  }
  return (int)cudaGetLastError();
}

// K7. hist (num_tiles,) must be zero on entry.
extern "C" int expand_tiles_launch(const void* offsets, const void* base,
                                   const void* nx, const void* gid,
                                   const void* total, int n, int p_cap,
                                   int grid_x, int num_tiles, void* tile_out,
                                   void* gid_out, void* hist, void* stream) {
  if (p_cap > 0) {
    const int blocks = (p_cap + kThreads - 1) / kThreads;
    expand_tiles_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)offsets, (const int*)base, (const int*)nx,
        (const int*)gid, (const int*)total, n, p_cap, grid_x, num_tiles,
        (int*)tile_out, (int*)gid_out, (int*)hist);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of K1 (out[0]) and K7 (out[1]), and the threads
// of a block (out[2]), from the CUDA occupancy calculator.
extern "C" int expand_pairs_occupancy(int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], expand_pairs_kernel, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], expand_tiles_kernel, kThreads, 0);
  }
  out[2] = kThreads;
  return (int)err;
}

extern "C" const char* expand_pairs_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
