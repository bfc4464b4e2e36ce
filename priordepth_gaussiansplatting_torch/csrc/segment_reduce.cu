// K4: per-Gaussian sum of the id-sorted pair gradient rows.
//
// Replaces the TPU kernel priordepth_gaussiansplatting_tpu/ops/binning.py
// ::_segment_reduce_kernel (via segment_reduce), as _bin_sorted_bwd uses it
// after the sort-back.
//
// What it computes: with the pair rows d (10, v) sorted by the ascending
// Gaussian-id key and nv = num_valid,
//   out[r, g] = sum of d[r, k] over k < nv with key[k] == g,   g < n,
// rounded once to f32 from a float64 sum, as the plain version
// (ops/binning.py::segment_reduce_plain) computes it. Pairs with an id >= n
// or a position >= nv contribute nothing; a Gaussian with no pairs gets
// exactly 0. The per-pair cotangents are summed unrounded, as the JAX
// package's exact_grads=True does.
//
// Why float64: the f32 sums of any order are within a few ulps of each
// other, and yet the train CLI's held-out PSNR after 1,000 iterations of
// the 512^2 synthetic scene moves by several dB with the order
// (densification amplifies the last bits). Rounded once from a float64
// sum, K4's result does not depend on how the kernel splits a segment: it
// equals the plain version bit for bit, and a change of blocks, passes or
// lanes moves no result. The price is the double adds and 64-bit
// shuffles, which the kernel's byte traffic does not hide entirely.
//
// Bound on the H100: bytes. The least traffic is 40 bytes per valid pair
// (its ten values), 4 per key and 40 per Gaussian (its ten sums): ~130 MB,
// 0.039 ms, for 1M Gaussians and 2M valid pairs.
//
// Why the first design (one warp per Gaussian, lanes striding the segment)
// missed it by 10x: with ~2 pairs per Gaussian, 30 of a warp's 32 lanes
// idled through the loads, and every warp still ran 10 rows x 5
// __shfl_xor_sync = 50 shuffles, ~50M warp-wide shuffles per call, about
// 0.2 ms by themselves; each warp also stored its 10 sums to 10 rows 4 MB
// apart, and the bounds took three PyTorch launches (arange, searchsorted,
// clamp) before it.
//
// Design: the threads take the pairs, not the Gaussians.
//   * Block b owns the ids [b G, b G + G) (G = ids_per_block, a power of
//     two up to 1,024 that the wrapper picks so that a block spans ~4,096
//     key slots) and so the columns [lower_bound(key, b G),
//     lower_bound(key, b G + G)), both clipped to nv: a segment never
//     crosses a block. Warps 0 and 1 find the two ends in the key itself,
//     each by a 32-way search (csrc/warp_search.cuh: a ballot over 32
//     samples a round, five rounds for 2.6M keys); no bounds array is read.
//   * The block walks its columns in passes of 1,024, four consecutive
//     columns a thread: one 16-byte load for the keys and one per row
//     (scalar loads when the rows do not start on 16 bytes). The rows go
//     in two groups of five, so that a thread holds 64 registers and four
//     blocks (32 warps) fit on an SM. A thread sums each run of equal keys
//     among its columns in column order; runs that cross threads are
//     joined by a segmented scan over the warp's lanes (5 shuffles per row
//     per 128 columns, where the first design spent 50 per Gaussian), the
//     earlier partial added first. Sums are float64 from the first add.
//   * A run that lies inside one warp is complete and goes straight to the
//     block's (10, G) tile in shared memory. A warp's first and last runs
//     may go on in a neighbouring warp or pass: the warps leave them in
//     shared memory and warp 0 joins them in column order, carrying the
//     last one into the next pass: the fixed owner of every segment that
//     crosses a warp or a pass.
//   * The tile starts at zero and is written once at the end, row by row,
//     coalesced along g: every output column is written exactly once,
//     the zeros of Gaussians without pairs included.
// No atomics: the result is the same bit for bit on every launch. The
// block partition has a plain PyTorch form (ops/binning.py::segment_bounds
// with ids_per_block = G) that the CPU tests hold against an enumeration.
// The TPU kernel's one-hot MXU contraction over blocks of 512 Gaussians has
// no counterpart.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "warp_search.cuh"

namespace {

constexpr int kRows = 10;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                   // consecutive columns a thread
constexpr int kPass = kThreads * kCols;    // columns a pass
constexpr int kMaxIds = 1024;              // ids a block at most
constexpr int kGroup = 5;                  // rows loaded and summed at once
constexpr int kMinBlocks = 4;              // resident blocks per SM wanted
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBefore = -1;                // key of a column before the range
constexpr int kAfter = INT_MAX;            // ... and of one past it

// Where a run that ends in a lane goes: one of the warp's first and last
// runs (keys first and last; exactly one lane ends each, one run if the
// keys agree) to the warp's two pieces, any other, complete, to the tile.
struct Ends {
  int first, last, g0, g1, ids_per_block;
  float* tile;
  double (*piece)[kRows];  // the warp's two pieces, kRows rows each

  __device__ __forceinline__ void run(int key, double sum, int r) const {
    if (key == first || key == last) {
      piece[key == last ? 1 : 0][r] = sum;
    } else if (key >= g0 && key < g1) {
      tile[r * ids_per_block + (key - g0)] = (float)sum;
    }
  }
};

// Load rows [r0, r0 + kGroup) of the thread's columns: one 16-byte load a
// row where the rows start on 16 bytes, else one load a column in range.
template <bool kVec>
__device__ __forceinline__ void load_rows(const float* __restrict__ d, int v,
                                          int r0, int col, int c0, int c1,
                                          float (&x)[kGroup][kCols]) {
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const float* row = d + (size_t)(r0 + r) * v;
    if (kVec && col < c1) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(row + col));
      x[r][0] = q.x; x[r][1] = q.y; x[r][2] = q.z; x[r][3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = col + j;
        x[r][j] = c >= c0 && c < c1 ? __ldcs(row + c) : 0.0f;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) segment_reduce_kernel(
    const float* __restrict__ d, const int* __restrict__ key, int v,
    const int* __restrict__ num_valid, int n, int ids_per_block,
    float* __restrict__ out) {
  extern __shared__ float tile[];          // (kRows, ids_per_block)
  __shared__ int range[2];
  __shared__ int piece_key[2][kWarps][2];  // double-buffered by pass
  __shared__ double piece[2][kWarps][2][kRows];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.x * ids_per_block;
  const int g1 = min(g0 + ids_per_block, n);
  const int m = g1 - g0;
  for (int i = threadIdx.x; i < kRows * m; i += kThreads) {
    tile[(i / m) * ids_per_block + i % m] = 0.0f;
  }
  if (warp < 2) {
    const int nv = min(max(*num_valid, 0), v);
    const int c = warp_lower_bound(key, 0, nv, warp == 0 ? g0 : g1);
    if (lane == 0) range[warp] = c;
  }
  __syncthreads();
  const int c0 = range[0];
  const int c1 = range[1];

  // Warp 0's lanes 0..9 carry the open segment (row = lane) across passes.
  int carry_key = kBefore;
  double carry = 0.0;
  int buf = 0;
  for (int base = c0 & ~(kCols - 1); base < c1; base += kPass, buf ^= 1) {
    const int col = base + kCols * threadIdx.x;
    int k[kCols];
    if (kVec && col < c1) {
      const int4 kk = *reinterpret_cast<const int4*>(key + col);
      k[0] = kk.x; k[1] = kk.y; k[2] = kk.z; k[3] = kk.w;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = col + j;
      if (c < c0) {
        k[j] = kBefore;
      } else if (c >= c1) {
        k[j] = kAfter;
      } else if (!kVec) {
        k[j] = key[c];
      }
    }

    // The thread's runs, the same in every row: the head run (holding
    // column 0, ending before column `head_end`, or the whole thread),
    // complete runs inside, the tail run (holding column 3).
    int head_end = kCols;
#pragma unroll
    for (int j = kCols - 1; j > 0; --j) {
      if (k[j] != k[j - 1]) head_end = j;
    }
    const bool whole = head_end == kCols;
    const int hk = k[0], tk = k[kCols - 1];
    const int prev_tk = __shfl_up_sync(kFull, tk, 1);
    const int next_hk = __shfl_down_sync(kFull, hk, 1);
    const int first_key = __shfl_sync(kFull, hk, 0);
    const int last_key = __shfl_sync(kFull, tk, 31);
    const bool head_ends = !whole;
    const bool head_joins = lane > 0 && prev_tk == hk;
    const bool tail_ends = lane == 31 || next_hk != tk;
    // The segmented scan's flags (does the tail run start at or after
    // this lane's range at step o?), the same in every row.
    bool flag = lane == 0 || !whole || prev_tk != tk;
    bool flags[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      flags[i] = flag;
      const bool f_up = __shfl_up_sync(kFull, flag, 1 << i);
      if (lane >= (1 << i)) flag = flag || f_up;
    }
    if (lane == 0) {
      piece_key[buf][warp][0] = first_key;
      piece_key[buf][warp][1] = last_key;
    }

    const Ends ends{first_key, last_key, g0, g1, ids_per_block, tile,
                    piece[buf][warp]};
#pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += kGroup) {
      float x[kGroup][kCols];
      load_rows<kVec>(d, v, r0, col, c0, c1, x);
      double head[kGroup], scan[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) scan[r] = x[r][0];
#pragma unroll
      for (int j = 1; j < kCols; ++j) {
        if (k[j] != k[j - 1]) {
          if (j == head_end) {
#pragma unroll
            for (int r = 0; r < kGroup; ++r) head[r] = scan[r];
          } else if (k[j - 1] >= g0 && k[j - 1] < g1) {
#pragma unroll
            for (int r = 0; r < kGroup; ++r) {
              tile[(r0 + r) * ids_per_block + (k[j - 1] - g0)] =
                  (float)scan[r];
            }
          }
#pragma unroll
          for (int r = 0; r < kGroup; ++r) scan[r] = x[r][j];
        } else {
#pragma unroll
          for (int r = 0; r < kGroup; ++r) scan[r] += x[r][j];
        }
      }
      // Segmented inclusive scan of the tail runs over the lanes: scan[r]
      // becomes the sum of the tail run's columns in this warp up to this
      // lane, the earlier partial added first.
#pragma unroll
      for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const double s_up = __shfl_up_sync(kFull, scan[r], 1 << i);
          if (lane >= (1 << i) && !flags[i]) scan[r] = s_up + scan[r];
        }
      }
      // Runs that end in this lane: the head run (if it is not the whole
      // thread; joined to the previous lane's scan if it began there) and
      // the tail run (if the next lane starts another key).
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const double prev = __shfl_up_sync(kFull, scan[r], 1);
        if (head_ends) {
          ends.run(hk, head_joins ? prev + head[r] : head[r], r0 + r);
        }
        if (tail_ends) ends.run(tk, scan[r], r0 + r);
      }
    }
    __syncthreads();

    // Warp 0 joins the warps' first and last runs in column order.
    if (warp == 0 && lane < kRows) {
      for (int w = 0; w < kWarps; ++w) {
        const bool one = piece_key[buf][w][0] == piece_key[buf][w][1];
        for (int p = one ? 1 : 0; p < 2; ++p) {
          const int pk = piece_key[buf][w][p];
          const double pv = piece[buf][w][p][lane];
          if (pk == carry_key) {
            carry = carry + pv;
          } else {
            if (carry_key >= g0 && carry_key < g1) {
              tile[lane * ids_per_block + (carry_key - g0)] = (float)carry;
            }
            carry_key = pk;
            carry = pv;
          }
        }
      }
    }
  }
  if (warp == 0 && lane < kRows && carry_key >= g0 && carry_key < g1) {
    tile[lane * ids_per_block + (carry_key - g0)] = (float)carry;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * m; i += kThreads) {
    const int r = i / m, g = i - r * m;
    out[(size_t)r * n + g0 + g] = tile[r * ids_per_block + g];
  }
}

size_t tile_bytes(int ids_per_block) {
  return (size_t)kRows * ids_per_block * sizeof(float);
}

}  // namespace

// ids_per_block in [1, 1024]; with vec the rows of d and the key start on
// 16 bytes (v % 4 == 0 and aligned pointers).
extern "C" int segment_reduce_launch(const void* d, const void* key, int v,
                                     const void* num_valid, int n,
                                     int ids_per_block, int vec,
                                     void* out, void* stream) {
  if (ids_per_block < 1 || ids_per_block > kMaxIds) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int blocks = (n + ids_per_block - 1) / ids_per_block;
    const size_t smem = tile_bytes(ids_per_block);
    cudaStream_t s = (cudaStream_t)stream;
    if (vec) {
      segment_reduce_kernel<true><<<blocks, kThreads, smem, s>>>(
          (const float*)d, (const int*)key, v, (const int*)num_valid, n,
          ids_per_block, (float*)out);
    } else {
      segment_reduce_kernel<false><<<blocks, kThreads, smem, s>>>(
          (const float*)d, (const int*)key, v, (const int*)num_valid, n,
          ids_per_block, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the 16-byte form (out[0]) and the scalar form
// (out[1]) at ids_per_block, and the threads of a block (out[2]), from the
// CUDA occupancy calculator.
extern "C" int segment_reduce_occupancy(int ids_per_block, int* out) {
  const size_t smem = tile_bytes(ids_per_block);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], segment_reduce_kernel<true>, kThreads, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], segment_reduce_kernel<false>, kThreads, smem);
  }
  out[2] = kThreads;
  return (int)err;
}

extern "C" const char* segment_reduce_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
