// K4: per-Gaussian sum of the id-sorted pair gradient rows.
//
// Replaces the TPU kernel priordepth_gaussiansplatting_tpu/ops/binning.py
// ::_segment_reduce_kernel (via segment_reduce), as _bin_sorted_bwd uses it
// after the sort-back.
//
// What it computes: with the pair rows d (10, v) sorted by Gaussian id and
// bounds[g] = the first position whose id is >= g (clipped to num_valid),
//   out[r, g] = sum_{bounds[g] <= k < bounds[g+1]} d[r, k]
// for g < n, in f32. Pairs with an id >= n or a position >= num_valid lie
// past bounds[n] and contribute nothing; a Gaussian with no pairs gets 0.
// The per-pair cotangents are summed at full f32, as the JAX package's
// exact_grads=True does (its default rounds each one to bf16 first).
//
// Bound on the H100: bytes (one add per value read). Design: one warp per
// Gaussian. Its lanes stride the Gaussian's segment, so each row's reads are
// coalesced, and each lane sums its elements in order; the 32 lane sums are
// then combined with __shfl_xor_sync in a fixed order. The result does not
// depend on scheduling (no atomics), and the warp copes with segments from
// one pair to thousands. The TPU kernel's one-hot MXU contraction over
// blocks of 512 Gaussians has no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 10;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) segment_reduce_kernel(
    const float* __restrict__ d, int v, const int* __restrict__ bounds,
    int n, float* __restrict__ out) {
  const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n) return;  // uniform across the warp
  const int s = bounds[g];
  const int e = bounds[g + 1];
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int k = s + lane; k < e; k += 32) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += d[(size_t)r * v + k];
  }
  float mine = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float x = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    if (lane == r) mine = x;
  }
  if (lane < kRows) out[(size_t)lane * n + g] = mine;
}

}  // namespace

extern "C" int segment_reduce_launch(const void* d, int v, const void* bounds,
                                     int n, void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segment_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)d, v, (const int*)bounds, n, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* segment_reduce_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
