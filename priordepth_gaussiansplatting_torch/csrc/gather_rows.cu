// K5: the tile-sorted, zero-padded pair table the compositor reads.
//
// Replaces the TPU kernel priordepth_gaussiansplatting_tpu/ops/binning.py
// ::_pack_rows_kernel_factory, as pack_lanes uses it to build the
// compositor's stream after the tile sort (_bin_sorted_core). On the TPU
// the tile sort carries the attribute rows as payloads and pack_lanes then
// copies the sorted 1-D rows into a zero-padded (rows, L) table. Here the
// sort moves only the tile keys and returns a permutation, so this one
// kernel does both the payload movement and the packing:
//   out[r, i]   = src[r, perm[i]]   for i < v_cap,
//   out[r, i]   = 0                 for v_cap <= i < out_len,
//   gid_out[i]  = gid[perm[i]]      for i < v_cap.
// Given the sort, that is what pack_lanes computes. The window tables
// that pack_lanes also builds for the TPU expansion kernel have no
// counterpart: K1 here reads its inputs without a window.
//
// Bound on the H100: bytes (no arithmetic). Each output column reads one
// 8-byte index and one scattered word per row, and writes one coalesced
// word per row. Design: one thread per output column; the index is read
// once and reused for all rows, the writes of a warp are contiguous, and
// the scattered reads stay within the rows' L2-resident footprint.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float* __restrict__ src, const int* __restrict__ gid,
    const int64_t* __restrict__ perm, int rows, int p, int v_cap, int out_len,
    float* __restrict__ out, int* __restrict__ gid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= out_len) return;
  if (i < v_cap) {
    const int64_t s = perm[i];
    for (int r = 0; r < rows; ++r) {
      out[(size_t)r * out_len + i] = src[(size_t)r * p + s];
    }
    gid_out[i] = gid[s];
  } else {
    for (int r = 0; r < rows; ++r) out[(size_t)r * out_len + i] = 0.0f;
  }
}

}  // namespace

extern "C" int gather_rows_launch(const void* src, const void* gid,
                                  const void* perm, int rows, int p,
                                  int v_cap, int out_len, void* out,
                                  void* gid_out, void* stream) {
  if (out_len > 0) {
    const int blocks = (out_len + kThreads - 1) / kThreads;
    gather_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)src, (const int*)gid, (const int64_t*)perm, rows, p,
        v_cap, out_len, (float*)out, (int*)gid_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gather_rows_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
