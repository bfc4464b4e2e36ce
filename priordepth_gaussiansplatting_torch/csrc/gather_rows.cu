// K5a and K5b: the pair table's attribute rows gathered through a sort's
// permutation, row after row.
//
// Replaces two TPU kernels of priordepth_gaussiansplatting_tpu/ops/binning.py:
//   K5a  _pack_rows_kernel_factory (:1003), as pack_lanes builds the
//        compositor's zero-padded (rows, L) stream after the tile sort
//        (_bin_sorted_core). On the TPU the tile sort carries the
//        attribute rows as payloads and pack_lanes copies the sorted rows
//        into the table; here the sort moves only the tile keys, so this
//        kernel moves the payload and packs it:
//          out[r, i]  = src[r, perm[i]]   for i < v_cap,
//          out[r, i]  = 0                 for v_cap <= i < out_len,
//          gid_out[i] = gid[perm[i]]      for i < v_cap.
//        The window tables pack_lanes also builds for the TPU expansion
//        kernel have no counterpart: K1 reads its inputs without a window.
//   K5b  _unpack_rows_kernel_factory (:1051), as unpack_lanes hands the
//        backward's gradient table to the id sort, which carries the rows
//        as payloads. Here the id sort returns a permutation and this
//        kernel applies it to the gradient table, without an id row (the
//        sort's values are the sorted key):
//          out[r, i]  = d_table[r, perm[i]]   for i < v = v_cap = out_len.
//
// Bound on the H100: bytes, no arithmetic. Per column: one 8-byte index,
// one scattered 4-byte word per row (and per id) read, one word per row
// (and per id) written: 96 bytes for K5a, 88 for K5b.
//
// Why the order of the work matters. A scattered 4-byte read costs a
// 32-byte sector, so the sectors of the rows being gathered have to stay
// in the 50 MB L2 while their other words are read. At the full scene (1M
// Gaussians at 1600x1066: p_cap ~ 2.6M pair slots, v ~ 2.2M columns) a
// source row is ~9-10 MB (K5a: 4 B x p_cap; K5b: 4 B x (v + 1024)) and the
// index 8 B x v ~ 18 MB. All ten rows (~100 MB) do not fit: a walk that
// gathers every row of a column at once, as this kernel's first form did,
// fetches most sectors from device memory, ~10 x 32 B per column.
//
// Design: the grid is (column chunks, row passes). A pass gathers
// rows_per_pass rows (2 on the path, set by ops/binning.py; the ids of K5a
// are one more row, in the last pass), so the grid reads from two source
// rows at a time (~20 MB), four where one pass ends and the next begins,
// plus the index. This relies on the hardware dispatching blocks in the
// order of their linear index (blockIdx.x fastest), as the H100 does:
// every block of a pass starts before any block of the next. The order
// shapes only the speed; no block's result depends on it. Each thread
// takes 4 consecutive columns: two 16-byte loads of four int64 indices
// (16 bytes is Hopper's widest load per thread) and one 16-byte store per
// row, streamed (evict-first) so that the output does not push the source
// rows out of L2. The index is read once per pass. Chunks past v_cap
// write K5a's zero columns; a chunk that v_cap or out_len cuts, and the
// stores of a row that does not start on 16 bytes, go word by word.
//
// What limits it then (chip_smoke.py, phases full and train): with the
// source in L2 the kernel still issues one 32-byte sector request per
// scattered word, ten per column, and L2 serves them at a fixed rate: a
// source small enough to stay in L2 runs no closer to the byte bound, and
// index_select, which walks its output row by row too, meets the same
// limit. Fewer requests need another layout of the rows (columns of 10
// adjacent words), which is K1's and K3's output contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // consecutive columns per thread

__device__ __forceinline__ void store4(int* to, int col, int4 w,
                                       bool aligned) {
  if (aligned) {
    __stcs(reinterpret_cast<int4*>(to + col), w);
  } else {
    __stcs(to + col, w.x);
    __stcs(to + col + 1, w.y);
    __stcs(to + col + 2, w.z);
    __stcs(to + col + 3, w.w);
  }
}

// Rows r < rows are the table's (src -> out, out_len columns); row `rows`,
// where gid is given, is the ids' (gid -> gid_out, v_cap columns). Words
// are copied as 32-bit patterns.
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const int* __restrict__ src, const int* __restrict__ gid,
    const int64_t* __restrict__ perm, int rows, int p, int v_cap,
    int out_len, int rows_per_pass, int* __restrict__ out,
    int* __restrict__ gid_out) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= out_len) return;
  const int n_rows = rows + (gid != nullptr);
  const int r0 = blockIdx.y * rows_per_pass;
  const int r1 = min(r0 + rows_per_pass, n_rows);
  if (col + kCols <= v_cap) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(perm + col));
    const longlong2 b =
        __ldg(reinterpret_cast<const longlong2*>(perm + col + 2));
    for (int r = r0; r < r1; ++r) {
      const bool table = r < rows;
      const int* from = table ? src + (size_t)r * p : gid;
      int* to = table ? out + (size_t)r * out_len : gid_out;
      const int4 w = make_int4(__ldg(from + a.x), __ldg(from + a.y),
                               __ldg(from + b.x), __ldg(from + b.y));
      store4(to, col, w, !table || ((size_t)r * out_len) % kCols == 0);
    }
  } else if (col >= v_cap && col + kCols <= out_len) {
    for (int r = r0; r < min(r1, rows); ++r) {
      store4(out + (size_t)r * out_len, col, make_int4(0, 0, 0, 0),
             ((size_t)r * out_len) % kCols == 0);
    }
  } else {
    for (int i = col; i < min(col + kCols, out_len); ++i) {
      const int64_t s = i < v_cap ? perm[i] : -1;
      for (int r = r0; r < r1; ++r) {
        if (r < rows) {
          out[(size_t)r * out_len + i] = s >= 0 ? src[(size_t)r * p + s] : 0;
        } else if (s >= 0) {
          gid_out[i] = gid[s];
        }
      }
    }
  }
}

}  // namespace

// gid and gid_out may be null (K5b: no id row). perm must lie on 16 bytes.
extern "C" int gather_rows_launch(const void* src, const void* gid,
                                  const void* perm, int rows, int p,
                                  int v_cap, int out_len, int rows_per_pass,
                                  void* out, void* gid_out, void* stream) {
  const int n_rows = rows + (gid != nullptr);
  if (out_len > 0 && n_rows > 0 && rows_per_pass > 0) {
    const int cols_per_block = kThreads * kCols;
    const dim3 grid((out_len + cols_per_block - 1) / cols_per_block,
                    (n_rows + rows_per_pass - 1) / rows_per_pass);
    gather_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)src, (const int*)gid, (const int64_t*)perm, rows, p,
        v_cap, out_len, rows_per_pass, (int*)out, (int*)gid_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gather_rows_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
