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
//     offset is <= pos (upper_bound - 1 over the ascending offsets; a run of
//     equal offsets, zero-count rects before the one Gaussian of the run
//     that owns pairs, resolves to that last one);
//   * rank = pos - offset_j, tile = base_j + (rank / nx_j) * grid_x
//     + rank % nx_j, all in integer arithmetic (the rect width is a full
//     int, so rects of 256 tiles or more expand as any other);
//   * K1 only: j's 10 attribute rows (ATTR_* order), copied to the slot,
//     and the cull: keep the pair iff the minimum of j's conic quadratic
//     over the tile's 16x16 pixel box is <= 2 ln(255 op) + 1e-3 (the same
//     closed form and slack as the TPU kernel, in f32);
//   * tile id (num_tiles when culled or for padding slots), Gaussian id,
//     K1's attributes, and a per-tile histogram of kept pairs (int32
//     atomics, which are exact, so the histogram is deterministic).
// Slots pos >= min(total, p_cap) get tile num_tiles, id -1 and (K1) zero
// rows. The output index is pos, so a stable sort by tile id afterwards
// gives depth order within each tile, exactly the TPU kernel's pair order.
//
// The owner window, shared by both. A block's slots [p0, last] are owned
// by j0, the owner of p0, and then by one Gaussian per distinct offset in
// (p0, last]: at most one owner per slot. The block reads the offsets from
// j0 on, a round of chunks of 256 entries (a thread each) at a time while
// the entry after the round still lies at or below `last`; each thread
// loads its entries' offset, next offset, rect base, width and id at once.
// It keeps each entry that ends a run of equal offsets (its next offset is
// larger) and lies at or below `last`, and compacts those owners by a
// ballot per warp and a prefix over the warps into shared memory (K1 also
// their attribute rows, each row one coalesced read). A slot finds its
// owner by an upper-bound search over that list. When the owners reach
// past the rounds (a run of zero-count rects longer than the window), the
// block searches each slot's owner in device memory, the first design's
// rule. ops/binning.py::owner_window_plain is the plain form of the
// window, ::window_steps of the blocks' slot ranges. The TPU kernels'
// windowed DMA, compare-matrix ranking and one-hot MXU gathers have no
// counterpart.
//
// K1: one thread per slot, 256 slots a block, warp 0 finding j0 by a
// 32-way search (csrc/warp_search.cuh, four rounds for 1M offsets), one
// round of one chunk (its offsets ascend strictly over the live Gaussians,
// zero-count rects sit at the tail). Bound on the H100: bytes. Every slot
// up to p_cap writes 12 words (48 bytes, the padding slots' -1 ids and
// zero rows included) and each Gaussian that owns a slot is read once (14
// words); the cull is ~70 f32 operations per slot, far below the byte
// time. On the full scene (1M Gaussians, 2.6M slots) staging the owners is
// what paid: the search alone, the histogram aggregated per warp
// (__match_any_sync, few tiles repeat within a warp), two slots a thread,
// streaming stores and the cull's per-Gaussian terms staged gained nothing
// measurable. What is left is the 48 bytes written per slot and one
// global atomic per kept pair.
//
// K7: every pair of each rect is kept, and only the tile and the Gaussian
// id are written (8 bytes a slot). Its offsets are those of all N
// Gaussians in depth order, zero-count rects interleaved and offsets
// clamped to p_cap at the tail, so a block's owners are scattered over a
// wider span of entries than it has slots: up to 501 for 1,024 slots on
// the full scene, 1,030 on the smoke's 4096x256 camera (2,000 Gaussians,
// most of them zero-count). Bound: bytes, 8 written per slot up to p_cap
// (the padding slots included) and the 16 bytes of each Gaussian read
// once, 0.015 ms on the full scene; the histogram's atomics and the
// integer search are not counted. The first design (one thread a slot,
// each searching its owner over the 1M offsets, 20 dependent loads, and
// one global atomic a slot) took 0.075-0.079 ms on the card; its largest
// cost was the 2.55M global atomics on the 6,700 bins (27 KB of lines).
// Now:
//   * persistent blocks, as many as the card holds (616 on an H100 at the
//     full scene's shape): each takes an even share of the live slots in
//     steps of 1,024, four slots a thread, then its share of the padding
//     slots; 16-byte stores;
//   * the window: rounds of two chunks (512 entries), up to four rounds
//     (2,048 entries, which the wide camera's 1,030 need); a step's first
//     owner is the owner of the slot after the step before it, which the
//     staging saw, and its first round is loaded before the step before
//     it writes its slots (a block's first step, or one whose first owner
//     lay past the rounds before it: one warp search);
//   * a thread searches the owner of its first slot and walks on to its
//     other three with one division: the next slot of the same owner is
//     the next tile of its rect, a new owner starts at its first;
//   * the histogram of a block's slots in shared memory (up to 10,240
//     tiles; beyond, one global atomic a slot), summed at the end over a
//     cluster of 4 blocks through distributed shared memory, 16 bytes a
//     load, and added to the global histogram by the cluster, each block
//     a quarter of the bins;
//   * no memset before the launch: the launch is cooperative (every block
//     resident at once), block 0 zeroes the histogram and publishes the
//     launch's id beside it, and the blocks wait for that id before their
//     first global atomic.
// Tried on the card and not kept: a per-block flush of the shared
// histogram (no cluster; each of the 27 KB's lines then takes an atomic
// from each of the ~616 blocks), clusters of 2 and 8 (8 leaves SMs
// without a block), 16 or 64 copies of the global histogram (the
// atomics' count, not their contention, is what costs), __match_any_sync
// aggregation, the histogram packed in 16-bit halves (more blocks per SM,
// slower), 4, 3 or 2 blocks per SM instead of 5, a block-wide 256-way
// first search, a second L2 prefetch two steps ahead, one chunk a round,
// eight slots a thread, the padding written interleaved with the steps or
// while warp 0 searches. What is left (~0.032 ms through the wrapper, all
// of it on the card): the writes (33.6 MB), the staging's dependent loads
// and barriers, and the histogram's sum.
//
// Built with -fmad=false: the cull must round exactly as the plain PyTorch
// version (and the TPU reference) do, and a contracted multiply-add would
// round once where they round twice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "warp_search.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 16;
constexpr int kRows = 10;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K7: slots a thread and a step of a block, the window's entries a thread
// per round and its rounds (up to 2,048 entries), and the most tiles whose
// histogram a block keeps in shared memory.
constexpr int kTileSlots = 4;
constexpr int kTileStep = kThreads * kTileSlots;
constexpr int kTilePer = 2;
constexpr int kTileRounds = 4;
constexpr int kMaxSharedTiles = 10240;
// K7's blocks per cluster: they sum their shared histograms through
// distributed shared memory before adding them to the global one, each
// block at most kMaxSliceQuads quads of four tiles a thread.
constexpr int kTileCluster = 4;
constexpr int kMaxSliceQuads =
    (kMaxSharedTiles / 4 + kTileCluster * kThreads - 1) /
    (kTileCluster * kThreads);

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float q_at(float ca, float cb, float cc, float dx,
                                      float dy) {
  return ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy;
}

// upper_bound(a[0, count), x) - 1: the last entry <= x of ascending a. Over
// the offsets, the owner of slot x (for x below the total it owns a pair).
__device__ __forceinline__ int last_at_most(const int* __restrict__ a,
                                            int count, int x) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// The owners of a block's slots in shared memory: offset, rect base, rect
// width, id and, for K1, the attribute rows; the index of the first owner
// (j0) and, by the parity of the step (a step's is reset while the last
// step's is still read), that of the owner of the slot after the last
// (jn).
template <int kSlots, int kPer, bool kAttrs>
struct Owners {
  int off[kSlots], base[kSlots], nx[kSlots], gid[kSlots];
  float attr[kAttrs ? kRows : 1][kAttrs ? kSlots : 1];
  int j0, jn[2];
  int warp_owners[kPer][kWarps];
};

// One round of a window: kPer chunks of kThreads entries; per thread its
// entries' index, offset, next offset, rect base, width and id.
template <int kPer>
struct Round {
  int idx[kPer], o[kPer], next[kPer], b[kPer], w[kPer], g[kPer];
};

template <int kPer>
__device__ __forceinline__ void load_round(Round<kPer>& r,
                                           const int* __restrict__ offsets,
                                           const int* __restrict__ base,
                                           const int* __restrict__ nx,
                                           const int* __restrict__ gid, int n,
                                           int first) {
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = first + e * kThreads + threadIdx.x;
    r.idx[e] = i;
    r.o[e] = i < n ? offsets[i] : INT_MAX;
    r.next[e] = i + 1 < n ? offsets[i + 1] : INT_MAX;
    r.b[e] = i < n ? base[i] : 0;
    r.w[e] = i < n ? nx[i] : 0;
    r.g[e] = i < n ? gid[i] : 0;
  }
}

// Stage the owners of the slots [p0, last] (last below the total) whose
// first owner is j0, as the header describes: rounds of kPer chunks of
// kThreads entries, the first one loaded by the caller into `r` (from j0),
// K1's attribute rows read once an entry is known to own a slot. The owner
// of slot last + 1 goes to s.jn[parity] if a round read it (else -1).
// Returns the owners' count, or -1 when they reach past kRounds rounds
// (the block then searches in device memory). Every thread of the block
// calls it; it ends on a barrier.
template <int kSlots, int kPer, int kRounds, bool kAttrs>
__device__ int stage_owners(Owners<kSlots, kPer, kAttrs>& s, Round<kPer>& r,
                            const int* __restrict__ offsets,
                            const int* __restrict__ base,
                            const int* __restrict__ nx,
                            const int* __restrict__ gid,
                            const float* __restrict__ attrs, int n, int j0,
                            int last, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s.jn[parity] = -1;
  int count = 0;
  for (int round = 0; round < kRounds; ++round) {
    if (round > 0) {
      load_round(r, offsets, base, nx, gid, n, j0 + round * kPer * kThreads);
    }
    unsigned ballot[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      // It ends a run of equal offsets at or below `last`: an owner.
      ballot[e] =
          __ballot_sync(0xffffffffu, r.o[e] <= last && r.next[e] > r.o[e]);
      if (lane == 0) s.warp_owners[e][warp] = __popc(ballot[e]);
    }
    // Whether the owners go on past this round.
    const int more = __syncthreads_or(threadIdx.x == kThreads - 1 &&
                                      r.next[kPer - 1] <= last);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int k = count + __popc(ballot[e] & ((1u << lane) - 1u));
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int m = s.warp_owners[e][v];
        k += v < warp ? m : 0;
        count += m;
      }
      // At most kSlots owners on ascending offsets; the guard keeps other
      // input inside the arrays, and such a block searches device memory.
      if ((ballot[e] >> lane & 1u) && k < kSlots) {
        s.off[k] = r.o[e];
        s.base[k] = r.b[e];
        s.nx[k] = r.w[e];
        s.gid[k] = r.g[e];
        if constexpr (kAttrs) {
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            s.attr[q][k] = attrs[(size_t)q * n + r.idx[e]];
          }
        }
      }
      if (r.o[e] <= last + 1 && r.next[e] > last + 1) {
        s.jn[parity] = r.idx[e];
      }
    }
    __syncthreads();
    if (!more) return count <= kSlots ? count : -1;
  }
  return -1;
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
  __shared__ Owners<kThreads, 1, true> s;
  const int p0 = blockIdx.x * kThreads;
  const int pos = p0 + threadIdx.x;
  const int tot = min(*total, p_cap);
  const size_t p = (size_t)p_cap;
  if (p0 < tot) {
    if (threadIdx.x < 32) {
      const int j = warp_lower_bound(offsets, 0, n, p0 + 1) - 1;
      if (threadIdx.x == 0) s.j0 = j;
    }
    __syncthreads();
    const int last = min(p0 + kThreads, tot) - 1;  // the last live slot
    Round<1> r;
    load_round(r, offsets, base, nx, gid, n, s.j0);
    const int count = stage_owners<kThreads, 1, 1, true>(
        s, r, offsets, base, nx, gid, attrs, n, s.j0, last, 0);
    if (pos < tot) {
      int o, b, w, g;
      float a[kRows];
      if (count >= 0) {
        const int i = last_at_most(s.off, count, pos);
        o = s.off[i];
        b = s.base[i];
        w = s.nx[i];
        g = s.gid[i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = s.attr[r][i];
      } else {
        const int j = last_at_most(offsets, n, pos);
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

// Write a thread's kTileSlots slots' tiles and ids from pos0 on: 16-byte
// stores (pos0 % 4 == 0), or one word a slot at the ragged end of p_cap.
__device__ __forceinline__ void store_quad(int* __restrict__ tile_out,
                                           int* __restrict__ gid_out,
                                           int pos0, int p_cap, const int* tv,
                                           const int* gv) {
  if (p_cap - pos0 >= kTileSlots) {
#pragma unroll
    for (int k = 0; k < kTileSlots; k += 4) {
      *reinterpret_cast<int4*>(tile_out + pos0 + k) =
          make_int4(tv[k], tv[k + 1], tv[k + 2], tv[k + 3]);
      *reinterpret_cast<int4*>(gid_out + pos0 + k) =
          make_int4(gv[k], gv[k + 1], gv[k + 2], gv[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kTileSlots; ++k) {
      if (pos0 + k < p_cap) {
        tile_out[pos0 + k] = tv[k];
        gid_out[pos0 + k] = gv[k];
      }
    }
  }
}

// The padding quads [u0, u1) (slots past the total), a thread a quad.
__device__ __forceinline__ void pad_quads(int* __restrict__ tile_out,
                                          int* __restrict__ gid_out,
                                          int p_cap, int num_tiles,
                                          long long u0, long long u1) {
  int tv[kTileSlots], gv[kTileSlots];
#pragma unroll
  for (int k = 0; k < kTileSlots; ++k) {
    tv[k] = num_tiles;
    gv[k] = -1;
  }
  for (long long u = u0 + threadIdx.x; u < u1; u += kThreads) {
    store_quad(tile_out, gid_out, (int)u * kTileSlots, p_cap, tv, gv);
  }
}

// Tile and id of the four slots pos0.. of one thread (padding past tot),
// each slot's tile counted in h (shared or global). From the staged owners
// one division per thread: the next slot of the same owner is the next
// tile of its rect row, and a new owner starts at its first tile.
__device__ __forceinline__ void tile_quad(
    const Owners<kTileStep, kTilePer, false>& s, int count,
    const int* __restrict__ offsets, const int* __restrict__ base,
    const int* __restrict__ nx, const int* __restrict__ gid, int n, int pos0,
    int tot, int p_cap, int grid_x, int num_tiles, int* __restrict__ tile_out,
    int* __restrict__ gid_out, int* h) {
  int tv[kTileSlots], gv[kTileSlots];
  int i = 0, b = 0, w = 1, g = -1, q = 0, r = -1;
  if (count > 0 && pos0 < tot) {
    i = last_at_most(s.off, count, pos0);
    b = s.base[i];
    w = s.nx[i];
    g = s.gid[i];
    const int rank = pos0 - s.off[i];
    q = rank / w;
    r = rank - q * w - 1;  // the slot before pos0
  }
#pragma unroll
  for (int k = 0; k < kTileSlots; ++k) {
    const int pos = pos0 + k;
    tv[k] = num_tiles;
    gv[k] = -1;
    if (pos < tot) {
      if (count >= 0) {
        if (k > 0 && i + 1 < count && s.off[i + 1] <= pos) {
          ++i;  // owners own at least one slot: pos is its first
          b = s.base[i];
          w = s.nx[i];
          g = s.gid[i];
          q = 0;
          r = 0;
        } else if (++r == w) {
          r = 0;
          ++q;
        }
      } else {
        const int j = last_at_most(offsets, n, pos);
        const int rank = pos - offsets[j];
        b = base[j];
        w = nx[j];
        g = gid[j];
        q = rank / w;
        r = rank - q * w;
      }
      tv[k] = b + q * grid_x + r;
      gv[k] = g;
      atomicAdd(&h[tv[k]], 1);
    }
  }
  store_quad(tile_out, gid_out, pos0, p_cap, tv, gv);
}

// hist needs no zeroing before K7: block 0 zeroes it, then publishes the
// launch's id in the two words after it (`ready`); every block waits for
// that id before its first atomic on hist. The launch is cooperative, so
// all blocks are resident at once and block 0 runs while the others wait;
// the id is new for every launch, so what the words held before (an
// earlier launch's id) never releases a block early.
__device__ __forceinline__ unsigned long long* hist_flag(int* hist,
                                                         int num_tiles) {
  return reinterpret_cast<unsigned long long*>(hist + ((num_tiles + 1) & ~1));
}

__device__ void clear_hist(int* hist, int num_tiles,
                           unsigned long long* ready,
                           unsigned long long launch) {
  for (int t = threadIdx.x; t < num_tiles / 4; t += kThreads) {
    reinterpret_cast<int4*>(hist)[t] = make_int4(0, 0, 0, 0);
  }
  for (int t = num_tiles / 4 * 4 + threadIdx.x; t < num_tiles; t += kThreads) {
    hist[t] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(ready, launch);
  }
}

// Every thread of the block calls it; traps after ~1 s without the id.
__device__ void wait_hist(unsigned long long* ready,
                          unsigned long long launch) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (*reinterpret_cast<volatile unsigned long long*>(ready) != launch) {
      if (clock64() - t0 > (1LL << 31)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// K7, persistent: block b takes an even share of the slots below the
// total (whole quads of four, in order) in steps of kTileStep, then an even
// share of the padding quads. The first owner of a step after the first is
// the owner of the slot after the previous step, which its staging saw
// (else one warp search), and that step's first round is loaded before
// the previous step's slots are written. kShared: the
// histogram of its slots in shared memory (num_tiles ints, dynamic); at
// the end the kTileCluster blocks of a cluster sum theirs through
// distributed shared memory, each block a slice of the tiles, and add the
// non-zero bins to hist: a cluster's atomics, not a block's, per bin.
template <bool kShared>
__global__ void __launch_bounds__(kThreads) expand_tiles_kernel(
    const int* __restrict__ offsets, const int* __restrict__ base,
    const int* __restrict__ nx, const int* __restrict__ gid,
    const int* __restrict__ total, int n, int p_cap, int grid_x,
    int num_tiles, int* __restrict__ tile_out, int* __restrict__ gid_out,
    int* __restrict__ hist, unsigned long long launch) {
  __shared__ Owners<kTileStep, kTilePer, false> s;
  extern __shared__ int4 s_hist4[];  // the histogram in whole quads
  int* s_hist = reinterpret_cast<int*>(s_hist4);
  int* h = kShared ? s_hist : hist;
  const int hist_quads = (num_tiles + 3) / 4;
  if (kShared) {
    for (int t = threadIdx.x; t < hist_quads; t += kThreads) {
      s_hist4[t] = make_int4(0, 0, 0, 0);
    }
  }
  unsigned long long* ready = hist_flag(hist, num_tiles);
  if (blockIdx.x == 0) clear_hist(hist, num_tiles, ready, launch);
  if (!kShared) wait_hist(ready, launch);
  const int tot = min(*total, p_cap);
  const long long b = blockIdx.x, g = gridDim.x;
  const long long quads = (tot + kTileSlots - 1) / kTileSlots;
  const long long pads = (p_cap + kTileSlots - 1) / kTileSlots - quads;
  const int end = (int)(quads * (b + 1) / g) * kTileSlots;
  const int pos = kTileSlots * threadIdx.x;  // within a step
  Round<kTilePer> r;
  int j0 = -1;  // the step's first owner, when the last step's staging saw it
  int parity = 0;
  for (int p0 = (int)(quads * b / g) * kTileSlots; p0 < end;
       p0 += kTileStep, parity ^= 1) {
    if (j0 < 0) {  // uniform: the block's first step, or the last step's
                   // rounds did not reach this one's first owner
      if (threadIdx.x < 32) {
        const int j = warp_lower_bound(offsets, 0, n, p0 + 1) - 1;
        if (threadIdx.x == 0) s.j0 = j;
      }
      __syncthreads();
      j0 = s.j0;
      load_round(r, offsets, base, nx, gid, n, j0);
    }
    const int step_end = min(p0 + kTileStep, end);
    const int count = stage_owners<kTileStep, kTilePer, kTileRounds, false>(
        s, r, offsets, base, nx, gid, nullptr, n, j0, min(step_end, tot) - 1,
        parity);
    j0 = count > 0 && step_end < end ? s.jn[parity] : -1;
    if (j0 >= 0) load_round(r, offsets, base, nx, gid, n, j0);
    if (p0 + pos < step_end) {
      tile_quad(s, count, offsets, base, nx, gid, n, p0 + pos, tot, p_cap,
                grid_x, num_tiles, tile_out, gid_out, h);
    }
  }
  pad_quads(tile_out, gid_out, p_cap, num_tiles, quads + pads * b / g,
            quads + pads * (b + 1) / g);
  if constexpr (kShared) {
    // The block's slice of the quads: the cluster's sum of each, read as
    // 16 bytes from every block of the cluster (all loads of a thread at
    // once), kept in this block's own histogram, then added to hist.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block of the cluster has counted its slots
    const int per = (hist_quads + kTileCluster - 1) / kTileCluster;
    const int lo = (int)cluster.block_rank() * per;
    const int hi = min(lo + per, hist_quads);
    int4 sum[kMaxSliceQuads];
#pragma unroll
    for (int k = 0; k < kMaxSliceQuads; ++k) {
      const int t = lo + k * kThreads + threadIdx.x;
      sum[k] = make_int4(0, 0, 0, 0);
      if (t < hi) {
#pragma unroll
        for (int q = 0; q < kTileCluster; ++q) {
          const int4 v = cluster.map_shared_rank(s_hist4, q)[t];
          sum[k].x += v.x;
          sum[k].y += v.y;
          sum[k].z += v.z;
          sum[k].w += v.w;
        }
      }
    }
    cluster.sync();  // every block has read the others' histograms
#pragma unroll
    for (int k = 0; k < kMaxSliceQuads; ++k) {
      const int t = lo + k * kThreads + threadIdx.x;
      if (t < hi) s_hist4[t] = sum[k];
    }
    wait_hist(ready, launch);
    for (int t = 4 * lo + threadIdx.x; t < min(4 * hi, num_tiles);
         t += kThreads) {
      const int c = s_hist[t];
      if (c) atomicAdd(&hist[t], c);
    }
  }
}

// K7's launch shape for num_tiles: whether its histogram is shared, its
// dynamic shared memory, resident blocks per SM and the grid (as many
// blocks, or clusters for the shared histogram, as the card holds at once,
// at most about one block a step of slots).
struct TilesShape {
  bool shared;
  int smem, blocks_per_sm, grid;
};

// The launch configuration for the shape: cooperative, and clusters of
// kTileCluster blocks for the shared histogram (`attrs` holds two).
cudaLaunchConfig_t tiles_config(const TilesShape& shape, cudaStream_t stream,
                                cudaLaunchAttribute* attrs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shape.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shape.smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  cfg.numAttrs = 1;
  if (shape.shared) {
    attrs[1].id = cudaLaunchAttributeClusterDimension;
    attrs[1].val.clusterDim.x = kTileCluster;
    attrs[1].val.clusterDim.y = 1;
    attrs[1].val.clusterDim.z = 1;
    cfg.numAttrs = 2;
  }
  return cfg;
}

cudaError_t tiles_shape(int p_cap, int num_tiles, TilesShape* shape) {
  shape->shared = num_tiles <= kMaxSharedTiles;
  shape->smem = shape->shared ? (num_tiles + 3) / 4 * (int)sizeof(int4) : 0;
  const int steps = (p_cap + kTileStep - 1) / kTileStep;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  if (!shape->shared) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &shape->blocks_per_sm, expand_tiles_kernel<false>, kThreads, 0);
    shape->grid = max(min(steps, sms * shape->blocks_per_sm), 1);
    return err;
  }
  err = cudaFuncSetAttribute(expand_tiles_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedTiles * (int)sizeof(int));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &shape->blocks_per_sm, expand_tiles_kernel<true>, kThreads,
        shape->smem);
  }
  int clusters = 0;
  if (err == cudaSuccess) {
    shape->grid = kTileCluster;  // the query's grid
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t cfg = tiles_config(*shape, 0, attrs);
    err = cudaOccupancyMaxActiveClusters(&clusters, expand_tiles_kernel<true>,
                                         &cfg);
  }
  const int want = (steps + kTileCluster - 1) / kTileCluster;
  shape->grid = kTileCluster * max(min(want, clusters), 1);
  return err;
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

// K7. hist: (num_tiles rounded up to even) + 2 int32, 8-byte aligned, of
// any content (its first num_tiles words receive the histogram; the two
// after are the launch's flag); tile_out and gid_out start on 16 bytes.
extern "C" int expand_tiles_launch(const void* offsets, const void* base,
                                   const void* nx, const void* gid,
                                   const void* total, int n, int p_cap,
                                   int grid_x, int num_tiles, void* tile_out,
                                   void* gid_out, void* hist, void* stream) {
  static std::atomic<unsigned long long> next_launch{0x9e3779b97f4a7c15ull};
  TilesShape shape;
  const cudaError_t err = tiles_shape(max(p_cap, 0), num_tiles, &shape);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg =
      tiles_config(shape, (cudaStream_t)stream, attrs);
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg,
      shape.shared ? expand_tiles_kernel<true> : expand_tiles_kernel<false>,
      (const int*)offsets, (const int*)base, (const int*)nx, (const int*)gid,
      (const int*)total, n, max(p_cap, 0), grid_x, num_tiles, (int*)tile_out,
      (int*)gid_out, (int*)hist, next_launch.fetch_add(1));
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// Resident blocks per SM of K1 (out[0]) and of K7 with its histogram in
// device memory (out[1]), and the threads of a block (out[2]), from the
// CUDA occupancy calculator.
extern "C" int expand_pairs_occupancy(int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], expand_pairs_kernel, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], expand_tiles_kernel<false>, kThreads, 0);
  }
  out[2] = kThreads;
  return (int)err;
}

// K7's launch for p_cap slots over num_tiles tiles: resident blocks per SM
// (out[0]), the grid (out[1]), its dynamic shared memory in bytes (out[2])
// and whether the histogram is kept in shared memory (out[3]).
extern "C" int expand_tiles_shape(int p_cap, int num_tiles, int* out) {
  TilesShape shape;
  const cudaError_t err = tiles_shape(max(p_cap, 1), num_tiles, &shape);
  out[0] = shape.blocks_per_sm;
  out[1] = shape.grid;
  out[2] = shape.smem;
  out[3] = shape.shared;
  return (int)err;
}

extern "C" const char* expand_pairs_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
