// pdgs_io — native host-side IO runtime of the PyTorch port (a copy of the
// repo's native/pdgs_io.cpp, built and loaded by
// priordepth_gaussiansplatting_torch/data/native.py).
//
// The remaining host-side costs at scene scale (thousands of images,
// multi-million-point COLMAP models, hundreds of MB of PLY snapshots) are
// parsing and byte shuffling; this library does them in C++ behind a C ABI
// consumed through ctypes:
//
//   * COLMAP binary model parsing (images/points3D.bin) into flat arrays in
//     one pass (no per-record Python struct.unpack);
//   * the Gaussian-model PLY writer (the SIBR interchange format,
//     byte-identical to data/ply.py's);
//   * a pthread pool for parallel whole-file reads (image prefetching).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread, at first use, into
// build/native/ (data/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- helpers
bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize((size_t)n);
  size_t got = fread(out.data(), 1, (size_t)n, f);
  fclose(f);
  return got == (size_t)n;
}

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  template <typename T> T get() {
    if (p + sizeof(T) > end) { ok = false; return T(); }
    T v;
    memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
  void skip(size_t n) {
    if (p + n > end) { ok = false; return; }
    p += n;
  }
};

}  // namespace

extern "C" {

// ------------------------------------------------------- COLMAP points3D
// Pass 1 returns counts; pass 2 fills caller-allocated buffers.
// Layout: ids u64[n], xyz f64[n*3], rgb u8[n*3], error f64[n],
//         track_offsets u64[n+1], track pairs i32[2*total_track].
int64_t colmap_points3d_count(const char* path, int64_t* total_track) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  uint64_t n = c.get<uint64_t>();
  uint64_t tracks = 0;
  for (uint64_t i = 0; i < n && c.ok; i++) {
    c.skip(8 + 24 + 3 + 8);
    uint64_t t = c.get<uint64_t>();
    tracks += t;
    c.skip(t * 8);
  }
  if (!c.ok) return -1;
  *total_track = (int64_t)tracks;
  return (int64_t)n;
}

int colmap_points3d_read(const char* path, uint64_t* ids, double* xyz,
                         uint8_t* rgb, double* error,
                         uint64_t* track_offsets, int32_t* track_pairs) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  uint64_t n = c.get<uint64_t>();
  uint64_t toff = 0;
  for (uint64_t i = 0; i < n && c.ok; i++) {
    ids[i] = c.get<uint64_t>();
    for (int k = 0; k < 3; k++) xyz[3 * i + k] = c.get<double>();
    for (int k = 0; k < 3; k++) rgb[3 * i + k] = c.get<uint8_t>();
    error[i] = c.get<double>();
    uint64_t t = c.get<uint64_t>();
    track_offsets[i] = toff;
    for (uint64_t j = 0; j < t; j++) {
      track_pairs[2 * (toff + j)] = c.get<int32_t>();
      track_pairs[2 * (toff + j) + 1] = c.get<int32_t>();
    }
    toff += t;
  }
  track_offsets[n] = toff;
  return c.ok ? 0 : 1;
}

// --------------------------------------------------------- COLMAP images
// Counts pass: number of images, total 2D points, total name bytes.
int64_t colmap_images_count(const char* path, int64_t* total_p2d,
                            int64_t* total_name_bytes) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  uint64_t n = c.get<uint64_t>();
  uint64_t p2d = 0, nb = 0;
  for (uint64_t i = 0; i < n && c.ok; i++) {
    c.skip(4 + 32 + 24 + 4);
    while (c.ok) {
      uint8_t ch = c.get<uint8_t>();
      nb++;
      if (ch == 0) break;
    }
    uint64_t m = c.get<uint64_t>();
    p2d += m;
    c.skip(m * 24);
  }
  if (!c.ok) return -1;
  *total_p2d = (int64_t)p2d;
  *total_name_bytes = (int64_t)nb;
  return (int64_t)n;
}

// Fills: ids i32[n], qvec f64[4n], tvec f64[3n], cam_ids i32[n],
// names (nul-separated bytes), p2d_offsets u64[n+1], xys f64[2*total],
// p3d_ids i64[total].
int colmap_images_read(const char* path, int32_t* ids, double* qvec,
                       double* tvec, int32_t* cam_ids, char* names,
                       uint64_t* p2d_offsets, double* xys,
                       int64_t* p3d_ids) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 1;
  Cursor c{buf.data(), buf.data() + buf.size()};
  uint64_t n = c.get<uint64_t>();
  uint64_t off = 0;
  char* np = names;
  for (uint64_t i = 0; i < n && c.ok; i++) {
    ids[i] = c.get<int32_t>();
    for (int k = 0; k < 4; k++) qvec[4 * i + k] = c.get<double>();
    for (int k = 0; k < 3; k++) tvec[3 * i + k] = c.get<double>();
    cam_ids[i] = c.get<int32_t>();
    while (c.ok) {
      uint8_t ch = c.get<uint8_t>();
      *np++ = (char)ch;
      if (ch == 0) break;
    }
    uint64_t m = c.get<uint64_t>();
    p2d_offsets[i] = off;
    for (uint64_t j = 0; j < m; j++) {
      xys[2 * (off + j)] = c.get<double>();
      xys[2 * (off + j) + 1] = c.get<double>();
      p3d_ids[off + j] = c.get<int64_t>();
    }
    off += m;
  }
  p2d_offsets[n] = off;
  return c.ok ? 0 : 1;
}

// ------------------------------------------------------------ PLY writer
// Writes the Gaussian-model PLY (binary_little_endian, float32 properties)
// given column counts; attrs is row-major (n, total_cols) float32 already in
// x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_* order.
int gaussian_ply_write(const char* path, const float* attrs, int64_t n,
                       int32_t f_dc_cols, int32_t f_rest_cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  std::string header = "ply\nformat binary_little_endian 1.0\n";
  header += "element vertex " + std::to_string(n) + "\n";
  const char* base[] = {"x", "y", "z", "nx", "ny", "nz"};
  for (auto* b : base) header += std::string("property float ") + b + "\n";
  for (int i = 0; i < f_dc_cols; i++)
    header += "property float f_dc_" + std::to_string(i) + "\n";
  for (int i = 0; i < f_rest_cols; i++)
    header += "property float f_rest_" + std::to_string(i) + "\n";
  header += "property float opacity\n";
  for (int i = 0; i < 3; i++)
    header += "property float scale_" + std::to_string(i) + "\n";
  for (int i = 0; i < 4; i++)
    header += "property float rot_" + std::to_string(i) + "\n";
  header += "end_header\n";
  fwrite(header.data(), 1, header.size(), f);
  int64_t cols = 6 + f_dc_cols + f_rest_cols + 1 + 3 + 4;
  fwrite(attrs, sizeof(float), (size_t)(n * cols), f);
  fclose(f);
  return 0;
}

// ------------------------------------------------- parallel file loading
// Reads `count` whole files concurrently into caller buffers. sizes[] must
// hold each file's size (from stat); returns number of failures.
int read_files_parallel(const char** paths, uint8_t** buffers,
                        const int64_t* sizes, int32_t count,
                        int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::vector<int> fails(n_threads, 0);
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < count; i += n_threads) {
        FILE* f = fopen(paths[i], "rb");
        if (!f) { fails[t]++; continue; }
        size_t got = fread(buffers[i], 1, (size_t)sizes[i], f);
        fclose(f);
        if (got != (size_t)sizes[i]) fails[t]++;
      }
    });
  }
  for (auto& th : pool) th.join();
  int total = 0;
  for (int v : fails) total += v;
  return total;
}

int64_t file_size(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fclose(f);
  return (int64_t)n;
}

}  // extern "C"
