// K8: the projection's forward for a render that records no gradient: the
// store's activations, the EWA covariance, the cull, the radius, the SH
// colour and the bf16 rounding of every row in one launch.
//
// Replaces no TPU kernel: the JAX package's ops/projection.py is jnp code
// that XLA fuses on the TPU. Run eagerly, the same code is ~330 PyTorch
// operations a frame (stacks along the last axis, elementwise operations,
// reductions, three small matrix products). This kernel computes what
// ops/projection.py::project_state_plain computes (project_gaussians over
// the store's get_covariance, get_opacity and get_features) for every row
// of the store, inactive rows included:
//   s = exp(log s) * modifier; q / max(|q|, 1e-12); opacity
//     sigmoid(logit) * active;
//   Sigma = R diag(s)^2 R^T; the pixel mean ((ndc + 1) size - 1) / 2 from
//     full_proj; t = W x + w; J with t.x/t.y clamped at 1.3 tan(fov/2) z;
//     J W Sigma W^T J^T + 0.3 I, det, conic, radius ceil(3 sqrt(lambda));
//   the cull (z <= 0.2, det == 0, an inactive row): radius 0, opacity 0,
//     depth inf, inverse depth 0; the AA opacity factor behind a flag;
//   the SH colour up to the active degree (bands above it add nothing, as
//     get_features' band mask makes them), or the override colour;
//   conic, opacity, rgb and inverse depth rounded to bf16 (RTNE on the
//     bits, NaN and Inf unchanged), kept in f32.
// Every operation is f32, in the order the PyTorch version runs it: no
// multiply-add contraction (-fmad=false) but where that version's matrix
// products fuse (dot3), accurate expf and sqrtf, IEEE division, the Python
// constants rounded to f32 as PyTorch rounds a scalar operand. The depth
// is then the PyTorch version's bit for bit on the card; its reductions
// (the quaternion's and the direction's norms, the covariance's and the
// SH colour's sums) run left to right here, and the matrix-vector product
// of the mean's w may sum otherwise, so other values can differ from it in
// their last bits.
//
// Bound on the H100: bytes. At SH degree 3 a row reads 237 bytes (xyz 12,
// log-scales 12, quaternion 16, opacity 4, the active flag 1, SH DC 12,
// the 15 higher coefficients 180) and writes 48 (mean 8, conic 12,
// opacity 4, rgb 12, depth 4, inverse depth 4, radius 4): 285 bytes, 0.26
// ms for 3M rows at 3.35 TB/s, against ~400 f32 operations a row (0.02 ms
// at 67 TFLOP/s). Design: one thread per row, 128 rows a block. The block
// first copies its rows of the row-major inputs (xyz, log-scales,
// quaternions, SH DC or the override colour, and the SH coefficients the
// active degree uses) into shared memory, as 16-byte loads over the
// block's contiguous span where the span is aligned, so that a warp's
// loads are coalesced whatever the row's width: a row of 15 coefficients
// is 180 bytes, and a thread reading its own would make 45 scalar loads at
// a 180-byte stride, each touching 32 sectors. The thread then reads its
// row from shared memory (odd word strides at degrees 1 and 3, so no bank
// conflict). The camera lies in shared memory too. The SH degree is a
// template argument, so the basis is unrolled and stays in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// ops/projection.py's constants and core/sh.py's coefficients: Python
// doubles, rounded to f32 as PyTorch rounds a scalar operand.
constexpr float kNearZ = (float)0.2;
constexpr float kDilation = (float)0.3;
constexpr float kAaDetFloor = (float)2.5e-5;
constexpr float kLambdaFloor = (float)0.1;
constexpr float kQuatEps = (float)1e-12;
constexpr float kDirEps = (float)1e-12;
constexpr float kDepthEps = (float)1e-6;
constexpr float kProjEps = (float)1e-7;
constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
constexpr float kC20 = (float)1.0925484305920792;
constexpr float kC21 = (float)-1.0925484305920792;
constexpr float kC22 = (float)0.31539156525252005;
constexpr float kC23 = (float)-1.0925484305920792;
constexpr float kC24 = (float)0.5462742152960396;
constexpr float kC30 = (float)-0.5900435899266435;
constexpr float kC31 = (float)2.890611442640554;
constexpr float kC32 = (float)-0.4570457994644658;
constexpr float kC33 = (float)0.3731763325901154;
constexpr float kC34 = (float)-0.4570457994644658;
constexpr float kC35 = (float)1.445305721320277;
constexpr float kC36 = (float)-0.5900435899266435;
constexpr float kC40 = (float)2.5033429417967046;
constexpr float kC41 = (float)-1.7701307697799304;
constexpr float kC42 = (float)0.9461746957575601;
constexpr float kC43 = (float)-0.6690465435572892;
constexpr float kC44 = (float)0.10578554691520431;
constexpr float kC45 = (float)-0.6690465435572892;
constexpr float kC46 = (float)0.47308734787878004;
constexpr float kC47 = (float)-1.7701307697799304;
constexpr float kC48 = (float)0.6258357354491761;

struct Inputs {
  const float* xyz;            // (n, 3)
  const float* scaling;        // (n, 3) log-scales
  const float* rotation;       // (n, 4) unnormalised (w, x, y, z)
  const float* opacity;        // (n, 1) logits
  const uint8_t* active;       // (n,) bool
  const float* dc;             // (n, 3) SH DC
  const float* rest;           // (n, rest_w) higher SH, channel-minor
  const float* override_rgb;   // (n, 3) or null
  const float* world_view;     // (4, 4) row-major
  const float* full_proj;      // (4, 4)
  const float* cam_center;     // (3,)
  int n, rest_w, antialias;
  float scale_mod, focal_x, focal_y, lim_x, lim_y, map_w, map_h;
};

struct Outputs {
  float* mean2d;    // (n, 2)
  float* conic;     // (n, 3)
  float* opacity;   // (n,)
  float* rgb;       // (n, 3)
  float* depth;     // (n,)
  float* invdepth;  // (n,)
  int* radius;      // (n,)
};

// torch.clamp and clamp_min: NaN passes through.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// ops/projection.py::_round_bf16_bits.
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7F800000u) != 0x7F800000u) {
    u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  }
  return __uint_as_float(u);
}

// The first `cols` words of rows [row0, row0 + rows) of `src` (row stride
// `width` words) into `dst` (row stride `cols`). A whole row's span is
// contiguous: 16-byte loads where it starts on 16 bytes, the tail word by
// word. `dst` lies on 16 bytes.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int width, int cols, int64_t row0,
                                      int rows, float* __restrict__ dst) {
  const float* from = src + row0 * width;
  if (cols == width) {
    const int count = rows * width;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(from) & 15) == 0) {
      const float4* from4 = reinterpret_cast<const float4*>(from);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      const int n4 = count >> 2;
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        dst4[i] = __ldg(from4 + i);
      }
      done = n4 << 2;
    }
    for (int i = done + threadIdx.x; i < count; i += kThreads) {
      dst[i] = __ldg(from + i);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols;
      dst[i] = __ldg(from + (int64_t)r * width + (i - r * cols));
    }
  }
}

// core/sh.py::sh_basis, term by term in its order.
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = kC0;
  if (D >= 1) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC20 * xy;
    b[5] = kC21 * yz;
    b[6] = kC22 * (2.0f * zz - xx - yy);
    b[7] = kC23 * xz;
    b[8] = kC24 * (xx - yy);
    if (D >= 3) {
      b[9] = kC30 * y * (3.0f * xx - yy);
      b[10] = kC31 * xy * z;
      b[11] = kC32 * y * (4.0f * zz - xx - yy);
      b[12] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = kC34 * x * (4.0f * zz - xx - yy);
      b[14] = kC35 * z * (xx - yy);
      b[15] = kC36 * x * (xx - 3.0f * yy);
    }
    if (D >= 4) {
      b[16] = kC40 * xy * (xx - yy);
      b[17] = kC41 * yz * (3.0f * xx - yy);
      b[18] = kC42 * xy * (7.0f * zz - 1.0f);
      b[19] = kC43 * yz * (7.0f * zz - 3.0f);
      b[20] = kC44 * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = kC45 * xz * (7.0f * zz - 3.0f);
      b[22] = kC46 * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = kC47 * xz * (xx - 3.0f * yy);
      b[24] = kC48 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// a . b over three terms, for the PyTorch version's matrix products
// (xyz full_proj^T, xyz W^T, J W and the mean's w): fused multiply-adds
// in the order of the terms, as cuBLAS's f32 products sum them. So the
// camera-space z, and with it the depth that the binning sorts, equals the
// PyTorch version's bit for bit, and Gaussians whose depths lie within an
// ulp keep its order (an order flipped between two overlapping Gaussians
// moves a pixel by several 1/255 levels).
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// The quadratic form a^T Sigma b of ops/projection.py::compute_cov2d,
// s = (s00, s01, s02, s11, s12, s22).
__device__ __forceinline__ float quad(const float* a, const float* b,
                                      const float* s) {
  return a[0] * b[0] * s[0] + a[1] * b[1] * s[3] + a[2] * b[2] * s[5] +
         (a[0] * b[1] + a[1] * b[0]) * s[1] +
         (a[0] * b[2] + a[2] * b[0]) * s[2] +
         (a[1] * b[2] + a[2] * b[1]) * s[4];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    project_fwd_kernel(const Inputs in, const Outputs out) {
  constexpr int kBases = (D + 1) * (D + 1);
  constexpr int kCols = 3 * (kBases - 1);
  extern __shared__ float4 staged4[];
  __shared__ float cam[35];
  float* s_xyz = reinterpret_cast<float*>(staged4);
  float* s_scl = s_xyz + 3 * kThreads;
  float* s_rot = s_scl + 3 * kThreads;
  float* s_rgb = s_rot + 4 * kThreads;  // SH DC, or the override colour
  float* s_rest = s_rgb + 3 * kThreads;

  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t left = (int64_t)in.n - row0;
  const int rows = left < kThreads ? (int)left : kThreads;
  const bool sh = in.override_rgb == nullptr;
  if (threadIdx.x < 16) {
    cam[threadIdx.x] = in.world_view[threadIdx.x];
    cam[16 + threadIdx.x] = in.full_proj[threadIdx.x];
  } else if (threadIdx.x < 19) {
    cam[16 + threadIdx.x] = in.cam_center[threadIdx.x - 16];
  }
  stage(in.xyz, 3, 3, row0, rows, s_xyz);
  stage(in.scaling, 3, 3, row0, rows, s_scl);
  stage(in.rotation, 4, 4, row0, rows, s_rot);
  stage(sh ? in.dc : in.override_rgb, 3, 3, row0, rows, s_rgb);
  if (sh && kCols > 0) stage(in.rest, in.rest_w, kCols, row0, rows, s_rest);
  __syncthreads();
  const int l = threadIdx.x;
  if (l >= rows) return;
  const int64_t i = row0 + l;
  const float* W = cam;        // world_view
  const float* P = cam + 16;   // full_proj
  const float* C = cam + 32;   // camera centre
  const float px = s_xyz[3 * l], py = s_xyz[3 * l + 1], pz = s_xyz[3 * l + 2];

  // The pixel mean.
  const float h0 = dot3(px, py, pz, P[0], P[1], P[2]) + P[3];
  const float h1 = dot3(px, py, pz, P[4], P[5], P[6]) + P[7];
  const float hw = dot3(px, py, pz, P[12], P[13], P[14]) + P[15];
  const float inv_w = 1.0f / (hw + kProjEps);
  const float m0 = ((h0 * inv_w + 1.0f) * in.map_w - 1.0f) * 0.5f;
  const float m1 = ((h1 * inv_w + 1.0f) * in.map_h - 1.0f) * 0.5f;

  // Camera space and the Jacobian's rows times W (J's zeros take part, as
  // in the product).
  const float t0 = dot3(px, py, pz, W[0], W[1], W[2]) + W[3];
  const float t1 = dot3(px, py, pz, W[4], W[5], W[6]) + W[7];
  const float tz = dot3(px, py, pz, W[8], W[9], W[10]) + W[11];
  const float txz = clamp(t0 / tz, -in.lim_x, in.lim_x) * tz;
  const float tyz = clamp(t1 / tz, -in.lim_y, in.lim_y) * tz;
  const float inv_z = 1.0f / tz;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = in.focal_x * inv_z;
  const float j02 = -in.focal_x * txz * inv_z2;
  const float j11 = in.focal_y * inv_z;
  const float j12 = -in.focal_y * tyz * inv_z2;
  float a[3], b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = dot3(j00, 0.0f, j02, W[k], W[4 + k], W[8 + k]);
    b[k] = dot3(0.0f, j11, j12, W[k], W[4 + k], W[8 + k]);
  }

  // The 3D covariance R diag(s)^2 R^T from the activated scales and the
  // normalised quaternion.
  const float sx = expf(s_scl[3 * l]) * in.scale_mod;
  const float sy = expf(s_scl[3 * l + 1]) * in.scale_mod;
  const float sz = expf(s_scl[3 * l + 2]) * in.scale_mod;
  const float4 q = reinterpret_cast<const float4*>(s_rot)[l];
  const float qn = clamp_min(
      sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w), kQuatEps);
  const float qw = q.x / qn, qx = q.y / qn, qy = q.z / qn, qz = q.w / qn;
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float R[9] = {
      1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy),
      2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx),
      2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)};
  const float s2[3] = {sx * sx, sy * sy, sz * sz};
  float sig[6];  // s00, s01, s02, s11, s12, s22
  const int pairs[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const float* ri = R + 3 * pairs[e][0];
    const float* rj = R + 3 * pairs[e][1];
    sig[e] = s2[0] * ri[0] * rj[0] + s2[1] * ri[1] * rj[1] +
             s2[2] * ri[2] * rj[2];
  }

  // The 2D covariance, its dilation, conic and radius, and the cull.
  const float c00 = quad(a, a, sig);
  const float c01 = quad(a, b, sig);
  const float c11 = quad(b, b, sig);
  const float det_raw = c00 * c11 - c01 * c01;
  const float cxx = c00 + kDilation;
  const float cyy = c11 + kDilation;
  const float det = cxx * cyy - c01 * c01;
  const float det_inv = det != 0.0f ? 1.0f / det : 0.0f;
  const float mid = 0.5f * (cxx + cyy);
  const float lam = mid + sqrtf(clamp_min(mid * mid - det, kLambdaFloor));
  const float r = ceilf(3.0f * sqrtf(lam));
  const bool act = in.active[i] != 0;
  const bool cull = tz <= kNearZ || det == 0.0f || !act;

  float op = 1.0f / (1.0f + expf(-in.opacity[i])) * (act ? 1.0f : 0.0f);
  if (in.antialias) {
    op = op * sqrtf(clamp_min(det_raw * det_inv, kAaDetFloor));
  }

  float rgb[3];
  if (sh) {
    const float dx = px - C[0], dy = py - C[1], dz = pz - C[2];
    const float dn = clamp_min(sqrtf(dx * dx + dy * dy + dz * dz), kDirEps);
    float basis[kBases];
    sh_basis<D>(dx / dn, dy / dn, dz / dn, basis);
    const float* dc = s_rgb + 3 * l;
    const float* rest = s_rest + kCols * l;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = basis[0] * dc[c];
#pragma unroll
      for (int k = 1; k < kBases; ++k) {
        acc = acc + basis[k] * rest[3 * (k - 1) + c];
      }
      rgb[c] = clamp_min(acc + 0.5f, 0.0f);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = s_rgb[3 * l + c];
  }

  reinterpret_cast<float2*>(out.mean2d)[i] = make_float2(m0, m1);
  out.conic[3 * i] = round_bf16(cyy * det_inv);
  out.conic[3 * i + 1] = round_bf16(-c01 * det_inv);
  out.conic[3 * i + 2] = round_bf16(cxx * det_inv);
  out.opacity[i] = round_bf16(cull ? 0.0f : op);
#pragma unroll
  for (int c = 0; c < 3; ++c) out.rgb[3 * i + c] = round_bf16(rgb[c]);
  out.depth[i] = cull ? INFINITY : tz;
  out.invdepth[i] =
      round_bf16(cull ? 0.0f : 1.0f / clamp_min(tz, kDepthEps));
  out.radius[i] = cull ? 0 : (int)r;
}

template <int D>
void launch(const Inputs& in, const Outputs& out, cudaStream_t stream) {
  const size_t words = kThreads * (13 + 3 * ((D + 1) * (D + 1) - 1));
  const unsigned blocks = (unsigned)((in.n + kThreads - 1) / kThreads);
  project_fwd_kernel<D><<<blocks, kThreads, words * sizeof(float), stream>>>(
      in, out);
}

}  // namespace

// degree: the SH degree the colour uses (0-4; the store's active degree,
// at most its maximum); rest_w: features_rest's row width in words, at
// least 3 ((degree + 1)^2 - 1). override_rgb may be null (the SH colour).
// Every pointer lies on the device; mean2d lies on 8 bytes.
extern "C" int project_fwd_launch(
    const void* xyz, const void* scaling, const void* rotation,
    const void* opacity, const void* active, const void* features_dc,
    const void* features_rest, const void* override_rgb,
    const void* world_view, const void* full_proj, const void* cam_center,
    int n, int rest_w, int degree, float scale_mod, float focal_x,
    float focal_y, float lim_x, float lim_y, float map_w, float map_h,
    int antialias, void* mean2d, void* conic, void* opacity_out, void* rgb,
    void* depth, void* invdepth, void* radius, void* stream) {
  const Inputs in{(const float*)xyz, (const float*)scaling,
                  (const float*)rotation, (const float*)opacity,
                  (const uint8_t*)active, (const float*)features_dc,
                  (const float*)features_rest, (const float*)override_rgb,
                  (const float*)world_view, (const float*)full_proj,
                  (const float*)cam_center, n, rest_w, antialias,
                  scale_mod, focal_x, focal_y, lim_x, lim_y, map_w, map_h};
  const Outputs out{(float*)mean2d, (float*)conic, (float*)opacity_out,
                    (float*)rgb, (float*)depth, (float*)invdepth,
                    (int*)radius};
  if (degree < 0 || degree > 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (degree) {
      case 0: launch<0>(in, out, s); break;
      case 1: launch<1>(in, out, s); break;
      case 2: launch<2>(in, out, s); break;
      case 3: launch<3>(in, out, s); break;
      default: launch<4>(in, out, s); break;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* project_fwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
