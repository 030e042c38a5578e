// Projection and SH colour of every Gaussian, forward and backward: one
// thread a Gaussian, one kernel each way.
//
// Replaces no TPU kernel: the JAX package projects with XLA
// (semantic_gaussians_tpu/ops/projection.py, differentiated by jax.grad),
// and the port's plain version (ops/projection.py) is plain torch. This is
// the counterpart of the reference rasterizer's preprocessCUDA /
// computeColorFromSH and their backward. In plain torch the layer is ~300
// device ops forward (four N x 3 products, a stack of 16 SH basis columns)
// and ~500 autograd ops backward (cuBLAS batched products for the SH
// contraction's gradient), most of a training step's device time.
//
// Forward, per Gaussian, in ops/projection.py's order of operations: the
// view and clip transforms (each once), the near cull at view z <= 0.2, the
// 1.3 tan FOV clamp, the EWA covariance from scales x scaling_modifier and
// the normalised quaternion (or a packed cov3d_precomp), the +0.3 px low
// pass, the conic, the radius (eigenvalue floor 0.1), the opacity-aware
// radii_xy and cull quadratic, the alive mask, the mean2d_offset, and the
// colour from SH up to the active degree, clamped at 0 (none where an
// override colour replaces it).
// Backward: the gradients of means, scales, quats, opacities, SH and
// cov3d_precomp from the cotangents of means2d, depths, conics, opacities
// and colours, by autograd's rules for the forward's ops: where() passes
// the gradient to the branch it took, clamp() where its input lies inside
// the range or on a bound, the SH coefficients above the active degree get
// zero. The offset's gradient is the means2d cotangent itself (the caller's).
//
// What bounds it on the H100: bytes. At degree 3 the forward reads 59
// floats a Gaussian (means 3, scales 3, quats 4, opacity 1, SH 48) and the
// alive byte, and writes 13 floats and 3 ints; the backward reads ~10
// cotangents, the same inputs again where a cotangent is nonzero, and
// writes 59 floats of gradients. A few hundred float32 operations a
// Gaussian are far below the bytes at 67 TFLOP/s.
//
// What the design does about it:
// * One thread a Gaussian over the whole capacity; everything but the SH
//   row lives in registers.
// * A Gaussian's SH row is 3K floats (192 B at K = 16): read a row a
//   thread, a warp's loads would lie 192 B apart. A block stages its
//   THREADS rows through shared memory with coalesced 16-byte loads (4-byte
//   ones where a row is not a multiple of 16 B), into rows of odd stride,
//   so that each thread's reads of its own row hit 32 different banks. The
//   backward writes the SH gradients back the same way.
// * The backward reads a Gaussian's cotangents first. A Gaussian with no
//   pairs has all-zero cotangents (the segment sum gives it exactly 0): it
//   writes zero gradients and reads nothing else. Only rows whose colour
//   cotangent is nonzero are staged.
// * The camera (world_view, full_proj, centre: 35 floats) is read once a
//   block into shared memory.
// * It launches on the caller's stream, allocates nothing and never
//   synchronises, so the train step's CUDA graph captures it.
//
// Rounding: the library is built with -fmad=false, so each product and sum
// rounds as torch's separate ops do; sums over the SH coefficients and the
// 3-vector products run left to right (torch's matmul / einsum may sum in
// another order).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CAM_FLOATS = 36;  // world_view 16, full_proj 16, centre 3, pad
constexpr float NEAR_CULL_Z = 0.2f;
constexpr float LOWPASS = 0.3f;
constexpr float EIG_FLOOR = 0.1f;

// utils/sh.py's constants, rounded from their doubles as torch rounds them.
constexpr float C0 = static_cast<float>(0.28209479177387814);
constexpr float C1 = static_cast<float>(0.4886025119029199);
constexpr float C2_0 = static_cast<float>(1.0925484305920792);
constexpr float C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float C2_2 = static_cast<float>(0.31539156525252005);
constexpr float C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float C2_4 = static_cast<float>(0.5462742152960396);
constexpr float C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float C3_1 = static_cast<float>(2.890611442640554);
constexpr float C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float C3_3 = static_cast<float>(0.3731763325901154);
constexpr float C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float C3_5 = static_cast<float>(1.445305721320277);
constexpr float C3_6 = static_cast<float>(-0.5900435899266435);
constexpr float C4_0 = static_cast<float>(2.5033429417967046);
constexpr float C4_1 = static_cast<float>(-1.7701307697799304);
constexpr float C4_2 = static_cast<float>(0.9461746957575601);
constexpr float C4_3 = static_cast<float>(-0.6690465435572892);
constexpr float C4_4 = static_cast<float>(0.10578554691520431);
constexpr float C4_5 = static_cast<float>(-0.6690465435572892);
constexpr float C4_6 = static_cast<float>(0.47308734787878004);
constexpr float C4_7 = static_cast<float>(-1.7701307697799304);
constexpr float C4_8 = static_cast<float>(0.6258357354491761);

struct Frame {
  int n;      // Gaussians (the capacity)
  int ncoef;  // (active degree + 1)^2 <= K
  int deg;    // active SH degree
  int vec;    // the SH rows (and their gradient's) are 16-byte aligned
  float width, height, fx, fy, limx, limy, scale_mod;
};

struct Inputs {
  const float* means;   // [N, 3]
  const float* scales;  // [N, 3] activated
  const float* quats;   // [N, 4] raw (w, x, y, z)
  const float* opac;    // [N]
  const float* sh;      // [N, K, 3] or null
  const float* cov6;    // [N, 6] packed or null
  const uint8_t* alive; // [N] bool or null
  const float* offset;  // [N, 2] or null
  const float* wv;      // [4, 4] world_view
  const float* fp;      // [4, 4] full_proj
  const float* cc;      // [3] camera centre
};

struct Outputs {
  float* means2d;  // [N, 2]
  float* depths;   // [N]
  float* conics;   // [N, 3]
  float* opac;     // [N]
  float* colors;   // [N, 3] or null
  int* radii;      // [N]
  int* radii_xy;   // [N, 2]
  float* cull;     // [N, 3]
};

// A cotangent column block: element (i, j) at ptr[i * stride + j]; null = 0.
struct Cot {
  const float* ptr;
  long long stride;
};

struct Cotangents {
  Cot means2d, depths, conics, opac, colors;
};

struct Grads {  // each null where not wanted
  float* means;   // [N, 3]
  float* scales;  // [N, 3]
  float* quats;   // [N, 4]
  float* opac;    // [N]
  float* sh;      // [N, K, 3]
  float* cov6;    // [N, 6]
};

template <int K>
__host__ __device__ constexpr int row_stride() {
  return (3 * K) | 1;  // odd: a thread's reads of its own row are conflict free
}

__device__ __forceinline__ void load_camera(const Inputs& in, float* cam) {
  const int t = threadIdx.x;
  if (t < 16) cam[t] = in.wv[t];
  else if (t < 32) cam[t] = in.fp[t - 16];
  else if (t < 35) cam[t] = in.cc[t - 32];
  __syncthreads();
}

// Rows [0, nrows) of a block's SH table (row r at g + r * 3K) into shared
// memory at stride row_stride<K>(); rows whose flag is 0 are skipped.
template <int K>
__device__ __forceinline__ void stage_in(const float* __restrict__ g, float* s, int nrows,
                                         bool vec, const uint8_t* flags) {
  constexpr int R = 3 * K;
  constexpr int S = row_stride<K>();
  if (R % 4 == 0 && vec) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int total4 = nrows * (R / 4);
#pragma unroll 4
    for (int f4 = threadIdx.x; f4 < total4; f4 += THREADS) {
      const int row = (4 * f4) / R;
      if (flags != nullptr && !flags[row]) continue;
      const float4 v = __ldg(g4 + f4);
      float* d = s + row * S + (4 * f4 - row * R);
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    const int total = nrows * R;
#pragma unroll 4
    for (int f = threadIdx.x; f < total; f += THREADS) {
      const int row = f / R;
      if (flags != nullptr && !flags[row]) continue;
      s[row * S + (f - row * R)] = __ldg(g + f);
    }
  }
}

// The inverse: shared rows out to g; rows whose flag is 0 are written as 0.
template <int K>
__device__ __forceinline__ void stage_out(float* __restrict__ g, const float* s, int nrows,
                                          bool vec, const uint8_t* flags) {
  constexpr int R = 3 * K;
  constexpr int S = row_stride<K>();
  if (R % 4 == 0 && vec) {
    float4* g4 = reinterpret_cast<float4*>(g);
    const int total4 = nrows * (R / 4);
#pragma unroll 4
    for (int f4 = threadIdx.x; f4 < total4; f4 += THREADS) {
      const int row = (4 * f4) / R;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (flags[row]) {
        const float* d = s + row * S + (4 * f4 - row * R);
        v = make_float4(d[0], d[1], d[2], d[3]);
      }
      g4[f4] = v;
    }
  } else {
    const int total = nrows * R;
#pragma unroll 4
    for (int f = threadIdx.x; f < total; f += THREADS) {
      const int row = f / R;
      g[f] = flags[row] ? s[row * S + (f - row * R)] : 0.0f;
    }
  }
}

// The view transform: t = means @ W^T + T, each row summed left to right.
__device__ __forceinline__ void view_point(const float* cam, float m0, float m1, float m2,
                                           float t[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    t[j] = m0 * cam[4 * j] + m1 * cam[4 * j + 1] + m2 * cam[4 * j + 2] + cam[4 * j + 3];
}

// The two rows u, v of JW and what their gradient needs (_ewa_rows).
struct Ewa {
  bool in_front;
  float tz, r0, r1, cl0, cl1, tx, ty, inv_z, b1, b2;
  float u[3], v[3];
};

__device__ __forceinline__ void ewa_rows(const float* cam, const float t[3], const Frame& f,
                                         Ewa& e) {
  e.in_front = t[2] > NEAR_CULL_Z;
  e.tz = e.in_front ? t[2] : 1.0f;
  e.r0 = t[0] / e.tz;
  e.r1 = t[1] / e.tz;
  e.cl0 = fminf(fmaxf(e.r0, -f.limx), f.limx);
  e.cl1 = fminf(fmaxf(e.r1, -f.limy), f.limy);
  e.tx = e.cl0 * e.tz;
  e.ty = e.cl1 * e.tz;
  e.inv_z = 1.0f / e.tz;
  const float a1 = f.fx * e.inv_z;
  e.b1 = -f.fx * e.tx * e.inv_z * e.inv_z;
  const float a2 = f.fy * e.inv_z;
  e.b2 = -f.fy * e.ty * e.inv_z * e.inv_z;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    e.u[j] = a1 * cam[j] + e.b1 * cam[8 + j];
    e.v[j] = a2 * cam[4 + j] + e.b2 * cam[8 + j];
  }
}

// quad(p, q) of compute_cov2d: p^T Sigma q of the packed covariance.
__device__ __forceinline__ float quad(const float c[6], const float p[3], const float q[3]) {
  return c[0] * p[0] * q[0] + c[3] * p[1] * q[1] + c[5] * p[2] * q[2] +
         c[1] * (p[0] * q[1] + p[1] * q[0]) + c[2] * (p[0] * q[2] + p[2] * q[0]) +
         c[4] * (p[1] * q[2] + p[2] * q[1]);
}

// The scales/quats path's pieces (compute_cov2d_from_scales_quats).
struct Rot {
  float q[4];   // raw quaternion
  float nq;     // sqrt(|q|^2 + 1e-12)
  float qn[4];  // normalised (w, x, y, z)
  float C[3][3];
  float s[3];   // scales x scaling_modifier
};

__device__ __forceinline__ void rotation(const float* quats, const float* scales, int i,
                                         float scale_mod, Rot& r) {
#pragma unroll
  for (int k = 0; k < 4; ++k) r.q[k] = quats[4ll * i + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) r.s[k] = scales[3ll * i + k] * scale_mod;
  r.nq = sqrtf(r.q[0] * r.q[0] + r.q[1] * r.q[1] + r.q[2] * r.q[2] + r.q[3] * r.q[3] + 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.qn[k] = r.q[k] / r.nq;
  const float w = r.qn[0], x = r.qn[1], y = r.qn[2], z = r.qn[3];
  r.C[0][0] = 1.0f - 2.0f * (y * y + z * z);
  r.C[0][1] = 2.0f * (x * y + w * z);
  r.C[0][2] = 2.0f * (x * z - w * y);
  r.C[1][0] = 2.0f * (x * y - w * z);
  r.C[1][1] = 1.0f - 2.0f * (x * x + z * z);
  r.C[1][2] = 2.0f * (y * z + w * x);
  r.C[2][0] = 2.0f * (x * z + w * y);
  r.C[2][1] = 2.0f * (y * z - w * x);
  r.C[2][2] = 1.0f - 2.0f * (x * x + y * y);
}

// The SH basis at a unit direction, entries [0, (deg + 1)^2) (utils/sh.py).
template <int K>
__device__ __forceinline__ void sh_basis(int deg, float x, float y, float z, float (&B)[K]) {
  B[0] = C0;
  if constexpr (K > 1) {
    if (deg > 0) {
      B[1] = -C1 * y;
      B[2] = C1 * z;
      B[3] = -C1 * x;
    }
  }
  if constexpr (K > 4) {
    if (deg > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      B[4] = C2_0 * xy;
      B[5] = C2_1 * yz;
      B[6] = C2_2 * (2.0f * zz - xx - yy);
      B[7] = C2_3 * xz;
      B[8] = C2_4 * (xx - yy);
      if constexpr (K > 9) {
        if (deg > 2) {
          B[9] = C3_0 * y * (3.0f * xx - yy);
          B[10] = C3_1 * xy * z;
          B[11] = C3_2 * y * (4.0f * zz - xx - yy);
          B[12] = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
          B[13] = C3_4 * x * (4.0f * zz - xx - yy);
          B[14] = C3_5 * z * (xx - yy);
          B[15] = C3_6 * x * (xx - 3.0f * yy);
        }
      }
      if constexpr (K > 16) {
        if (deg > 3) {
          B[16] = C4_0 * xy * (xx - yy);
          B[17] = C4_1 * yz * (3.0f * xx - yy);
          B[18] = C4_2 * xy * (7.0f * zz - 1.0f);
          B[19] = C4_3 * yz * (7.0f * zz - 3.0f);
          B[20] = C4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
          B[21] = C4_5 * xz * (7.0f * zz - 3.0f);
          B[22] = C4_6 * (xx - yy) * (7.0f * zz - 1.0f);
          B[23] = C4_7 * xz * (xx - 3.0f * yy);
          B[24] = C4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
        }
      }
    }
  }
}

// The gradient of the direction from the basis' cotangents dB (sh.py's
// sh_basis_vjp, term for term).
template <int K>
__device__ __forceinline__ void sh_basis_vjp(int deg, float x, float y, float z,
                                             const float (&dB)[K], float d[3]) {
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if constexpr (K > 1) {
    if (deg > 0) {
      dx += -C1 * dB[3];
      dy += -C1 * dB[1];
      dz += C1 * dB[2];
    }
  }
  if constexpr (K > 4) {
    if (deg > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      dx += C2_0 * y * dB[4] - 2.0f * C2_2 * x * dB[6] + C2_3 * z * dB[7] +
            2.0f * C2_4 * x * dB[8];
      dy += C2_0 * x * dB[4] + C2_1 * z * dB[5] - 2.0f * C2_2 * y * dB[6] -
            2.0f * C2_4 * y * dB[8];
      dz += C2_1 * y * dB[5] + 4.0f * C2_2 * z * dB[6] + C2_3 * x * dB[7];
      if constexpr (K > 9) {
        if (deg > 2) {
          dx += C3_0 * 6.0f * xy * dB[9] + C3_1 * yz * dB[10] - C3_2 * 2.0f * xy * dB[11] -
                C3_3 * 6.0f * xz * dB[12] + C3_4 * (4.0f * zz - 3.0f * xx - yy) * dB[13] +
                C3_5 * 2.0f * xz * dB[14] + C3_6 * (3.0f * xx - 3.0f * yy) * dB[15];
          dy += C3_0 * (3.0f * xx - 3.0f * yy) * dB[9] + C3_1 * xz * dB[10] +
                C3_2 * (4.0f * zz - xx - 3.0f * yy) * dB[11] - C3_3 * 6.0f * yz * dB[12] -
                C3_4 * 2.0f * xy * dB[13] - C3_5 * 2.0f * yz * dB[14] -
                C3_6 * 6.0f * xy * dB[15];
          dz += C3_1 * xy * dB[10] + C3_2 * 8.0f * yz * dB[11] +
                C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * dB[12] +
                C3_4 * 8.0f * xz * dB[13] + C3_5 * (xx - yy) * dB[14];
        }
      }
      if constexpr (K > 16) {
        if (deg > 3) {
          const float xyz = xy * z;
          dx += C4_0 * y * (3.0f * xx - yy) * dB[16] + C4_1 * 6.0f * xyz * dB[17] +
                C4_2 * y * (7.0f * zz - 1.0f) * dB[18] +
                C4_5 * z * (7.0f * zz - 3.0f) * dB[21] +
                C4_6 * 2.0f * x * (7.0f * zz - 1.0f) * dB[22] +
                C4_7 * z * (3.0f * xx - 3.0f * yy) * dB[23] +
                C4_8 * 4.0f * x * (xx - 3.0f * yy) * dB[24];
          dy += C4_0 * x * (xx - 3.0f * yy) * dB[16] +
                C4_1 * z * (3.0f * xx - 3.0f * yy) * dB[17] +
                C4_2 * x * (7.0f * zz - 1.0f) * dB[18] +
                C4_3 * z * (7.0f * zz - 3.0f) * dB[19] -
                C4_6 * 2.0f * y * (7.0f * zz - 1.0f) * dB[22] - C4_7 * 6.0f * xyz * dB[23] +
                C4_8 * 4.0f * y * (yy - 3.0f * xx) * dB[24];
          dz += C4_1 * y * (3.0f * xx - yy) * dB[17] + C4_2 * 14.0f * xyz * dB[18] +
                C4_3 * y * (21.0f * zz - 3.0f) * dB[19] +
                C4_4 * z * (140.0f * zz - 60.0f) * dB[20] +
                C4_5 * x * (21.0f * zz - 3.0f) * dB[21] +
                C4_6 * 14.0f * z * (xx - yy) * dB[22] + C4_7 * x * (xx - 3.0f * yy) * dB[23];
        }
      }
    }
  }
  d[0] = dx;
  d[1] = dy;
  d[2] = dz;
}

// The unit direction from the camera centre to the mean, and the norm.
__device__ __forceinline__ float view_dir(const float* cam, float m0, float m1, float m2,
                                          float dir[3]) {
  const float d0 = m0 - cam[32], d1 = m1 - cam[33], d2 = m2 - cam[34];
  const float nrm = sqrtf(d0 * d0 + d1 * d1 + d2 * d2 + 1e-20f);
  dir[0] = d0 / nrm;
  dir[1] = d1 / nrm;
  dir[2] = d2 / nrm;
  return nrm;
}

// The clip transform of a mean: homogeneous x, y, w and rw = 1 / (safe w + 1e-7).
struct Clip {
  float ph0, ph1, pw, rw;
  bool pw_ok;
};

__device__ __forceinline__ Clip clip_point(const float* cam, float m0, float m1, float m2) {
  Clip c;
  c.ph0 = m0 * cam[16] + m1 * cam[17] + m2 * cam[18] + cam[19];
  c.ph1 = m0 * cam[20] + m1 * cam[21] + m2 * cam[22] + cam[23];
  c.pw = m0 * cam[28] + m1 * cam[29] + m2 * cam[30] + cam[31];
  c.pw_ok = fabsf(c.pw) > 1e-6f;
  c.rw = 1.0f / ((c.pw_ok ? c.pw : 1e-6f) + 1e-7f);
  return c;
}

// The 2D covariance (a, b, c) with the low pass, from cov3d_precomp or from
// scales and quats; the pieces its gradient needs besides.
struct Cov2d {
  float a, b, c;
  float cov[6];                        // the packed 3D covariance (cov6 path)
  Rot r;                               // scales / quats path:
  float cu[3], cv[3], lu[3], lv[3];    // C.u, C.v, L^T u = s C.u, L^T v
};

__device__ __forceinline__ void cov2d(const Inputs& in, int i, const Frame& f, const Ewa& e,
                                      Cov2d& k) {
  if (in.cov6 != nullptr) {
#pragma unroll
    for (int j = 0; j < 6; ++j) k.cov[j] = in.cov6[6ll * i + j];
    k.a = quad(k.cov, e.u, e.u) + LOWPASS;
    k.b = quad(k.cov, e.u, e.v);
    k.c = quad(k.cov, e.v, e.v) + LOWPASS;
    return;
  }
  rotation(in.quats, in.scales, i, f.scale_mod, k.r);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    k.cu[j] = k.r.C[j][0] * e.u[0] + k.r.C[j][1] * e.u[1] + k.r.C[j][2] * e.u[2];
    k.cv[j] = k.r.C[j][0] * e.v[0] + k.r.C[j][1] * e.v[1] + k.r.C[j][2] * e.v[2];
    k.lu[j] = k.r.s[j] * k.cu[j];
    k.lv[j] = k.r.s[j] * k.cv[j];
  }
  k.a = k.lu[0] * k.lu[0] + k.lu[1] * k.lu[1] + k.lu[2] * k.lu[2] + LOWPASS;
  k.b = k.lu[0] * k.lv[0] + k.lu[1] * k.lv[1] + k.lu[2] * k.lv[2];
  k.c = k.lv[0] * k.lv[0] + k.lv[1] * k.lv[1] + k.lv[2] * k.lv[2] + LOWPASS;
}

// The SH colour before its + 0.5 and clamp: sum_k row[k] B[k], k < ncoef.
template <int K>
__device__ __forceinline__ void sh_colour(const float* row, const float (&B)[K], int ncoef,
                                          float col[3]) {
  col[0] = col[1] = col[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < ncoef) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + row[3 * k + ch] * B[k];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    project_fwd(Inputs in, Frame f, Outputs out) {
  extern __shared__ float smem[];
  float* cam = smem;
  float* rows = smem + CAM_FLOATS;
  const int r0 = blockIdx.x * THREADS;
  const int nrows = min(THREADS, f.n - r0);
  load_camera(in, cam);
  if constexpr (K > 0) {
    stage_in<K>(in.sh + 3ll * K * r0, rows, nrows, f.vec, nullptr);
    __syncthreads();
  }
  const int i = r0 + threadIdx.x;
  if (i >= f.n) return;

  const float m0 = in.means[3ll * i], m1 = in.means[3ll * i + 1], m2 = in.means[3ll * i + 2];
  float t[3];
  view_point(cam, m0, m1, m2, t);
  const Clip p = clip_point(cam, m0, m1, m2);
  float mx = ((p.ph0 * p.rw + 1.0f) * f.width - 1.0f) * 0.5f;
  float my = ((p.ph1 * p.rw + 1.0f) * f.height - 1.0f) * 0.5f;
  if (in.offset != nullptr) {
    mx = mx + in.offset[2ll * i];
    my = my + in.offset[2ll * i + 1];
  }

  Ewa e;
  ewa_rows(cam, t, f, e);
  Cov2d cov;
  cov2d(in, i, f, e, cov);
  const float a = cov.a, b = cov.b, c = cov.c;
  const float det = a * c - b * b;
  const bool det_ok = det != 0.0f;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float con0 = c * inv_det, con1 = -b * inv_det, con2 = a * inv_det;
  const float mid = 0.5f * (a + c);
  const float disc = sqrtf(fmaxf(mid * mid - det, EIG_FLOOR));
  const float radius = ceilf(3.0f * sqrtf(fmaxf(mid + disc, 0.0f)));
  const bool valid = e.in_front && det_ok && (in.alive == nullptr || in.alive[i]);
  const float opm = valid ? in.opac[i] : 0.0f;
  const float r_mah2 = 2.0f * logf(fmaxf(255.0f * opm, 1.0f));
  const float r_mah = sqrtf(r_mah2);
  const float rx = fminf(radius, ceilf(r_mah * sqrtf(fmaxf(a, 0.0f))));
  const float ry = fminf(radius, ceilf(r_mah * sqrtf(fmaxf(c, 0.0f))));
  const bool rect = valid && r_mah2 > 0.0f;
  const float inv_r2 = r_mah2 > 0.0f ? 1.0f / fmaxf(r_mah2, 1e-20f) : 0.0f;

  out.means2d[2ll * i] = mx;
  out.means2d[2ll * i + 1] = my;
  out.depths[i] = t[2];
  out.conics[3ll * i] = con0;
  out.conics[3ll * i + 1] = con1;
  out.conics[3ll * i + 2] = con2;
  out.opac[i] = opm;
  out.radii[i] = valid ? static_cast<int>(radius) : 0;
  out.radii_xy[2ll * i] = rect ? static_cast<int>(rx) : 0;
  out.radii_xy[2ll * i + 1] = rect ? static_cast<int>(ry) : 0;
  out.cull[3ll * i] = con0 * inv_r2;
  out.cull[3ll * i + 1] = con1 * inv_r2;
  out.cull[3ll * i + 2] = con2 * inv_r2;

  if constexpr (K > 0) {
    float dir[3];
    view_dir(cam, m0, m1, m2, dir);
    float B[K];
    sh_basis<K>(f.deg, dir[0], dir[1], dir[2], B);
    float col[3];
    sh_colour<K>(rows + threadIdx.x * row_stride<K>(), B, f.ncoef, col);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out.colors[3ll * i + ch] = fmaxf(col[ch] + 0.5f, 0.0f);
  }
}

__device__ __forceinline__ float cot(const Cot& g, int i, int j) {
  return g.ptr == nullptr ? 0.0f : g.ptr[g.stride * i + j];
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    project_bwd(Inputs in, Frame f, Cotangents g, Grads d) {
  extern __shared__ float smem[];
  float* cam = smem;
  uint8_t* flags = reinterpret_cast<uint8_t*>(smem + CAM_FLOATS);
  float* rows = smem + CAM_FLOATS + THREADS / 4;
  const int r0 = blockIdx.x * THREADS;
  const int nrows = min(THREADS, f.n - r0);
  const int i = r0 + threadIdx.x;
  const bool here = i < f.n;

  // The cotangents first: a Gaussian whose cotangents are all zero reads
  // nothing else.
  float gm0 = 0.0f, gm1 = 0.0f, gd = 0.0f, gc0 = 0.0f, gc1 = 0.0f, gc2 = 0.0f, gop = 0.0f;
  float gcol[3] = {0.0f, 0.0f, 0.0f};
  if (here) {
    gm0 = cot(g.means2d, i, 0);
    gm1 = cot(g.means2d, i, 1);
    gd = cot(g.depths, i, 0);
    gc0 = cot(g.conics, i, 0);
    gc1 = cot(g.conics, i, 1);
    gc2 = cot(g.conics, i, 2);
    gop = cot(g.opac, i, 0);
    if constexpr (K > 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) gcol[ch] = cot(g.colors, i, ch);
    }
  }
  const bool geo = gm0 != 0.0f || gm1 != 0.0f || gd != 0.0f || gc0 != 0.0f || gc1 != 0.0f ||
                   gc2 != 0.0f || gop != 0.0f;
  const bool shade = gcol[0] != 0.0f || gcol[1] != 0.0f || gcol[2] != 0.0f;
  flags[threadIdx.x] = shade;
  load_camera(in, cam);  // its barrier also publishes the flags
  if constexpr (K > 0) {
    stage_in<K>(in.sh + 3ll * K * r0, rows, nrows, f.vec, flags);
    __syncthreads();
  }

  if (here && !geo && !shade) {
    if (d.means != nullptr)
      for (int k = 0; k < 3; ++k) d.means[3ll * i + k] = 0.0f;
    if (d.scales != nullptr)
      for (int k = 0; k < 3; ++k) d.scales[3ll * i + k] = 0.0f;
    if (d.quats != nullptr)
      for (int k = 0; k < 4; ++k) d.quats[4ll * i + k] = 0.0f;
    if (d.cov6 != nullptr)
      for (int k = 0; k < 6; ++k) d.cov6[6ll * i + k] = 0.0f;
    if (d.opac != nullptr) d.opac[i] = 0.0f;
  } else if (here) {
    const float m0 = in.means[3ll * i], m1 = in.means[3ll * i + 1], m2 = in.means[3ll * i + 2];
    float dm[3] = {0.0f, 0.0f, 0.0f};

    // Colour: clamp(sum_k sh_k B_k(dir) + 0.5, min=0).
    if constexpr (K > 0) {
      if (shade) {
        float dir[3];
        const float nrm = view_dir(cam, m0, m1, m2, dir);
        float B[K];
        sh_basis<K>(f.deg, dir[0], dir[1], dir[2], B);
        float* row = rows + threadIdx.x * row_stride<K>();
        float col[3];
        sh_colour<K>(row, B, f.ncoef, col);
        float G[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) G[ch] = col[ch] + 0.5f >= 0.0f ? gcol[ch] : 0.0f;
        float dB[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dB[k] = 0.0f;
          if (k < f.ncoef) {
            dB[k] = G[0] * row[3 * k] + G[1] * row[3 * k + 1] + G[2] * row[3 * k + 2];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) row[3 * k + ch] = G[ch] * B[k];
          } else {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) row[3 * k + ch] = 0.0f;
          }
        }
        float ddir[3];
        sh_basis_vjp<K>(f.deg, dir[0], dir[1], dir[2], dB, ddir);
        const float dot = ddir[0] * dir[0] + ddir[1] * dir[1] + ddir[2] * dir[2];
#pragma unroll
        for (int k = 0; k < 3; ++k) dm[k] = (ddir[k] - dir[k] * dot) / nrm;
      }
    }

    float t[3];
    view_point(cam, m0, m1, m2, t);
    Ewa e;
    ewa_rows(cam, t, f, e);
    Cov2d cov;
    cov2d(in, i, f, e, cov);
    // conic = (c, -b, a) / det, det = a c - b b (1 where it is 0)
    const float det = cov.a * cov.c - cov.b * cov.b;
    const bool det_ok = det != 0.0f;
    const float inv_det = 1.0f / (det_ok ? det : 1.0f);
    const float dinv = gc0 * cov.c - gc1 * cov.b + gc2 * cov.a;
    const float ddet = det_ok ? -dinv * inv_det * inv_det : 0.0f;
    const float da = gc2 * inv_det + ddet * cov.c;
    const float db = -gc1 * inv_det - 2.0f * cov.b * ddet;
    const float dc = gc0 * inv_det + ddet * cov.a;
    float du[3], dv[3], dcv[6], ds[3], dq[4];
    if (in.cov6 != nullptr) {
      // a = u^T S u + 0.3, b = u^T S v, c = v^T S v + 0.3, S the packed
      // (xx, xy, xz, yy, yz, zz)
      const float* S = cov.cov;
      const float Su[3] = {S[0] * e.u[0] + S[1] * e.u[1] + S[2] * e.u[2],
                           S[1] * e.u[0] + S[3] * e.u[1] + S[4] * e.u[2],
                           S[2] * e.u[0] + S[4] * e.u[1] + S[5] * e.u[2]};
      const float Sv[3] = {S[0] * e.v[0] + S[1] * e.v[1] + S[2] * e.v[2],
                           S[1] * e.v[0] + S[3] * e.v[1] + S[4] * e.v[2],
                           S[2] * e.v[0] + S[4] * e.v[1] + S[5] * e.v[2]};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        du[j] = 2.0f * da * Su[j] + db * Sv[j];
        dv[j] = 2.0f * dc * Sv[j] + db * Su[j];
      }
      const int P[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int p = P[j][0], q = P[j][1];
        if (p == q) {
          dcv[j] = da * e.u[p] * e.u[p] + db * e.u[p] * e.v[p] + dc * e.v[p] * e.v[p];
        } else {
          dcv[j] = 2.0f * da * e.u[p] * e.u[q] + db * (e.u[p] * e.v[q] + e.u[q] * e.v[p]) +
                   2.0f * dc * e.v[p] * e.v[q];
        }
      }
    } else {
      const Rot& r = cov.r;
      float dlu[3], dlv[3], dC[3][3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        dlu[j] = 2.0f * da * cov.lu[j] + db * cov.lv[j];
        dlv[j] = 2.0f * dc * cov.lv[j] + db * cov.lu[j];
        ds[j] = (dlu[j] * cov.cu[j] + dlv[j] * cov.cv[j]) * f.scale_mod;
#pragma unroll
        for (int l = 0; l < 3; ++l) dC[j][l] = r.s[j] * (dlu[j] * e.u[l] + dlv[j] * e.v[l]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        du[j] = r.s[0] * r.C[0][j] * dlu[0] + r.s[1] * r.C[1][j] * dlu[1] +
                r.s[2] * r.C[2][j] * dlu[2];
        dv[j] = r.s[0] * r.C[0][j] * dlv[0] + r.s[1] * r.C[1][j] * dlv[1] +
                r.s[2] * r.C[2][j] * dlv[2];
      }
      const float w = r.qn[0], x = r.qn[1], y = r.qn[2], z = r.qn[3];
      const float dqn[4] = {
          2.0f * (z * dC[0][1] - y * dC[0][2] - z * dC[1][0] + x * dC[1][2] + y * dC[2][0] -
                  x * dC[2][1]),
          2.0f * (y * dC[0][1] + z * dC[0][2] + y * dC[1][0] - 2.0f * x * dC[1][1] +
                  w * dC[1][2] + z * dC[2][0] - w * dC[2][1] - 2.0f * x * dC[2][2]),
          2.0f * (-2.0f * y * dC[0][0] + x * dC[0][1] - w * dC[0][2] + x * dC[1][0] +
                  z * dC[1][2] + w * dC[2][0] + z * dC[2][1] - 2.0f * y * dC[2][2]),
          2.0f * (-2.0f * z * dC[0][0] + w * dC[0][1] + x * dC[0][2] - w * dC[1][0] -
                  2.0f * z * dC[1][1] + y * dC[1][2] + x * dC[2][0] + y * dC[2][1])};
      // qn = q / nq:  dq = dqn / nq - q (dqn . q) / nq^3
      const float proj = (dqn[0] * r.q[0] + dqn[1] * r.q[1] + dqn[2] * r.q[2] +
                          dqn[3] * r.q[3]) / (r.nq * r.nq * r.nq);
#pragma unroll
      for (int j = 0; j < 4; ++j) dq[j] = dqn[j] / r.nq - r.q[j] * proj;
    }

    // JW's rows (ewa_rows), back to the view point t.
    const float da1 = du[0] * cam[0] + du[1] * cam[1] + du[2] * cam[2];
    const float db1 = du[0] * cam[8] + du[1] * cam[9] + du[2] * cam[10];
    const float da2 = dv[0] * cam[4] + dv[1] * cam[5] + dv[2] * cam[6];
    const float db2 = dv[0] * cam[8] + dv[1] * cam[9] + dv[2] * cam[10];
    const float iz2 = e.inv_z * e.inv_z;
    const float dinv_z = f.fx * da1 + f.fy * da2 + 2.0f * db1 * -f.fx * e.tx * e.inv_z +
                         2.0f * db2 * -f.fy * e.ty * e.inv_z;
    const float dtx = -f.fx * db1 * iz2;
    const float dty = -f.fy * db2 * iz2;
    float dtz = -dinv_z * iz2 + dtx * e.cl0 + dty * e.cl1;
    const float dr0 = e.r0 >= -f.limx && e.r0 <= f.limx ? dtx * e.tz : 0.0f;
    const float dr1 = e.r1 >= -f.limy && e.r1 <= f.limy ? dty * e.tz : 0.0f;
    dtz -= (dr0 * e.r0 + dr1 * e.r1) / e.tz;
    const float dt[3] = {dr0 / e.tz, dr1 / e.tz, (e.in_front ? dtz : 0.0f) + gd};

    // The clip transform: means2d = ((ndc + 1) * size - 1) / 2.
    const Clip p = clip_point(cam, m0, m1, m2);
    const float dndc0 = gm0 * (0.5f * f.width), dndc1 = gm1 * (0.5f * f.height);
    const float dph0 = dndc0 * p.rw, dph1 = dndc1 * p.rw;
    const float drw = dndc0 * p.ph0 + dndc1 * p.ph1;
    const float dpw = p.pw_ok ? -drw * p.rw * p.rw : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dm[k] += dt[0] * cam[k] + dt[1] * cam[4 + k] + dt[2] * cam[8 + k] +
               dph0 * cam[16 + k] + dph1 * cam[20 + k] + dpw * cam[28 + k];
    }

    const bool valid = e.in_front && det_ok && (in.alive == nullptr || in.alive[i]);
    if (d.means != nullptr)
      for (int k = 0; k < 3; ++k) d.means[3ll * i + k] = dm[k];
    if (d.opac != nullptr) d.opac[i] = valid ? gop : 0.0f;
    if (in.cov6 != nullptr) {
      if (d.cov6 != nullptr)
        for (int k = 0; k < 6; ++k) d.cov6[6ll * i + k] = dcv[k];
    } else {
      if (d.scales != nullptr)
        for (int k = 0; k < 3; ++k) d.scales[3ll * i + k] = ds[k];
      if (d.quats != nullptr)
        for (int k = 0; k < 4; ++k) d.quats[4ll * i + k] = dq[k];
    }
  }

  if constexpr (K > 0) {
    if (d.sh != nullptr) {
      __syncthreads();
      stage_out<K>(d.sh + 3ll * K * r0, rows, nrows, f.vec, flags);
    }
  }
}

template <int K>
cudaError_t launch_fwd(const Inputs& in, const Frame& f, const Outputs& out, cudaStream_t s) {
  const int blocks = (f.n + THREADS - 1) / THREADS;
  const size_t smem = (CAM_FLOATS + (K > 0 ? THREADS * row_stride<K>() : 0)) * sizeof(float);
  project_fwd<K><<<blocks, THREADS, smem, s>>>(in, f, out);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_bwd(const Inputs& in, const Frame& f, const Cotangents& g, const Grads& d,
                       cudaStream_t s) {
  const int blocks = (f.n + THREADS - 1) / THREADS;
  const size_t smem =
      (CAM_FLOATS + THREADS / 4 + (K > 0 ? THREADS * row_stride<K>() : 0)) * sizeof(float);
  project_bwd<K><<<blocks, THREADS, smem, s>>>(in, f, g, d);
  return cudaGetLastError();
}

// Whether p may be read and written as float4 (null: no constraint).
bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

Frame make_frame(int n, int deg, bool vec, int width, int height, float fx, float fy,
                 float limx, float limy, float scale_mod) {
  Frame f;
  f.n = n;
  f.deg = deg;
  f.ncoef = (deg + 1) * (deg + 1);
  f.vec = vec;
  f.width = static_cast<float>(width);
  f.height = static_cast<float>(height);
  f.fx = fx;
  f.fy = fy;
  f.limx = limx;
  f.limy = limy;
  f.scale_mod = scale_mod;
  return f;
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers but the stream are device pointers; sh, cov6, alive and
// offset may be null (no SH colour: colors is then null too). k is the SH
// coefficients held a Gaussian (0, 1, 4, 9, 16 or 25), deg the active
// degree ((deg + 1)^2 <= k). fx, fy, limx, limy are the focal lengths and
// the 1.3 tan FOV clamp, in float32 as torch rounds them. Returns a
// cudaError_t.
int sgt_project_fwd(const void* means, const void* scales, const void* quats,
                    const void* opac, const void* sh, const void* cov6, const void* alive,
                    const void* offset, const void* world_view, const void* full_proj,
                    const void* cam_center, int n, int k, int deg, int width, int height,
                    float fx, float fy, float limx, float limy, float scale_mod,
                    void* means2d, void* depths, void* conics, void* opac_out, void* colors,
                    void* radii, void* radii_xy, void* cull, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k > 0 && (deg < 0 || (deg + 1) * (deg + 1) > k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const float*>(means), static_cast<const float*>(scales),
                  static_cast<const float*>(quats), static_cast<const float*>(opac),
                  static_cast<const float*>(sh), static_cast<const float*>(cov6),
                  static_cast<const uint8_t*>(alive), static_cast<const float*>(offset),
                  static_cast<const float*>(world_view), static_cast<const float*>(full_proj),
                  static_cast<const float*>(cam_center)};
  const Outputs out{static_cast<float*>(means2d), static_cast<float*>(depths),
                    static_cast<float*>(conics), static_cast<float*>(opac_out),
                    static_cast<float*>(colors), static_cast<int*>(radii),
                    static_cast<int*>(radii_xy), static_cast<float*>(cull)};
  const Frame f = make_frame(n, deg, aligned(sh), width, height, fx, fy, limx, limy,
                             scale_mod);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (k) {
    case 0: e = launch_fwd<0>(in, f, out, s); break;
    case 1: e = launch_fwd<1>(in, f, out, s); break;
    case 4: e = launch_fwd<4>(in, f, out, s); break;
    case 9: e = launch_fwd<9>(in, f, out, s); break;
    case 16: e = launch_fwd<16>(in, f, out, s); break;
    case 25: e = launch_fwd<25>(in, f, out, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// The backward. Each cotangent is a pointer and a row stride in elements
// (its last dimension contiguous); a null pointer is a zero cotangent.
// Each gradient pointer may be null (not wanted); d_sh has k coefficients a
// row, d_cov6 is written only with cov6, d_scales / d_quats only without.
int sgt_project_bwd(const void* means, const void* scales, const void* quats, const void* sh,
                    const void* cov6, const void* alive, const void* world_view,
                    const void* full_proj, const void* cam_center, int n, int k, int deg,
                    int width, int height, float fx, float fy, float limx, float limy,
                    float scale_mod, const void* g_means2d, long long s_means2d,
                    const void* g_depths, long long s_depths, const void* g_conics,
                    long long s_conics, const void* g_opac, long long s_opac,
                    const void* g_colors, long long s_colors, void* d_means, void* d_scales,
                    void* d_quats, void* d_opac, void* d_sh, void* d_cov6, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k > 0 && (deg < 0 || (deg + 1) * (deg + 1) > k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const float*>(means), static_cast<const float*>(scales),
                  static_cast<const float*>(quats), nullptr,
                  static_cast<const float*>(sh), static_cast<const float*>(cov6),
                  static_cast<const uint8_t*>(alive), nullptr,
                  static_cast<const float*>(world_view), static_cast<const float*>(full_proj),
                  static_cast<const float*>(cam_center)};
  const Cotangents g{{static_cast<const float*>(g_means2d), s_means2d},
                     {static_cast<const float*>(g_depths), s_depths},
                     {static_cast<const float*>(g_conics), s_conics},
                     {static_cast<const float*>(g_opac), s_opac},
                     {static_cast<const float*>(g_colors), s_colors}};
  const Grads d{static_cast<float*>(d_means), static_cast<float*>(d_scales),
                static_cast<float*>(d_quats), static_cast<float*>(d_opac),
                static_cast<float*>(d_sh), static_cast<float*>(d_cov6)};
  const Frame f = make_frame(n, deg, aligned(sh) && aligned(d_sh), width, height, fx, fy,
                             limx, limy, scale_mod);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (k) {
    case 0: e = launch_bwd<0>(in, f, g, d, s); break;
    case 1: e = launch_bwd<1>(in, f, g, d, s); break;
    case 4: e = launch_bwd<4>(in, f, g, d, s); break;
    case 9: e = launch_bwd<9>(in, f, g, d, s); break;
    case 16: e = launch_bwd<16>(in, f, g, d, s); break;
    case 25: e = launch_bwd<25>(in, f, g, d, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
