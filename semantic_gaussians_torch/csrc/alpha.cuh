// The per-(pixel, pair) alpha of the tiled compositor, shared by the
// forward (composite_fwd.cu) and backward (composite_bwd.cu) kernels so
// that both take the same candidate decisions: a flip at alpha ~ 1/255
// between the two would desynchronise the backward's transmittance.
//
// Semantics of semantic_gaussians_tpu/ops/composite_pallas.py::_alpha_terms:
//   dx = (mean_x - tile_centre_x) - lx,  dy likewise (tile-centred)
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy
//   g = exp(min(power, 0)),  alpha = min(0.99, op g)
//   candidate = power <= 0 && alpha >= 1/255
// Every product and sum uses the round-to-nearest intrinsics, so the chain
// rounds as the plain torch versions' separate ops do (expf is the only
// difference); both sources that include this file are built with
// -fmad=false, so expf itself is compiled the same way in both.
//
// `candidate_rows` is the test both kernels use to skip work: a bit mask of
// the tile rows in which a pair may be a candidate. A cleared bit is a
// proof, so skipping those (pixel, pair) events changes no decision and no
// bit of any output.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sgt {

constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float MAX_ALPHA = 0.99f;
constexpr int GEOM = 8;  // geometry row: mx, my, ca, cb, cc, op, depth, pad
constexpr unsigned FULL = 0xffffffffu;

struct Alpha {
  float dx, dy, power, g, alpha;
  bool candidate;
};

// g0 = (mx, my, ca, cb), g1 = (cc, op, depth, pad).
__device__ __forceinline__ Alpha alpha_terms(float4 g0, float4 g1, float tox,
                                             float toy, float lx, float ly) {
  Alpha a;
  a.dx = __fsub_rn(__fsub_rn(g0.x, tox), lx);
  a.dy = __fsub_rn(__fsub_rn(g0.y, toy), ly);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(g0.z, a.dx), a.dx),
                               __fmul_rn(__fmul_rn(g1.x, a.dy), a.dy));
  a.power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(g0.w, a.dx), a.dy));
  a.g = expf(fminf(a.power, 0.0f));
  a.alpha = fminf(MAX_ALPHA, __fmul_rn(g1.y, a.g));
  a.candidate = a.power <= 0.0f && a.alpha >= ALPHA_CUTOFF;
  return a;
}

// The tile-centred y of tile row r (ly of every pixel in that row).
__device__ __forceinline__ float row_ly(int r, int tile_h) {
  return __fsub_rn((float)r, 0.5f * (float)(tile_h - 1));
}

// Tile-centred coordinates of a tile's pixel centroid (tox, toy) and of a
// pixel inside the tile (lx, ly).
__device__ __forceinline__ void tile_frame(int t, int pix, int grid_w, int tile_w,
                                           int tile_h, float* tox, float* toy,
                                           float* lx, float* ly) {
  const int tyi = t / grid_w, txi = t % grid_w;
  *tox = __fadd_rn((float)(txi * tile_w), 0.5f * (float)(tile_w - 1));
  *toy = __fadd_rn((float)(tyi * tile_h), 0.5f * (float)(tile_h - 1));
  *lx = __fsub_rn((float)(pix % tile_w), 0.5f * (float)(tile_w - 1));
  *ly = row_ly(pix / tile_w, tile_h);
}

// Bit min(r, 31) of the mask of rows that pixels p0 .. p0 + n - 1 lie in.
__device__ __forceinline__ uint32_t pixel_rows(int p0, int n, int tile_w) {
  const int r0 = min(p0 / tile_w, 31), r1 = min((p0 + n - 1) / tile_w, 31);
  const uint32_t hi = r1 == 31 ? FULL : (2u << r1) - 1u;
  return hi & ~((1u << r0) - 1u);
}

// Rows r0 .. r1 of the tile in which this Gaussian may be a candidate (the
// others' bits are clear): bit min(r, 31) is cleared only if no pixel of
// row r can be one, as alpha_terms computes it. With s = 1 - 2^-18,
// a' = ca s, c' = cc s, det' = a' c' - cb^2 > 0:
//  * the computed power exceeds the exact quadratic form at the same (dx, dy)
//    by at most ~4 ulp of 0.5 ca dx^2 + 0.5 cc dy^2 + |cb dx dy|, which is
//    less than what replacing ca, cc by a', c' adds (the form is positive
//    definite, so |cb dx dy| <= 0.5 (ca dx^2 + cc dy^2));
//  * over all real dx the form with a', c' is at most -0.5 dy^2 det' / a';
//  * a candidate has power >= -ln(255 op) - 1e-6 (expf within 2 ulp, the
//    product and the 1/255 constant rounded).
// So row r is skipped when dy^2 det' / a' > 2 L with L = ln(255 op) +
// 1e-5 + 1e-6 |ln(255 op)| (logf is within 1 ulp), dy being computed
// exactly as alpha_terms computes it; det' and the comparison are in double,
// so the conic's cancellation costs nothing. A pair with op < 1/255 is a
// candidate nowhere (alpha <= op). Anything not finite, or a conic that is
// not positive definite, keeps every row.
__device__ __forceinline__ uint32_t candidate_rows(float4 g0, float4 g1, float toy,
                                                   int tile_h, int r0, int r1) {
  if (g1.y < ALPHA_CUTOFF) return 0u;
  const double s = 1.0 - 0x1p-18;
  const double a = (double)g0.z * s, c = (double)g1.x * s, b = g0.w;
  const double det = a * c - b * b;
  if (!(a > 0.0 && det > 0.0)) return pixel_rows(r0, r1 - r0 + 1, 1);
  const double ln = logf(255.0f * g1.y);
  const double lim = 2.0 * (ln + 1e-5 + 1e-6 * fabs(ln)) * a;  // dy^2 det above it: skip
  const float my = __fsub_rn(g0.y, toy);
  uint32_t m = 0u;
  for (int r = r0; r <= r1; ++r) {
    const double dy = __fsub_rn(my, row_ly(r, tile_h));
    if (!(dy * dy * det > lim)) m |= 1u << min(r, 31);
  }
  return m;
}

}  // namespace sgt
