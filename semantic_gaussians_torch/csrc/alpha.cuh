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
#pragma once

#include <cuda_runtime.h>

namespace sgt {

constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float MAX_ALPHA = 0.99f;
constexpr int GEOM = 8;  // geometry row: mx, my, ca, cb, cc, op, depth, pad

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

// Tile-centred coordinates of a tile's pixel centroid (tox, toy) and of a
// pixel inside the tile (lx, ly).
__device__ __forceinline__ void tile_frame(int t, int pix, int grid_w, int tile_w,
                                           int tile_h, float* tox, float* toy,
                                           float* lx, float* ly) {
  const int tyi = t / grid_w, txi = t % grid_w;
  *tox = __fadd_rn((float)(txi * tile_w), 0.5f * (float)(tile_w - 1));
  *toy = __fadd_rn((float)(tyi * tile_h), 0.5f * (float)(tile_h - 1));
  *lx = __fsub_rn((float)(pix % tile_w), 0.5f * (float)(tile_w - 1));
  *ly = __fsub_rn((float)(pix / tile_w), 0.5f * (float)(tile_h - 1));
}

}  // namespace sgt
