// Tiled front-to-back alpha compositing, forward.
//
// Replaces the TPU kernel
// semantic_gaussians_tpu/ops/composite_pallas.py::_fwd_kernel (run by
// _fwd_pallas / composite_pairs, called from ops/rasterize.py::rasterize).
//
// Per tile (default 16 x 32 px), walking the tile's depth-sorted pairs:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy   (tile-centred dx, dy)
//   alpha = min(0.99, op * exp(min(power, 0)))
//   skip a pair when power > 0 or alpha < 1/255
//   stop when T (1 - alpha) < 1e-4, that pair excluded
//   out = sum w color + T bg, w = alpha T
//   median depth at the T = 0.5 crossing (init 15.0), final_T, and the
//   1-based index of the last contributor in the tile range (n_contrib).
//
// Grid: one block per (tile, channel block of CB channels: 4 for C <= 4,
// 8 for C <= 8, else 32); one thread per pixel, so no thread holds a
// C[768] array. Pairs are staged in shared
// memory in batches of BATCH: the Gaussian id, its geometry row (mean,
// conic, opacity, depth) and this block's channel slice of its colour.
// Geometry and colours are gathered from the per-Gaussian arrays through
// the sorted pair ids (the renderCUDA pattern), so no packed per-pair
// [D, P] buffer is written or read: at C = 768 that buffer would be
// ~3.7 GB per render. The block leaves early once every pixel has hit its
// termination event (__syncthreads_count), as the TPU kernel's all-done
// vote does.
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores, ~18 ops
// for each (pixel, pair) whose alpha is evaluated and 2 C more for each
// one that contributes colour; the colour gather (C floats per pair, read
// once per tile) stays in L2. Each channel block recomputes alpha, so at
// C = 768 the alpha work is done 24 times; sharing it across channel
// blocks (or wgmma for the colour sum) is later work.
//
// Numerics: the sequential per-pixel order and the JAX kernel's op order
// (`_alpha_terms`, composite_pallas.py:206-232, in alpha.cuh, which the
// backward kernel shares; the contribute / terminate / median rules at
// :330-375). The alpha / T / median chain uses the
// round-to-nearest intrinsics (and the library is built with -fmad=false),
// so every decision that feeds n_contrib rounds as the plain torch
// version's separate ops do; expf is the only difference there. The colour
// sum, the 2 C term that dominates at wide C, is an explicit fmaf: one FFMA
// per channel instead of a rounded multiply and add, within rtol 1e-5 of
// the plain version's contraction.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using sgt::GEOM;
using sgt::T_EPS;
constexpr int BATCH = 256;
constexpr float MEDIAN_DEPTH_INIT = 15.0f;

template <int CB>
__global__ void __launch_bounds__(512) composite_fwd_kernel(
    const float* __restrict__ geom,         // [N, 8]
    const float* __restrict__ colors,       // [N, C]
    const int32_t* __restrict__ pair_gaussian,  // [P] tile-sorted ids
    const int32_t* __restrict__ tile_start,     // [T]
    const int32_t* __restrict__ tile_count,     // [T]
    const float* __restrict__ bg,               // [C]
    int C, int grid_w, int tile_w, int tile_h,
    float* __restrict__ out_color,    // [T, C, PX]
    float* __restrict__ out_depth,    // [T, PX]
    float* __restrict__ out_t,        // [T, PX]
    int32_t* __restrict__ out_contrib) {  // [T, PX]
  __shared__ float4 s_g0[BATCH];  // mx, my, ca, cb
  __shared__ float4 s_g1[BATCH];  // cc, op, depth, pad
  __shared__ int32_t s_id[BATCH];
  __shared__ float s_col[BATCH][CB];

  const int t = blockIdx.x;
  const int c0 = blockIdx.y * CB;
  const int nc = min(CB, C - c0);
  const int px = blockDim.x;
  const int pix = threadIdx.x;
  float tox, toy, lx, ly;
  sgt::tile_frame(t, pix, grid_w, tile_w, tile_h, &tox, &toy, &lx, &ly);

  const int start = tile_start[t];
  const int count = tile_count[t];

  float T = 1.0f, D = MEDIAN_DEPTH_INIT;
  int last = 0;
  int done = 0;
  float acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = 0.0f;

  for (int base = 0; base < count; base += BATCH) {
    // Barrier for the shared batch and the all-done vote in one.
    if (__syncthreads_count(done) == px) break;
    const int nb = min(BATCH, count - base);
    for (int k = pix; k < nb; k += px) {
      const int g = pair_gaussian[start + base + k];
      const float4* row = reinterpret_cast<const float4*>(geom + (size_t)g * GEOM);
      s_id[k] = g;
      s_g0[k] = row[0];
      s_g1[k] = row[1];
    }
    __syncthreads();
    for (int k = pix; k < nb * CB; k += px) {
      const int i = k / CB, c = k % CB;
      s_col[i][c] = c < nc ? colors[(size_t)s_id[i] * C + c0 + c] : 0.0f;
    }
    __syncthreads();
    if (done) continue;
    for (int i = 0; i < nb; ++i) {
      const float4 g1 = s_g1[i];
      const sgt::Alpha a = sgt::alpha_terms(s_g0[i], g1, tox, toy, lx, ly);
      if (!a.candidate) continue;
      const float alpha = a.alpha;
      const float test_t = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (test_t < T_EPS) {
        done = 1;
        break;
      }
      const float w = __fmul_rn(alpha, T);
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = fmaf(w, s_col[i][c], acc[c]);
      if (T > 0.5f && test_t < 0.5f) D = g1.z;
      T = test_t;
      last = base + i + 1;
    }
  }

  const size_t tp = (size_t)t * px + pix;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (c < nc) {
      out_color[((size_t)t * C + c0 + c) * px + pix] =
          __fadd_rn(acc[c], __fmul_rn(bg[c0 + c], T));
    }
  }
  if (blockIdx.y == 0) {
    out_depth[tp] = D;
    out_t[tp] = T;
    out_contrib[tp] = last;
  }
}

template <int CB>
cudaError_t launch(const float* geom, const float* colors,
                   const int32_t* pair_gaussian, const int32_t* tile_start,
                   const int32_t* tile_count, const float* bg, int C,
                   int num_tiles, int grid_w, int tile_w, int tile_h,
                   float* out_color, float* out_depth, float* out_t,
                   int32_t* out_contrib, cudaStream_t stream) {
  dim3 grid(num_tiles, (C + CB - 1) / CB);
  composite_fwd_kernel<CB><<<grid, tile_w * tile_h, 0, stream>>>(
      geom, colors, pair_gaussian, tile_start, tile_count, bg, C, grid_w,
      tile_w, tile_h, out_color, out_depth, out_t, out_contrib);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers. tile_w * tile_h must be a multiple of
// 32 and at most 512 (checked by the caller). Returns a cudaError_t.
int sgt_composite_fwd(const void* geom, const void* colors,
                      const void* pair_gaussian, const void* tile_start,
                      const void* tile_count, const void* bg, int C,
                      int num_tiles, int grid_w, int tile_w, int tile_h,
                      void* out_color, void* out_depth, void* out_t,
                      void* out_contrib, void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  auto g = static_cast<const float*>(geom);
  auto col = static_cast<const float*>(colors);
  auto pg = static_cast<const int32_t*>(pair_gaussian);
  auto ts = static_cast<const int32_t*>(tile_start);
  auto tc = static_cast<const int32_t*>(tile_count);
  auto b = static_cast<const float*>(bg);
  auto oc = static_cast<float*>(out_color);
  auto od = static_cast<float*>(out_depth);
  auto ot = static_cast<float*>(out_t);
  auto on = static_cast<int32_t*>(out_contrib);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (C <= 4) {
    e = launch<4>(g, col, pg, ts, tc, b, C, num_tiles, grid_w, tile_w, tile_h, oc, od, ot, on, s);
  } else if (C <= 8) {
    e = launch<8>(g, col, pg, ts, tc, b, C, num_tiles, grid_w, tile_w, tile_h, oc, od, ot, on, s);
  } else {
    e = launch<32>(g, col, pg, ts, tc, b, C, num_tiles, grid_w, tile_w, tile_h, oc, od, ot, on, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
