// Tiled alpha compositing, backward: per-pair gradient rows.
//
// Replaces the TPU kernel
// semantic_gaussians_tpu/ops/composite_pallas.py::_bwd_kernel (run by
// _bwd_pallas from composite_pairs' VJP).
//
// For every pair slot j of a tile (0-based index in the tile's range) the
// kernel writes one row of D = 6 + C floats at out[start + j]:
//   dmean_x, dmean_y, dconic_a, dconic_b, dconic_c, dopacity, dcolor[C].
// Each pair slot belongs to exactly one tile, so every row has one writer:
// no atomics, and two runs give the same bits. Slots past the block's last
// contributor are written as zeros; slots outside every tile range are not
// written (the caller masks them by gen_live).
//
// Per pixel, walking its pairs back to front from n_contrib (the forward's
// 1-based index of the last contributor), as composite_pallas.py:563-654:
//   contribute = candidate && j < n_contrib   (the terminating pair and
//                everything after it are excluded)
//   T_j = T_{j+1} / (1 - alpha_j)             (division, not log space:
//                division keeps T exact to rounding, log/exp does not)
//   w = alpha T_j,  q = sum_c color_c ghat_c,  u = sum_{later} w q
//   dalpha = T_j q - u / (1 - alpha) - T_final (bg . ghat) / (1 - alpha)
//   dL/dpower = op g dalpha   (the 0.99 clamp is ignored, as in the CUDA
//                reference backward and the JAX kernel)
// and the pair's row is the direct sum over the tile's pixels of
//   dmx = -(ca ex + cb ey), dmy = -(cc ey + cb ex) with ex = sum dLdp dx,
//   ey = sum dLdp dy; dca = -0.5 sum dLdp dx^2, dcb = -sum dLdp dx dy,
//   dcc = -0.5 sum dLdp dy^2; dop = sum g dalpha; dcolor_c = sum w ghat_c.
// alpha comes from alpha.cuh, the forward kernel's own code, so both take
// the same candidate decisions.
//
// Grid and passes: one block per tile, one thread per pixel (tile_w *
// tile_h <= 512, a multiple of 32). The block walks its range from the
// block-wide largest n_contrib down, in batches staged in shared memory
// (geometry rows gathered through the sorted pair ids, as the forward).
// Each pair's per-pixel terms are summed over the tile in a fixed order:
// a warp shuffle tree, then the warps' partials in warp order.
//  - C <= 8: one pass. Each thread holds its pixel's ghat (4 or 8 channels)
//    in registers, so q, the geometry terms and dcolor come from one walk.
//  - C > 8: two kernels. The geometry pass forms q by looping over the C
//    channels (colours broadcast from L1/L2, ghat coalesced); the colour
//    pass runs one block per (tile, block of 32 channels) with that slice
//    of ghat in registers, recomputes alpha and T, and writes dcolor.
// The row buffer is [P, 6 + C] floats over the pair budget: ~3.8 GB at
// C = 768 and 1,228,800 slots, which fits the card's 80 GB; sizing it to
// the pairs actually in tile ranges (a host sync) is later work.
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores, ~18 ops
// per (pixel, pair) alpha up to each pixel's n_contrib and ~20 + 4 C per
// contributing one (q, dalpha, six reduction terms, dcolor), plus the
// per-pair reduction over 512 pixels. Warps with no contributing lane skip
// their shuffles.
//
// Rounding: the library is built with -fmad=false (like the forward, so
// expf and the alpha chain compile identically); products that may fuse
// are written as explicit fmaf. Nothing here is compared bit for bit with
// the plain version: rows agree at rtol 1e-4.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using sgt::GEOM;
constexpr int MAX_WARPS = 16;
constexpr int NGEO = 6;  // ex, ey, sxx, sxy, syy, sum g dalpha

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the warp's sum
}

// GEO: geometry columns 0..5 (needs q over all C channels).
// COL: colour columns 6 + c0 .. 6 + c0 + CB of this block's channel slice.
// GEO && COL requires C <= CB (one block per tile, ghat in registers).
template <int CB, bool GEO, bool COL>
__global__ void __launch_bounds__(512) composite_bwd_kernel(
    const float* __restrict__ geom,             // [N, 8]
    const float* __restrict__ colors,           // [N, C]
    const int32_t* __restrict__ pair_gaussian,  // [P] tile-sorted ids
    const int32_t* __restrict__ tile_start,     // [T]
    const int32_t* __restrict__ tile_count,     // [T]
    const float* __restrict__ bg,               // [C]
    const float* __restrict__ g_color,          // [T, C, PX] upstream grad
    const float* __restrict__ final_t,          // [T, PX]
    const int32_t* __restrict__ n_contrib,      // [T, PX]
    int C, int grid_w, int tile_w, int tile_h,
    float* __restrict__ out) {                  // [P, 6 + C]
  constexpr int NV = (GEO ? NGEO : 0) + (COL ? CB : 0);
  constexpr int BATCH = NV <= 16 ? 32 : 16;
  constexpr int SC = GEO && COL ? CB : 1;
  __shared__ float4 s_g0[BATCH];  // mx, my, ca, cb
  __shared__ float4 s_g1[BATCH];  // cc, op, depth, pad
  __shared__ int32_t s_id[BATCH];
  __shared__ float s_col[BATCH][SC];  // colours, for q in the one-pass case
  __shared__ float s_red[BATCH][NV][MAX_WARPS];
  __shared__ int s_max;

  const int t = blockIdx.x;
  const int c0 = blockIdx.y * CB;
  const int nc = COL ? min(CB, C - c0) : 0;
  const int px = blockDim.x;
  const int pix = threadIdx.x;
  const int warp = pix >> 5, lane = pix & 31, nwarps = px >> 5;
  const int D = 6 + C;
  const int col_lo = GEO ? 0 : 6 + c0;
  const int ncols = (GEO ? NGEO : 0) + nc;
  float tox, toy, lx, ly;
  sgt::tile_frame(t, pix, grid_w, tile_w, tile_h, &tox, &toy, &lx, &ly);

  const int start = tile_start[t];
  const int count = tile_count[t];
  const size_t tp = (size_t)t * px + pix;
  const float t_final = final_t[tp];
  const int last = n_contrib[tp];

  float gh[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    gh[c] = (COL && c < nc) ? g_color[((size_t)t * C + c0 + c) * px + pix] : 0.0f;
  }
  float bgdot = 0.0f;
  if constexpr (GEO) {
    for (int c = 0; c < C; ++c) {
      bgdot = fmaf(bg[c], g_color[((size_t)t * C + c) * px + pix], bgdot);
    }
  }

  if (pix == 0) s_max = 0;
  __syncthreads();
  atomicMax(&s_max, last);
  __syncthreads();
  const int max_last = min(s_max, count);

  // Slots after every pixel's last contributor hold no gradient.
  for (int k = pix; k < (count - max_last) * ncols; k += px) {
    out[(size_t)(start + max_last + k / ncols) * D + col_lo + k % ncols] = 0.0f;
  }

  float T = t_final;
  float s = 0.0f;  // sum of w q over the pixel's later contributors
  for (int end = max_last; end > 0; end -= BATCH) {
    const int b0 = max(0, end - BATCH);
    const int nb = end - b0;
    __syncthreads();  // the previous batch's rows are written
    for (int k = pix; k < nb; k += px) {
      const int g = pair_gaussian[start + b0 + k];
      const float4* row = reinterpret_cast<const float4*>(geom + (size_t)g * GEOM);
      s_id[k] = g;
      s_g0[k] = row[0];
      s_g1[k] = row[1];
    }
    if constexpr (GEO && COL) {
      __syncthreads();
      for (int k = pix; k < nb * SC; k += px) {
        const int i = k / SC, c = k % SC;
        s_col[i][c] = c < C ? colors[(size_t)s_id[i] * C + c] : 0.0f;
      }
    }
    __syncthreads();
    for (int i = nb - 1; i >= 0; --i) {
      float v[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k] = 0.0f;
      bool hit = false;
      if (b0 + i < last) {
        const float4 g0 = s_g0[i], g1 = s_g1[i];
        const sgt::Alpha a = sgt::alpha_terms(g0, g1, tox, toy, lx, ly);
        if (a.candidate) {
          hit = true;
          const float om = __fsub_rn(1.0f, a.alpha);
          T = __fdiv_rn(T, om);  // transmittance before this pair
          const float w = __fmul_rn(a.alpha, T);
          if constexpr (GEO) {
            float q = 0.0f;
            if constexpr (COL) {
#pragma unroll
              for (int c = 0; c < CB; ++c) q = fmaf(s_col[i][c], gh[c], q);
            } else {
              const float* col = colors + (size_t)s_id[i] * C;
              for (int c = 0; c < C; ++c) {
                q = fmaf(col[c], g_color[((size_t)t * C + c) * px + pix], q);
              }
            }
            const float inv = __fdiv_rn(1.0f, om);
            const float dalpha = __fmul_rn(T, q) - __fmul_rn(s, inv) -
                                 __fmul_rn(__fmul_rn(t_final, bgdot), inv);
            s = fmaf(w, q, s);
            const float gd = __fmul_rn(a.g, dalpha);
            const float dldp = __fmul_rn(g1.y, gd);
            const float t1 = __fmul_rn(dldp, a.dx);
            const float t2 = __fmul_rn(dldp, a.dy);
            v[0] = t1;
            v[1] = t2;
            v[2] = __fmul_rn(t1, a.dx);
            v[3] = __fmul_rn(t1, a.dy);
            v[4] = __fmul_rn(t2, a.dy);
            v[5] = gd;
          }
          if constexpr (COL) {
#pragma unroll
            for (int c = 0; c < CB; ++c) v[(GEO ? NGEO : 0) + c] = __fmul_rn(w, gh[c]);
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const float r = warp_sum(v[k]);
          if (lane == 0) s_red[i][k][warp] = r;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) s_red[i][k][warp] = 0.0f;
      }
    }
    __syncthreads();
    // The warps' partials, summed in warp order.
    for (int k = pix; k < nb * NV; k += px) {
      const int i = k / NV, m = k % NV;
      float r = 0.0f;
      for (int wi = 0; wi < nwarps; ++wi) r += s_red[i][m][wi];
      s_red[i][m][0] = r;
    }
    __syncthreads();
    for (int k = pix; k < nb * ncols; k += px) {
      const int i = k / ncols, m = k % ncols;
      float val;
      if (GEO && m < NGEO) {
        const float ex = s_red[i][0][0], ey = s_red[i][1][0];
        const float ca = s_g0[i].z, cb = s_g0[i].w, cc = s_g1[i].x;
        switch (m) {
          case 0: val = -(__fmul_rn(ca, ex) + __fmul_rn(cb, ey)); break;
          case 1: val = -(__fmul_rn(cc, ey) + __fmul_rn(cb, ex)); break;
          case 2: val = -0.5f * s_red[i][2][0]; break;
          case 3: val = -s_red[i][3][0]; break;
          case 4: val = -0.5f * s_red[i][4][0]; break;
          default: val = s_red[i][5][0]; break;
        }
      } else {
        val = s_red[i][m][0];
      }
      out[(size_t)(start + b0 + i) * D + col_lo + m] = val;
    }
  }
}

template <int CB, bool GEO, bool COL>
cudaError_t launch(dim3 grid, int threads, const float* geom, const float* colors,
                   const int32_t* pg, const int32_t* ts, const int32_t* tc,
                   const float* bg, const float* g_color, const float* final_t,
                   const int32_t* n_contrib, int C, int grid_w, int tile_w,
                   int tile_h, float* out, cudaStream_t stream) {
  composite_bwd_kernel<CB, GEO, COL><<<grid, threads, 0, stream>>>(
      geom, colors, pg, ts, tc, bg, g_color, final_t, n_contrib, C, grid_w,
      tile_w, tile_h, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers. tile_w * tile_h must be a multiple of
// 32 and at most 512 (checked by the caller). *launched (a host pointer)
// receives the number of kernels launched: 0, 1, or 2 for C > 8. Returns a
// cudaError_t.
int sgt_composite_bwd(const void* geom, const void* colors,
                      const void* pair_gaussian, const void* tile_start,
                      const void* tile_count, const void* bg,
                      const void* g_color, const void* final_t,
                      const void* n_contrib, int C, int num_tiles, int grid_w,
                      int tile_w, int tile_h, void* out, void* stream,
                      int* launched) {
  *launched = 0;
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  auto g = static_cast<const float*>(geom);
  auto col = static_cast<const float*>(colors);
  auto pg = static_cast<const int32_t*>(pair_gaussian);
  auto ts = static_cast<const int32_t*>(tile_start);
  auto tc = static_cast<const int32_t*>(tile_count);
  auto b = static_cast<const float*>(bg);
  auto gc = static_cast<const float*>(g_color);
  auto ft = static_cast<const float*>(final_t);
  auto nct = static_cast<const int32_t*>(n_contrib);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = tile_w * tile_h;
  cudaError_t e;
  if (C <= 4) {
    e = launch<4, true, true>(dim3(num_tiles), threads, g, col, pg, ts, tc, b, gc, ft,
                              nct, C, grid_w, tile_w, tile_h, o, s);
    *launched = e == cudaSuccess;
  } else if (C <= 8) {
    e = launch<8, true, true>(dim3(num_tiles), threads, g, col, pg, ts, tc, b, gc, ft,
                              nct, C, grid_w, tile_w, tile_h, o, s);
    *launched = e == cudaSuccess;
  } else {
    e = launch<32, true, false>(dim3(num_tiles), threads, g, col, pg, ts, tc, b, gc,
                                ft, nct, C, grid_w, tile_w, tile_h, o, s);
    if (e == cudaSuccess) {
      *launched = 1;
      e = launch<32, false, true>(dim3(num_tiles, (C + 31) / 32), threads, g, col, pg,
                                  ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
      *launched += e == cudaSuccess;
    }
  }
  return static_cast<int>(e);
}

}  // extern "C"
