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
//   T_j = T_{j+1} * (1 / (1 - alpha_j))       (a reciprocal, not log space:
//                it keeps T to two roundings a step, log/exp does not;
//                the plain version takes the same two steps)
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
// Design. One block per tile; each thread owns PPT pixels (4 where the
// tile's pixel count is a multiple of 128: 128 threads for a 16 x 32 tile),
// pixel k of thread i being k * threads + i, so that slot k of a warp is 32
// pixels of one tile row. The block walks its range from the block-wide
// largest n_contrib down, in batches of up to 64 pairs:
//  - each pair of a batch carries `candidate_rows` (alpha.cuh), computed
//    once per (tile, pair) when it is staged. A warp evaluates alpha for
//    slot k only if that slot's row may hold a candidate and some lane's
//    n_contrib lies past the pair: a skipped event is provably no
//    candidate, so T, the sums and the row are unchanged bit for bit;
//  - a thread sums its pixels' terms in registers, and the warp sums the NV
//    values (9 at C = 3: six geometry sums and exactly C colour sums) with
//    a transposing butterfly: at each of the 5 shuffle distances a lane
//    keeps half of its values and trades the other half, so NV values cross
//    the warp in ~NV + 3 shuffles (12 at NV = 9) instead of 5 NV. The warps'
//    partials land in shared memory and are summed in warp order when the
//    batch's rows are written: a fixed order, so the bits repeat;
//  - the next batch's pair ids, geometry and colours are loaded into
//    registers before the current batch is walked and stored (with their
//    row masks) after it, behind the one barrier each batch has; rows of
//    batch k are written during batch k + 1 (double-buffered partials,
//    triple-buffered geometry).
// Passes by width:
//  - C <= 8: one pass, ghat of exactly CB in {1, 3, 4, 8} channels per
//    pixel in registers, so q, the geometry terms and dcolor come from one
//    walk.
//  - C > 8: two kernels. The geometry pass (one pixel a thread) forms q by
//    looping over the C channels (colours broadcast from L1/L2, ghat from
//    L2, per contributing event); the colour pass runs one block per (tile, block of 32
//    channels), 2 pixels a thread, with that slice of ghat in registers,
//    recomputes alpha and T, and writes dcolor. q = colours . ghat and
//    dcolor = w . ghat are matrix products over a batch of pairs, the later
//    tensor-core work for this width.
// The row buffer is [P, 6 + C] floats over the pair budget: ~3.8 GB at
// C = 768 and 1,228,800 slots, which fits the card's 80 GB.
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores, ~18 ops
// per (pixel, pair) alpha up to each pixel's n_contrib and ~20 + 4 C per
// contributing one, plus the per-pair reduction (shuffles issue at a
// quarter of the FMA rate) and, per batch, one barrier; the heaviest tiles
// (about three times the mean pair count at the centre of the view) set the
// kernel's end.
//
// Rounding: the library is built with -fmad=false (like the forward, so
// expf and the alpha chain compile identically); products that may fuse
// are written as explicit fmaf. Nothing here is compared bit for bit with
// the plain version: rows agree at rtol 1e-4.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using sgt::FULL;
using sgt::GEOM;
constexpr int NGEO = 6;  // ex, ey, sxx, sxy, syy, sum g dalpha
constexpr int MAX_BATCH = 64;

// Pairs a batch: as many as keep one buffer of warp partials within 16 KB.
__host__ __device__ constexpr int batch_for(int nv, int warps) {
  int b = MAX_BATCH;
  while (b > 8 && b * nv * warps > 4096) b >>= 1;
  return b;
}

// Sums each of the N values of every lane over the warp's 32 lanes. At
// shuffle distance o a lane keeps the lower half of its values if bit o of
// its lane is clear, else the upper half, and receives its partner's copy
// of the half it keeps; once one value is left the lanes add it pairwise.
// Returns the lane's sum and sets *idx to the value it is (-1 for a lane
// left holding padding). Each sum is a fixed tree over the lanes.
template <int N>
__device__ __forceinline__ float transpose_sum(float (&v)[N], int lane, int* idx) {
  int base = 0, valid = N;
  int n = N;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (n > 1) {
      const int h = (n + 1) >> 1;
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < h) {
          const float lo = v[i];
          const float hi = h + i < n ? v[h + i] : 0.0f;
          const float give = up ? lo : hi;
          const float keep = up ? hi : lo;
          v[i] = keep + __shfl_xor_sync(FULL, give, o);
        }
      }
      if (up) {
        base += h;
        valid -= h;
      } else {
        valid = min(valid, h);
      }
      n = h;
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], o);
    }
  }
  *idx = valid > 0 ? base : -1;
  return v[0];
}

// GEO: geometry columns 0..5 (needs q over all C channels).
// COL: colour columns 6 + c0 .. 6 + c0 + CB of this block's channel slice.
// GEO && COL requires C <= CB (one block per tile, ghat in registers).
// PPT: pixels per thread; the block has tile_w * tile_h / PPT threads.
// One block an SM is all the bounds ask: given no minimum, ptxas held the
// C > 8 geometry pass to 64 registers, and its q loop over C channels ran
// at half the speed it has with 108.
template <int CB, bool GEO, bool COL, int PPT>
__global__ void __launch_bounds__(512 / PPT, 1) composite_bwd_kernel(
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
  constexpr int MAXW = 16 / PPT;
  constexpr int BATCH = batch_for(NV, MAXW);
  constexpr int SC = GEO && COL ? CB : 1;
  __shared__ float4 s_g0[3][BATCH];  // mx, my, ca, cb
  __shared__ float4 s_g1[3][BATCH];  // cc, op, depth, pad
  __shared__ uint32_t s_rows[3][BATCH];
  __shared__ int32_t s_id[3][BATCH];
  __shared__ float s_col[3][BATCH][SC];  // colours, for q in the one-pass case
  __shared__ float s_red[2][BATCH][NV][MAXW];
  __shared__ int s_max;

  const int t = blockIdx.x;
  const int c0 = blockIdx.y * CB;
  const int nc = COL ? min(CB, C - c0) : 0;
  const int px = tile_w * tile_h;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int D = 6 + C;
  const int col_lo = GEO ? 0 : 6 + c0;
  const int ncols = (GEO ? NGEO : 0) + nc;

  const int start = tile_start[t];
  const int count = tile_count[t];
  float tox, toy, lx[PPT], ly[PPT];
  float T[PPT], s[PPT], tb[PPT], gh[PPT][CB];
  int last[PPT], wlast[PPT];
  uint32_t wrows[PPT];
  int warp_max = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = k * nt + tid;
    sgt::tile_frame(t, pix, grid_w, tile_w, tile_h, &tox, &toy, &lx[k], &ly[k]);
    const size_t tp = (size_t)t * px + pix;
    T[k] = final_t[tp];
    s[k] = 0.0f;  // sum of w q over the pixel's later contributors
    last[k] = n_contrib[tp];
    wlast[k] = __reduce_max_sync(FULL, last[k]);
    warp_max = max(warp_max, wlast[k]);
    wrows[k] = sgt::pixel_rows(k * nt + warp * 32, 32, tile_w);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      gh[k][c] = (COL && c < nc) ? g_color[((size_t)t * C + c0 + c) * px + pix] : 0.0f;
    }
    float bgdot = 0.0f;
    if constexpr (GEO) {
      for (int c = 0; c < C; ++c) {
        bgdot = fmaf(bg[c], g_color[((size_t)t * C + c) * px + pix], bgdot);
      }
    }
    tb[k] = __fmul_rn(T[k], bgdot);
  }

  if (tid == 0) s_max = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_max, warp_max);
  __syncthreads();
  const int max_last = min(s_max, count);

  // Slots after every pixel's last contributor hold no gradient.
  for (int k = tid; k < (count - max_last) * ncols; k += nt) {
    out[(size_t)(start + max_last + k / ncols) * D + col_lo + k % ncols] = 0.0f;
  }

  // Batch b covers slots [lo(b), lo(b) + size(b)), walked from the top;
  // each thread stages at most one pair of a batch.
  const int bs = min(BATCH, nt);
  const int nbatch = (max_last + bs - 1) / bs;
  auto lo = [&](int b) { return max(0, max_last - (b + 1) * bs); };
  auto size = [&](int b) { return max_last - b * bs - lo(b); };

  // Registers that carry the next batch's pair (thread i stages pair i).
  int r_id = 0, r_next = 0;
  float4 r_g0 = make_float4(0.f, 0.f, 0.f, 0.f), r_g1 = r_g0;
  float r_col[SC];
  auto fetch = [&](int b) {  // loads of batch b's pair; r_next holds its id
    if (b < nbatch && tid < size(b)) {
      r_id = r_next;
      const float4* row = reinterpret_cast<const float4*>(geom + (size_t)r_id * GEOM);
      r_g0 = row[0];
      r_g1 = row[1];
      if constexpr (GEO && COL) {
#pragma unroll
        for (int c = 0; c < SC; ++c) r_col[c] = c < C ? colors[(size_t)r_id * C + c] : 0.0f;
      }
    }
    if (b + 1 < nbatch && tid < size(b + 1)) r_next = pair_gaussian[start + lo(b + 1) + tid];
  };
  auto store = [&](int b) {  // the fetched pair into slot b % 3
    if (b < nbatch && tid < size(b)) {
      const int sl = b % 3;
      s_g0[sl][tid] = r_g0;
      s_g1[sl][tid] = r_g1;
      s_id[sl][tid] = r_id;
      s_rows[sl][tid] = sgt::candidate_rows(r_g0, r_g1, toy, tile_h, 0, tile_h - 1);
      if constexpr (GEO && COL) {
#pragma unroll
        for (int c = 0; c < SC; ++c) s_col[sl][tid][c] = r_col[c];
      }
    }
  };
  // The warps' partials of batch b, summed in warp order, as output rows.
  auto write_rows = [&](int b) {
    const int sl = b % 3, rb = b & 1, b0 = lo(b);
    for (int e = tid; e < size(b) * ncols; e += nt) {
      const int i = e / ncols, m = e % ncols;
      auto red = [&](int v) {
        float r = 0.0f;
        for (int w = 0; w < nwarps; ++w) r += s_red[rb][i][v][w];
        return r;
      };
      float val;
      if (GEO && m < NGEO) {
        const float ca = s_g0[sl][i].z, cb = s_g0[sl][i].w, cc = s_g1[sl][i].x;
        switch (m) {
          case 0: val = -(__fmul_rn(ca, red(0)) + __fmul_rn(cb, red(1))); break;
          case 1: val = -(__fmul_rn(cc, red(1)) + __fmul_rn(cb, red(0))); break;
          case 2: val = -0.5f * red(2); break;
          case 3: val = -red(3); break;
          case 4: val = -0.5f * red(4); break;
          default: val = red(5); break;
        }
      } else {
        val = red(m);
      }
      out[(size_t)(start + b0 + i) * D + col_lo + m] = val;
    }
  };

  if (nbatch > 0 && tid < size(0)) r_next = pair_gaussian[start + lo(0) + tid];
  fetch(0);
  store(0);
  for (int b = 0; b < nbatch; ++b) {
    __syncthreads();  // batch b staged; partials of b - 1 complete
    if (b > 0) write_rows(b - 1);
    fetch(b + 1);
    const int sl = b % 3, rb = b & 1, b0 = lo(b);
    for (int i = size(b) - 1; i >= 0; --i) {
      const int j = b0 + i;
      const uint32_t rows = s_rows[sl][i];
      float v[NV];
#pragma unroll
      for (int m = 0; m < NV; ++m) v[m] = 0.0f;
      bool hit = false;
      bool live[PPT], any = false;  // warp-uniform
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        live[k] = (rows & wrows[k]) != 0u && j < wlast[k];
        any |= live[k];
      }
      if (any) {
        const float4 g0 = s_g0[sl][i], g1 = s_g1[sl][i];
        sgt::Alpha a[PPT];  // independent of T: all slots at once
#pragma unroll
        for (int k = 0; k < PPT; ++k) a[k] = sgt::alpha_terms(g0, g1, tox, toy, lx[k], ly[k]);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!(live[k] && a[k].candidate && j < last[k])) continue;
          hit = true;
          const float inv = __frcp_rn(__fsub_rn(1.0f, a[k].alpha));
          T[k] = __fmul_rn(T[k], inv);  // transmittance before this pair
          const float w = __fmul_rn(a[k].alpha, T[k]);
          if constexpr (GEO) {
            float q = 0.0f;
            if constexpr (COL) {
#pragma unroll
              for (int c = 0; c < CB; ++c) q = fmaf(s_col[sl][i][c], gh[k][c], q);
            } else {
              const float* col = colors + (size_t)s_id[sl][i] * C;
              const float* gc = g_color + (size_t)t * C * px + k * nt + tid;
              for (int c = 0; c < C; ++c) q = fmaf(col[c], gc[(size_t)c * px], q);
            }
            const float dalpha = __fmul_rn(T[k], q) - __fmul_rn(s[k], inv) -
                                 __fmul_rn(tb[k], inv);
            s[k] = fmaf(w, q, s[k]);
            const float gd = __fmul_rn(a[k].g, dalpha);
            const float dldp = __fmul_rn(g1.y, gd);
            const float t1 = __fmul_rn(dldp, a[k].dx);
            const float t2 = __fmul_rn(dldp, a[k].dy);
            v[0] += t1;
            v[1] += t2;
            v[2] += __fmul_rn(t1, a[k].dx);
            v[3] += __fmul_rn(t1, a[k].dy);
            v[4] += __fmul_rn(t2, a[k].dy);
            v[5] += gd;
          }
          if constexpr (COL) {
#pragma unroll
            for (int c = 0; c < CB; ++c) v[(GEO ? NGEO : 0) + c] += __fmul_rn(w, gh[k][c]);
          }
        }
      }
      if (__any_sync(FULL, hit)) {
        int idx;
        const float r = transpose_sum<NV>(v, lane, &idx);
        if (idx >= 0) s_red[rb][i][idx][warp] = r;
      } else if (lane < NV) {
        s_red[rb][i][lane][warp] = 0.0f;
      }
    }
    store(b + 1);
  }
  __syncthreads();
  if (nbatch > 0) write_rows(nbatch - 1);
}

template <int CB, bool GEO, bool COL, int PPT>
cudaError_t launch(dim3 grid, int px, const float* geom, const float* colors,
                   const int32_t* pg, const int32_t* ts, const int32_t* tc,
                   const float* bg, const float* g_color, const float* final_t,
                   const int32_t* n_contrib, int C, int grid_w, int tile_w,
                   int tile_h, float* out, cudaStream_t stream) {
  composite_bwd_kernel<CB, GEO, COL, PPT><<<grid, px / PPT, 0, stream>>>(
      geom, colors, pg, ts, tc, bg, g_color, final_t, n_contrib, C, grid_w,
      tile_w, tile_h, out);
  return cudaGetLastError();
}

// The one-pass kernel for C <= 8, sized to C (no padding channel at C = 3).
template <int PPT>
cudaError_t launch_one_pass(int num_tiles, int px, const float* g, const float* col,
                            const int32_t* pg, const int32_t* ts, const int32_t* tc,
                            const float* b, const float* gc, const float* ft,
                            const int32_t* nct, int C, int grid_w, int tile_w, int tile_h,
                            float* o, cudaStream_t s) {
  const dim3 grid(num_tiles);
  if (C <= 1) return launch<1, true, true, PPT>(grid, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
  if (C <= 3) return launch<3, true, true, PPT>(grid, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
  if (C <= 4) return launch<4, true, true, PPT>(grid, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
  return launch<8, true, true, PPT>(grid, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
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
  const int px = tile_w * tile_h;
  cudaError_t e;
  if (C <= 8) {
    e = px % 128 == 0
            ? launch_one_pass<4>(num_tiles, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s)
            : launch_one_pass<1>(num_tiles, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
    *launched = e == cudaSuccess;
    return static_cast<int>(e);
  }
  const dim3 tiles(num_tiles), slices(num_tiles, (C + 31) / 32);
  // One pixel a thread: the q loop over C channels is a long chain, which
  // sixteen warps a tile hide better than four.
  e = launch<1, true, false, 1>(tiles, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  e = px % 64 == 0
          ? launch<32, false, true, 2>(slices, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s)
          : launch<32, false, true, 1>(slices, px, g, col, pg, ts, tc, b, gc, ft, nct, C, grid_w, tile_w, tile_h, o, s);
  *launched += e == cudaSuccess;
  return static_cast<int>(e);
}

}  // extern "C"
