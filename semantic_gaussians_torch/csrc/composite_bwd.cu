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
// Both designs take one block per tile and walk its range from the
// block-wide largest n_contrib down, in batches. Each pair of a batch carries
// `candidate_rows` (alpha.cuh), computed once per (tile, pair) when it is
// staged. A warp evaluates alpha for its pixels only if their rows may hold a
// candidate and some lane's n_contrib lies past the pair: a skipped event is
// provably no candidate, so T, the sums and the row are unchanged bit for
// bit. A thread sums its pixels' geometry terms in registers, and the warp
// sums its values with a transposing butterfly (at each of the 5 shuffle
// distances a lane keeps half of its values and trades the other half, so NV
// values cross the warp in ~NV + 3 shuffles instead of 5 NV); the warps'
// partials land in shared memory and are summed in warp order when the rows
// are written: a fixed order, so the bits repeat.
//
// By width (the C the caller passes; nothing else picks the design):
//  - C <= 8 (composite_bwd_kernel<CB, true, true, PPT>): one pass. Each
//    thread owns PPT pixels (4 where the tile's pixel count is a multiple of
//    128: 128 threads for a 16 x 32 tile), pixel k of thread i being
//    k * threads + i, with ghat of exactly CB in {1, 3, 4, 8} channels per
//    pixel in registers, so q, the geometry terms and dcolor come from one
//    walk; NV = 6 + C values a warp and pair. Batches of up to 64 pairs;
//    the next batch's ids, geometry and colours are loaded into registers
//    before the current batch is walked and stored after it, behind the one
//    barrier each batch has; rows of batch k are written during batch k + 1.
//  - C > 8 (composite_bwd_kernel_wide): one walk a tile, and the two
//    channel sums as blocked products over a batch of WB = 32 pairs on the
//    tensor cores, in 3xTF32 (mma_tf32, split: float32 accuracy from three
//    TF32 products). One thread a pixel, so warp w is strip w (pixels 32 w
//    .. 32 w + 31 of the tile), and a warp's products are mma tiles over
//    its strip. ghat ([T, C, PX]: a tile's is contiguous) and the batch's
//    colours are streamed through shared memory in chunks of WCK = 16
//    channels by cp.async, a ring of three, two chunks in flight (the next
//    batch's first two load while this one is walked). One pass over the
//    chunks serves two batches: it forms q of batch b + 1 and dcolor of
//    batch b, so ghat is read once a batch.
//      1. q before the walk: q[i, px] = sum_c colour[id_i, c] ghat[c, px],
//         M = 32 pairs, N = the strip's 32 pixels, K = the chunk's
//         channels. A chunk's tile sum starts from 0 and is added to q
//         (in registers, 32 floats a thread) in float32, chunk by chunk in
//         channel order. A strip in which no pair of the batch may be a
//         candidate before its last contributor (the `live` ballot) skips
//         it.
//      2. The walk, once: back to front as above, one pixel a thread, q
//         read from s_qw[i][px], and w = alpha T written over it (0 where
//         the pixel takes no contribution from the pair); the six
//         geometry sums per pair and strip go to s_red.
//      3. dcolor after the walk: dcolor[i, c] = sum_px w[i, px] ghat[c, px],
//         M = 32 pairs, N = the chunk's 16 channels, K = the strip's 32
//         pixels, into s_part[strip][i][c] (0 from a strip whose pixels
//         took no contribution from the batch, which skips the product);
//         after the chunk's second barrier one thread per (pair, channel)
//         adds the strips in strip order and writes the row's column: one
//         writer, no atomics.
//    Shared memory at 512 pixels: s_qw [32][516] and three ghat chunks
//    [16][516] (4 floats of padding a row put the fragments' rows on
//    different banks), three colour chunks [16][36], s_part [16][32][16]
//    and s_red: 217,088 bytes, one block an SM. Nothing is kept from the
//    forward but final_T and n_contrib: its strip lists (pair ids and 32
//    weights per contributing (pair, strip)) would be P * 16 * 33 * 4 bytes
//    at a pair budget of P, 8.9 GB at 2^22, live across the loss on a card
//    that the 512-channel training cell already fills to 67.9 GB of 80.
// The row buffer is [P, 6 + C] floats over the pair budget: ~3.8 GB at
// C = 768 and 1,228,800 slots, which fits the card's 80 GB.
//
// What bounds it on the H100. At C <= 8, f32 arithmetic on the CUDA cores:
// ~18 ops per (pixel, pair) alpha up to each pixel's n_contrib and ~20 + 4 C
// per contributing one, plus the per-pair reduction (shuffles run at a
// quarter of the FMA rate) and one barrier a batch; the heaviest tiles
// (about three times the mean pair count at the centre of the view) set the
// kernel's end. Wider, the products are dense over the 32 pixels of every
// strip that some pair of the batch reaches (about twice the contributing
// events at the 512-channel cell): 2 C multiply-adds per (pixel, pair),
// three times over on the tensor cores, whose mma.sync rate, with the
// splits and fragment loads around it, sets the pace; then the walk (the
// C <= 8 kernel's work), two barriers a chunk, and ghat read once a batch
// (PX C 4 bytes a tile: ~8 GB a view at the 512-channel cell, mostly from
// device memory, behind the ring).
//
// Rounding: the library is built with -fmad=false (like the forward, so
// expf and the alpha chain compile identically); products that may fuse
// are written as explicit fmaf. Every sum runs in a fixed order (the
// tensor cores' own included), so two runs give the same bits; nothing
// here is compared bit for bit with the plain version: rows agree at rtol
// 1e-4.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"
#include "segchain.cuh"

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

// The one-pass kernel (C <= 8). GEO: geometry columns 0..5; COL: colour
// columns 6 .. 6 + C; both are set in every instance (q needs ghat of all C
// channels in registers, C <= CB). PPT: pixels per thread; the block has
// tile_w * tile_h / PPT threads.
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
  static_assert(GEO && COL, "the one-pass kernel forms q from its channels in registers");
  constexpr int NV = (GEO ? NGEO : 0) + (COL ? CB : 0);
  constexpr int MAXW = 16 / PPT;
  constexpr int BATCH = batch_for(NV, MAXW);
  constexpr int SC = GEO && COL ? CB : 1;
  __shared__ float4 s_g0[3][BATCH];  // mx, my, ca, cb
  __shared__ float4 s_g1[3][BATCH];  // cc, op, depth, pad
  __shared__ uint32_t s_rows[3][BATCH];
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
#pragma unroll
            for (int c = 0; c < CB; ++c) q = fmaf(s_col[sl][i][c], gh[k][c], q);
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

// ---------------------------------------------------------------- wide
// 3xTF32 on the tensor cores: x = big + small, both TF32. The tensor cores
// read the top 19 bits of a TF32 operand's register and ignore the other 13,
// so x's own bits are big (x cut to 10 bits of mantissa) and small = x - big
// is exact; what they drop of small lies below 2^-20 of x. a b is summed as
// small(a) big(b) + big(a) small(b) + big(a) big(b), which leaves out only
// small(a) small(b), below 2^-20 of the product. A mask and a float32
// subtraction make the split: a conversion instruction would run at a
// fraction of their rate.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N], uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = __float_as_uint(x[i]);
    small[i] = __float_as_uint(__fsub_rn(x[i], __uint_as_float(big[i] & 0xffffe000u)));
  }
}

// d += a b on a 16 x 8 x 8 tile (mma.sync m16n8k8, row-major A, column-major
// B): with g = lane / 4 and t = lane % 4, a holds A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4]; b holds B[t][g], B[t + 4][g]; d holds
// D[g][2 t], D[g][2 t + 1], D[g + 8][2 t], D[g + 8][2 t + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// C > 8 (see the header): one block per tile, one thread per pixel, so warp
// w is the tile's strip w (pixels 32 w .. 32 w + 31).
constexpr int WB = 32;           // pairs a batch: one bit a pair in a warp's masks
constexpr int WCK = 16;          // channels a chunk of ghat and of the colours
constexpr int WSTAGES = 3;       // chunks in shared memory: two in flight while one is read
constexpr int WPAD = 4;          // floats after each shared row of pixels
constexpr int WLDC = WB + WPAD;  // a chunk's colour row: one channel, WB pairs

__host__ __device__ constexpr size_t wide_smem_floats(int px) {
  return (size_t)WB * (px + WPAD)                  // s_qw: q, then w [WB][px]
         + (size_t)WSTAGES * WCK * (px + WPAD)     // s_gh: chunks of ghat [WCK][px]
         + (size_t)WSTAGES * WCK * WLDC            // s_col: chunks of colours [WCK][WB]
         + (size_t)(px / 32) * WB * WCK            // s_part: dcolor by strip [strips][WB][WCK]
         + (size_t)WB * NGEO * (px / 32);          // s_red: geometry sums by strip [WB][NGEO][strips]
}

__global__ void __launch_bounds__(512, 1) composite_bwd_kernel_wide(
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
  extern __shared__ float4 s_dyn[];
  const int px = tile_w * tile_h, ld = px + WPAD, strips = px / 32;
  float* s_qw = reinterpret_cast<float*>(s_dyn);
  float* s_gh = s_qw + WB * ld;
  float* s_col = s_gh + WSTAGES * WCK * ld;
  float* s_part = s_col + WSTAGES * WCK * WLDC;
  float* s_red = s_part + strips * WB * WCK;
  __shared__ float4 s_g0[2][WB];  // mx, my, ca, cb
  __shared__ float4 s_g1[2][WB];  // cc, op, depth, pad
  __shared__ uint32_t s_rows[2][WB];
  __shared__ int32_t s_id[2][WB];
  __shared__ uint32_t s_hits[16];  // by strip: pairs of the walked batch that contribute there
  __shared__ int s_max;

  const int t = blockIdx.x;
  const int nt = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = 6 + C;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float* gt = g_color + (size_t)t * C * px;  // this tile's ghat [C][px]
  float tox, toy, lx, ly;
  sgt::tile_frame(t, tid, grid_w, tile_w, tile_h, &tox, &toy, &lx, &ly);
  float T = final_t[(size_t)t * px + tid];
  float s = 0.0f;  // sum of w q over the pixel's later contributors
  const int last = n_contrib[(size_t)t * px + tid];
  const int wlast = __reduce_max_sync(FULL, last);
  const uint32_t wrows = sgt::pixel_rows(warp * 32, 32, tile_w);
  float bgdot = 0.0f;
  for (int c = 0; c < C; ++c) bgdot = fmaf(bg[c], gt[(size_t)c * px + tid], bgdot);
  const float tb = __fmul_rn(T, bgdot);

  if (tid == 0) s_max = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_max, wlast);
  __syncthreads();
  const int max_last = min(s_max, count);

  // Slots after every pixel's last contributor hold no gradient.
  const long long nzero = (long long)(count - max_last) * D;
  for (long long k = tid; k < nzero; k += nt) out[(size_t)(start + max_last) * D + k] = 0.0f;

  const int nbatch = (max_last + WB - 1) / WB;
  if (nbatch == 0) return;
  const int nch = (C + WCK - 1) / WCK;
  auto lo = [&](int b) { return max(0, max_last - (b + 1) * WB); };
  auto size = [&](int b) { return max_last - b * WB - lo(b); };
  // A chunk's copies: px threads take a ghat row's px / 4 float4 four rows
  // at a time, this one rows cr, cr + 4, ... at pixel cx.
  const int cr = tid / (px / 4), cx = 4 * (tid % (px / 4));
  // The products are mma tiles (g and t as in mma_tf32) over the warp's strip.
  const int g = lane >> 2, tg = lane & 3, x0 = warp * 32;

  auto stage = [&](int b) {  // batch b's ids, geometry and row masks
    if (tid < WB) {
      uint32_t rows = 0u;
      if (tid < size(b)) {
        const int id = pair_gaussian[start + lo(b) + tid];
        const float4* row = reinterpret_cast<const float4*>(geom + (size_t)id * GEOM);
        const float4 g0 = row[0], g1 = row[1];
        s_g0[b & 1][tid] = g0;
        s_g1[b & 1][tid] = g1;
        s_id[b & 1][tid] = id;
        rows = sgt::candidate_rows(g0, g1, toy, tile_h, 0, tile_h - 1);
      }
      s_rows[b & 1][tid] = rows;
    }
  };
  // The pairs of staged batch b that may hold a candidate in this warp's
  // strip before its last contributor: a cleared bit is no candidate there.
  auto live_in_strip = [&](int b) {
    return __ballot_sync(FULL, (s_rows[b & 1][lane] & wrows) != 0u && lo(b) + lane < wlast);
  };
  // Chunk cc of ghat, and of batch b's colours where b is a batch, into
  // stage cc % WSTAGES; one commit group a call, empty past the last chunk.
  auto fetch = [&](int b, int cc) {
    if (cc < nch) {
      const int c0 = cc * WCK, buf = cc % WSTAGES;
      float* gh = s_gh + buf * WCK * ld;
      for (int r = cr; r < WCK; r += 4) {
        if (c0 + r < C) {
          segchain::cp_async(gh + r * ld + cx, gt + (size_t)(c0 + r) * px + cx, 4);
        } else {
          *reinterpret_cast<float4*>(gh + r * ld + cx) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if (b < nbatch) {
        float* col = s_col + buf * WCK * WLDC;
        for (int e = tid; e < WCK * WB; e += nt) {
          const int k = e / WCK, r = e % WCK;
          if (k < size(b) && c0 + r < C) {
            segchain::cp_async(col + r * WLDC + k, colors + (size_t)s_id[b & 1][k] * C + c0 + r, 1);
          } else {
            col[r * WLDC + k] = 0.0f;
          }
        }
      }
    }
    segchain::cp_async_commit();
  };

  stage(0);
  __syncthreads();
  uint32_t live = live_in_strip(0);
  fetch(0, 0);
  fetch(0, 1);
  // Iteration `it` runs step 3 of batch it - 1 and step 1 of batch it over
  // one pass of ghat's chunks, then walks batch it.
  for (int it = 0; it <= nbatch; ++it) {
    const bool walked = it > 0, next = it < nbatch;
    const int prev_lo = walked ? lo(it - 1) : 0, prev_size = walked ? size(it - 1) : 0;
    // dcolor of batch it - 1 for chunk cc: the strips' partials in strip order.
    auto reduce = [&](int cc) {
      for (int e = tid; e < WB * WCK; e += nt) {
        const int k = e / WCK, r = e % WCK, c = cc * WCK + r;
        if (k < prev_size && c < C) {
          float v = 0.0f;
          for (int w = 0; w < strips; ++w) v += s_part[(w * WB + k) * WCK + r];
          out[(size_t)(start + prev_lo + k) * D + 6 + c] = v;
        }
      }
    };

    float q[2][4][4];  // step 1's tiles: pairs 16 m + g (+ 8) x pixels x0 + 8 n + 2 t (+ 1)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) q[m][n][v] = 0.0f;
    for (int cc = 0; cc < nch; ++cc) {
      segchain::cp_async_wait<1>();
      // Chunk cc in; chunk cc - 1 read and its partials summed.
      __syncthreads();
      fetch(it, cc + 2);
      const float* gh = s_gh + (cc % WSTAGES) * WCK * ld;
      if (walked) {  // step 3: this strip's part of dcolor[i, c] for batch it - 1
        // M = the 32 pairs (two tiles), N = the chunk's 16 channels (two),
        // K = the strip's 32 pixels (four steps of 8).
        float d[2][2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int v = 0; v < 4; ++v) d[m][n][v] = 0.0f;
        if (s_hits[warp] != 0u) {  // else no contribution in the strip
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int x = x0 + 8 * k + tg;
            uint32_t bb[2][2], bs[2][2];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const float bv[2] = {gh[(8 * n + g) * ld + x], gh[(8 * n + g) * ld + x + 4]};
              split(bv, bb[n], bs[n]);
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float* w = s_qw + (16 * m + g) * ld + x;
              const float av[4] = {w[0], w[8 * ld], w[4], w[8 * ld + 4]};
              uint32_t ab[4], as[4];
              split(av, ab, as);
#pragma unroll
              for (int n = 0; n < 2; ++n) mma_3xtf32(d[m][n], ab, as, bb[n], bs[n]);
            }
          }
        }
        float* part = s_part + warp * WB * WCK;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float* p = part + (16 * m + g) * WCK + 8 * n + 2 * tg;
            *reinterpret_cast<float2*>(p) = make_float2(d[m][n][0], d[m][n][1]);
            *reinterpret_cast<float2*>(p + 8 * WCK) = make_float2(d[m][n][2], d[m][n][3]);
          }
      }
      if (live != 0u) {  // step 1: q of batch it over this strip and chunk
        // M = the 32 pairs (two tiles), N = the strip's 32 pixels (four),
        // K = the chunk's 16 channels (two steps of 8); each chunk's tile
        // sum is added to q in float32.
        const float* col = s_col + (cc % WSTAGES) * WCK * WLDC;
        float qc[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int v = 0; v < 4; ++v) qc[m][n][v] = 0.0f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* gp = gh + (8 * k + tg) * ld + x0 + 8 * n + g;
            const float bv[2] = {gp[0], gp[4 * ld]};
            split(bv, bb[n], bs[n]);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* cp = col + (8 * k + tg) * WLDC + 16 * m + g;
            const float av[4] = {cp[0], cp[8], cp[4 * WLDC], cp[4 * WLDC + 8]};
            uint32_t ab[4], as[4];
            split(av, ab, as);
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_3xtf32(qc[m][n], ab, as, bb[n], bs[n]);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int v = 0; v < 4; ++v) q[m][n][v] = __fadd_rn(q[m][n][v], qc[m][n][v]);
      }
      __syncthreads();  // the partials written; chunk cc read
      if (walked) reduce(cc);
    }
    if (!next) break;

#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float* p = s_qw + (16 * m + g) * ld + x0 + 8 * n + 2 * tg;
        *reinterpret_cast<float2*>(p) = make_float2(q[m][n][0], q[m][n][1]);
        *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(q[m][n][2], q[m][n][3]);
      }
    if (it + 1 < nbatch) stage(it + 1);
    __syncthreads();  // q of batch it in place of w of it - 1; batch it + 1 staged
    const uint32_t live_next = it + 1 < nbatch ? live_in_strip(it + 1) : 0u;
    // The next pass's first chunks load while this batch is walked.
    fetch(it + 1, 0);
    fetch(it + 1, 1);

    // Step 2: the walk, back to front; w replaces q, 0 where no contribution.
    const int b0 = lo(it), sl = it & 1;
    uint32_t hits = 0u;
    for (int i = WB - 1; i >= 0; --i) {
      const int j = b0 + i;
      float v[NGEO];
#pragma unroll
      for (int m = 0; m < NGEO; ++m) v[m] = 0.0f;
      bool hit = false;
      float w = 0.0f;
      if ((live >> i) & 1u) {  // warp-uniform
        const float4 g0 = s_g0[sl][i], g1 = s_g1[sl][i];
        const sgt::Alpha a = sgt::alpha_terms(g0, g1, tox, toy, lx, ly);
        if (a.candidate && j < last) {
          hit = true;
          const float inv = __frcp_rn(__fsub_rn(1.0f, a.alpha));
          T = __fmul_rn(T, inv);  // transmittance before this pair
          w = __fmul_rn(a.alpha, T);
          const float qv = s_qw[i * ld + tid];
          const float dalpha = __fmul_rn(T, qv) - __fmul_rn(s, inv) - __fmul_rn(tb, inv);
          s = fmaf(w, qv, s);
          const float gd = __fmul_rn(a.g, dalpha);
          const float dldp = __fmul_rn(g1.y, gd);
          const float t1 = __fmul_rn(dldp, a.dx);
          const float t2 = __fmul_rn(dldp, a.dy);
          v[0] += t1;
          v[1] += t2;
          v[2] += __fmul_rn(t1, a.dx);
          v[3] += __fmul_rn(t1, a.dy);
          v[4] += __fmul_rn(t2, a.dy);
          v[5] += gd;
        }
      }
      s_qw[i * ld + tid] = w;
      if (__any_sync(FULL, hit)) {
        hits |= 1u << i;
        int idx;
        const float r = transpose_sum<NGEO>(v, lane, &idx);
        if (idx >= 0) s_red[(i * NGEO + idx) * strips + warp] = r;
      } else if (lane < NGEO) {
        s_red[(i * NGEO + lane) * strips + warp] = 0.0f;
      }
    }
    if (lane == 0) s_hits[warp] = hits;
    __syncthreads();  // the walk's sums and w in place

    // The geometry columns of batch it, the strips' sums in strip order.
    for (int e = tid; e < size(it) * NGEO; e += nt) {
      const int i = e / NGEO, m = e % NGEO;
      auto red = [&](int v) {
        float r = 0.0f;
        for (int w = 0; w < strips; ++w) r += s_red[(i * NGEO + v) * strips + w];
        return r;
      };
      const float ca = s_g0[sl][i].z, cb = s_g0[sl][i].w, cc = s_g1[sl][i].x;
      float val;
      switch (m) {
        case 0: val = -(__fmul_rn(ca, red(0)) + __fmul_rn(cb, red(1))); break;
        case 1: val = -(__fmul_rn(cc, red(1)) + __fmul_rn(cb, red(0))); break;
        case 2: val = -0.5f * red(2); break;
        case 3: val = -red(3); break;
        case 4: val = -0.5f * red(4); break;
        default: val = red(5); break;
      }
      out[(size_t)(start + b0 + i) * D + m] = val;
    }
    live = live_next;
  }
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
// receives the number of kernels launched: 0 or 1. Returns a cudaError_t.
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
  const size_t smem = wide_smem_floats(px) * sizeof(float);
  // The opt-in above 48 KB (per device, so asked on every launch).
  e = cudaFuncSetAttribute(composite_bwd_kernel_wide,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  composite_bwd_kernel_wide<<<num_tiles, px, smem, s>>>(g, col, pg, ts, tc, b, gc, ft, nct, C,
                                                        grid_w, tile_w, tile_h, o);
  e = cudaGetLastError();
  *launched = e == cudaSuccess;
  return static_cast<int>(e);
}

}  // extern "C"
