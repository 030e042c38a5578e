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
// Geometry and colours are gathered from the per-Gaussian arrays through
// the sorted pair ids (the renderCUDA pattern), so no packed per-pair
// [D, P] buffer is written or read: at C = 768 that buffer would be
// ~3.7 GB per render. Every pair carries `candidate_rows` (alpha.cuh),
// computed once per (tile, pair) when it is staged: a warp whose pixel rows
// the pair provably misses skips it, which changes no decision and no bit.
//
// The walk (composite_fwd_kernel): one block per tile, one thread per
// pixel, batches of 128 pairs staged in shared memory by cp.async (the next
// batch in flight while the current one is walked), one barrier a batch,
// which is also the all-done vote that ends the block early (as the TPU
// kernel's). A warp takes the pairs that may touch its row four at a time:
// their alphas are independent, only the front-to-back steps are serial.
// By width:
//  - C <= 32 (RGB, depth-only, one-hot labels): the C channels in registers
//    (CB in {1, 3, 4, 8, 16, 24, 32}); one kernel.
//  - wider (fused features, C = 768; from ops/composite.py's
//    LIST_MIN_CHANNELS on, which passes the lists): two kernels, so that
//    the weights w = alpha T are evaluated once per tile and not once per
//    channel block. The walk appends, for every pair with a contributing
//    pixel in a warp's 32 pixels (a strip), the pair's id and the strip's
//    32 weights to the strip's list (at most the tile's pair count long).
//    The contraction (composite_fwd_contract_kernel), one block per (strip,
//    slice of up to 768 channels), streams its list through shared memory
//    and sums out[px, c] = sum_pair w[pair, px] col[pair, c] in registers.
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores: ~18 ops for
// each (pixel, pair) whose alpha is evaluated and 2 C for each one that
// contributes colour. The walk issues ~40 instructions an evaluated event
// (alpha with expf, the step, the loop), which sets the pace at C <= 32.
// At C = 768 the contraction is dense over a strip's 32 pixels (a pair
// covers a dozen of them), so its FMAs are ~2.5x the contributing events';
// TF32 tensor cores would miss the rtol 1e-5 contract, and a 3xTF32 split is
// later work.
//
// Numerics: the sequential per-pixel order and the JAX kernel's op order
// (`_alpha_terms`, composite_pallas.py:206-232, in alpha.cuh, which the
// backward kernel shares; the contribute / terminate / median rules at
// :330-375). The alpha / T / median chain uses the
// round-to-nearest intrinsics (and the library is built with -fmad=false),
// so every decision that feeds n_contrib rounds as the plain torch
// version's separate ops do; expf is the only difference there. The colour
// sum is an explicit fmaf over the pairs in order: one FFMA per channel
// instead of a rounded multiply and add, within rtol 1e-5 of the plain
// version's contraction.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using sgt::FULL;
using sgt::GEOM;
using sgt::T_EPS;
constexpr float MEDIAN_DEPTH_INIT = 15.0f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// One pixel's front-to-back state. `step` applies one pair whose alpha
// terms are given: returns true if the pair contributes (w set), sets done
// when the pixel terminates on it.
struct Pixel {
  float T = 1.0f, D = MEDIAN_DEPTH_INIT;
  int last = 0;
  bool done = false;
  __device__ __forceinline__ bool step(const sgt::Alpha& a, float depth, int j, float* w) {
    if (done || !a.candidate) return false;
    const float test_t = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
    if (test_t < T_EPS) {
      done = true;
      return false;
    }
    *w = __fmul_rn(a.alpha, T);
    if (T > 0.5f && test_t < 0.5f) D = depth;
    T = test_t;
    last = j + 1;
    return true;
  }
};

// Up to G positions of set bits of *m (lowest first), removed from *m; the
// unused entries repeat the first, so that a group is computed without
// branches (the caller ignores entries past *n).
template <int G>
__device__ __forceinline__ void take_bits(uint32_t* m, int base, int (&idx)[G], int* n) {
  *n = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    idx[g] = *m ? base + __ffs(*m) - 1 : idx[0];
    *n += *m != 0u;
    *m &= *m - 1u;
  }
}

// ---------------------------------------------------------------- walk
// EMIT = false (C <= 32): the colour sum in registers, written at the end.
// EMIT = true (C > 32): no colour; for every pair with a contributing pixel
// in a warp's 32 pixels (its strip), the warp appends the pair's id and the
// 32 weights to the strip's list, for composite_fwd_contract_kernel.
template <int CB, bool EMIT>
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
    int32_t* __restrict__ out_contrib,  // [T, PX]
    float* __restrict__ list_w,       // [P * PX / 32, 32] (EMIT)
    int32_t* __restrict__ list_id,    // [P * PX / 32] (EMIT)
    int32_t* __restrict__ list_n) {   // [T, PX / 32] (EMIT)
  constexpr int BATCH = 128;
  constexpr int SC = EMIT ? 1 : CB;
  __shared__ float4 s_g0[2][BATCH];  // mx, my, ca, cb
  __shared__ float4 s_g1[2][BATCH];  // cc, op, depth, pad
  __shared__ uint32_t s_rows[2][BATCH];
  __shared__ int32_t s_id[2][BATCH];
  __shared__ float s_col[2][BATCH][SC];

  const int t = blockIdx.x;
  const int px = blockDim.x;
  const int pix = threadIdx.x, lane = pix & 31;
  float tox, toy, lx, ly;
  sgt::tile_frame(t, pix, grid_w, tile_w, tile_h, &tox, &toy, &lx, &ly);
  const uint32_t wrows = sgt::pixel_rows(pix & ~31, 32, tile_w);

  const int start = tile_start[t];
  const int count = tile_count[t];
  const int bs = min(BATCH, px);  // pairs a batch: one a thread
  const int nbatch = (count + bs - 1) / bs;
  auto size = [&](int b) { return min(bs, count - b * bs); };
  // EMIT: this warp's list, count pairs long at most.
  const int strips = px / 32;
  const size_t list0 = (size_t)start * strips + (size_t)(pix >> 5) * count;
  int listed = 0;

  // Thread i stages pair i of a batch; r_next holds that pair's id ahead.
  int r_next = 0;
  auto issue = [&](int b) {
    if (b < nbatch && pix < size(b)) {
      const int sl = b & 1;
      const float* row = geom + (size_t)r_next * GEOM;
      cp_async16(&s_g0[sl][pix], row);
      cp_async16(&s_g1[sl][pix], row + 4);
      s_id[sl][pix] = r_next;
      if constexpr (!EMIT) {
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c < C) {
            cp_async4(&s_col[sl][pix][c], colors + (size_t)r_next * C + c);
          } else {
            s_col[sl][pix][c] = 0.0f;
          }
        }
      }
    }
    cp_async_commit();
    if (b + 1 < nbatch && pix < size(b + 1)) {
      r_next = pair_gaussian[start + (b + 1) * bs + pix];
    }
  };
  auto finish = [&](int b) {  // this thread's copies have landed: its row mask
    cp_async_wait_all();
    if (b < nbatch && pix < size(b)) {
      s_rows[b & 1][pix] =
          sgt::candidate_rows(s_g0[b & 1][pix], s_g1[b & 1][pix], toy, tile_h, 0, tile_h - 1);
    }
  };

  Pixel p;
  float acc[SC];
#pragma unroll
  for (int c = 0; c < SC; ++c) acc[c] = 0.0f;

  if (nbatch > 0 && pix < size(0)) r_next = pair_gaussian[start + pix];
  issue(0);
  finish(0);
  for (int b = 0; b < nbatch; ++b) {
    // Barrier for the staged batch and the all-done vote in one.
    if (__syncthreads_count(p.done) == px) break;
    issue(b + 1);
    // The pairs that may touch this warp's row, four at a time: their
    // alphas are independent, only the steps are sequential.
    const int sl = b & 1, nb = size(b);
    for (int q = 0; q < nb; q += 32) {
      const int i = q + lane;
      uint32_t m = __ballot_sync(FULL, i < nb && (s_rows[sl][i] & wrows) != 0u);
      while (m != 0u && !__all_sync(FULL, p.done)) {
        int idx[4], n;
        take_bits<4>(&m, q, idx, &n);
        sgt::Alpha a[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          a[g] = sgt::alpha_terms(s_g0[sl][idx[g]], s_g1[sl][idx[g]], tox, toy, lx, ly);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float w = 0.0f;
          const bool hit = g < n && p.step(a[g], s_g1[sl][idx[g]].z, b * bs + idx[g], &w);
          if constexpr (EMIT) {
            if (__ballot_sync(FULL, hit)) {  // g < n is warp-uniform
              list_w[(list0 + listed) * 32 + lane] = w;
              if (lane == 0) list_id[list0 + listed] = s_id[sl][idx[g]];
              ++listed;
            }
          } else if (hit) {
#pragma unroll
            for (int c = 0; c < CB; ++c) acc[c] = fmaf(w, s_col[sl][idx[g]][c], acc[c]);
          }
        }
      }
    }
    finish(b + 1);
  }
  cp_async_wait_all();  // an early exit leaves the last copies in flight

  const size_t tp = (size_t)t * px + pix;
  if constexpr (EMIT) {
    if (lane == 0) list_n[(size_t)t * strips + (pix >> 5)] = listed;
  } else {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c < C) {
        out_color[((size_t)t * C + c) * px + pix] = __fadd_rn(acc[c], __fmul_rn(bg[c], p.T));
      }
    }
  }
  out_depth[tp] = p.D;
  out_t[tp] = p.T;
  out_contrib[tp] = p.last;
}

// ---------------------------------------------------------------- contract
// One block per (strip of 32 pixels, slice of 32 CT channels): the strip's
// list of (pair, 32 weights), in walking order, contracted with the pairs'
// colour slices. Segments of SEG pairs (ids, weights, colours) are copied
// by cp.async one segment ahead of the one being summed (ids two ahead,
// since the colour copies need them). 256 threads:
// thread (pq, cg) holds pixels 4 pq .. 4 pq + 3 x channels 4 cg + 128 j + 0..3
// (j < CT / 4), so a warp reads 8 float4 of weights and 4 x J float4 of
// colours per pair without bank conflicts, for 16 J FMAs a thread.
constexpr int CONTRACT_THREADS = 256;

template <int CT>
__host__ __device__ constexpr int contract_slice() { return 32 * CT; }

// Pairs a segment: two segments of colours and weights stay within ~100 KB,
// so that two blocks share an SM.
template <int CT>
__host__ __device__ constexpr int contract_seg() { return CT > 12 ? 16 : 32; }

template <int CT>
__host__ __device__ constexpr size_t contract_smem() {
  return (size_t)2 * contract_seg<CT>() * (contract_slice<CT>() + 32) * sizeof(float);
}

// vec: colour rows can be copied 16 bytes at a time (C % 4 == 0, aligned).
template <int CT>
__global__ void __launch_bounds__(CONTRACT_THREADS, 2) composite_fwd_contract_kernel(
    const float* __restrict__ colors, const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count, const float* __restrict__ bg,
    const float* __restrict__ final_t, const float* __restrict__ list_w,
    const int32_t* __restrict__ list_id, const int32_t* __restrict__ list_n,
    int C, int px, int vec, float* __restrict__ out_color) {
  constexpr int CS = contract_slice<CT>();
  constexpr int SEG = contract_seg<CT>();
  constexpr int J = CT / 4;
  extern __shared__ float4 s_dyn[];
  float* s_col = reinterpret_cast<float*>(s_dyn);  // [2][SEG][CS]
  float* s_w = s_col + 2 * SEG * CS;               // [2][SEG][32]
  __shared__ int32_t s_ids[3][SEG];

  const int strips = px / 32;
  const int t = blockIdx.x / strips, strip = blockIdx.x % strips;
  const int p0 = strip * 32;
  const int cbase = blockIdx.y * CS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pq = lane & 7, cg = warp * 4 + (lane >> 3);
  const size_t list0 = (size_t)tile_start[t] * strips + (size_t)strip * tile_count[t];
  const int n = list_n[blockIdx.x];
  const int nseg = (n + SEG - 1) / SEG;

  auto ids = [&](int k) {  // segment k's pair ids into s_ids[k % 3]
    if (tid < SEG && k * SEG + tid < n) cp_async4(&s_ids[k % 3][tid], list_id + list0 + k * SEG + tid);
  };
  auto rows = [&](int k) {  // segment k's weights and colour slices
    const int buf = k & 1, m = min(SEG, n - k * SEG);
    float* w = s_w + buf * SEG * 32;
    for (int e = tid; e < m * 8; e += CONTRACT_THREADS) {
      cp_async16(w + e * 4, list_w + (list0 + k * SEG) * 32 + e * 4);
    }
    float* col = s_col + (size_t)buf * SEG * CS;
    if (vec) {
      for (int e = tid; e < m * (CS / 4); e += CONTRACT_THREADS) {
        const int r = e / (CS / 4), c = (e % (CS / 4)) * 4;
        float* dst = col + r * CS + c;
        if (cbase + c < C) {
          cp_async16(dst, colors + (size_t)s_ids[k % 3][r] * C + cbase + c);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      for (int e = tid; e < m * CS; e += CONTRACT_THREADS) {
        const int r = e / CS, c = e % CS;
        if (cbase + c < C) {
          cp_async4(col + r * CS + c, colors + (size_t)s_ids[k % 3][r] * C + cbase + c);
        } else {
          col[r * CS + c] = 0.0f;
        }
      }
    }
  };

  float acc[J][4][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][a][q] = 0.0f;

  ids(0);
  ids(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (nseg > 0) rows(0);
  cp_async_commit();
  for (int k = 0; k < nseg; ++k) {
    cp_async_wait_all();
    __syncthreads();  // segment k and the ids of k + 1 are in; k - 1 is summed
    ids(k + 2);
    if (k + 1 < nseg) rows(k + 1);
    cp_async_commit();
    const int buf = k & 1, m = min(SEG, n - k * SEG);
    const float* w = s_w + buf * SEG * 32 + 4 * pq;
    const float* col = s_col + (size_t)buf * SEG * CS + 4 * cg;
    for (int i = 0; i < m; ++i) {
      const float4 wv = *reinterpret_cast<const float4*>(w + i * 32);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 c = *reinterpret_cast<const float4*>(col + i * CS + 128 * j);
        const float cc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[j][a][0] = fmaf(wv.x, cc[a], acc[j][a][0]);
          acc[j][a][1] = fmaf(wv.y, cc[a], acc[j][a][1]);
          acc[j][a][2] = fmaf(wv.z, cc[a], acc[j][a][2]);
          acc[j][a][3] = fmaf(wv.w, cc[a], acc[j][a][3]);
        }
      }
    }
  }
  cp_async_wait_all();
  const float4 T = *reinterpret_cast<const float4*>(final_t + (size_t)t * px + p0 + 4 * pq);
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int c = cbase + 4 * cg + 128 * j + a;
      if (c < C) {
        const float b = bg[c];
        const float4 o = make_float4(__fadd_rn(acc[j][a][0], __fmul_rn(b, T.x)),
                                     __fadd_rn(acc[j][a][1], __fmul_rn(b, T.y)),
                                     __fadd_rn(acc[j][a][2], __fmul_rn(b, T.z)),
                                     __fadd_rn(acc[j][a][3], __fmul_rn(b, T.w)));
        *reinterpret_cast<float4*>(out_color + ((size_t)t * C + c) * px + p0 + 4 * pq) = o;
      }
    }
  }
}

struct Args {
  const float *geom, *colors;
  const int32_t *pair_gaussian, *tile_start, *tile_count;
  const float* bg;
  int C, num_tiles, grid_w, tile_w, tile_h;
  float *out_color, *out_depth, *out_t;
  int32_t* out_contrib;
  float* list_w;
  int32_t *list_id, *list_n;
  cudaStream_t stream;
};

template <int CB, bool EMIT>
cudaError_t launch_walk(const Args& a) {
  composite_fwd_kernel<CB, EMIT><<<a.num_tiles, a.tile_w * a.tile_h, 0, a.stream>>>(
      a.geom, a.colors, a.pair_gaussian, a.tile_start, a.tile_count, a.bg, a.C, a.grid_w,
      a.tile_w, a.tile_h, a.out_color, a.out_depth, a.out_t, a.out_contrib, a.list_w,
      a.list_id, a.list_n);
  return cudaGetLastError();
}

template <int CT>
cudaError_t launch_contract(const Args& a) {
  constexpr size_t smem = contract_smem<CT>();
  // The opt-in above 48 KB (per device, so asked on every launch).
  cudaError_t e = cudaFuncSetAttribute(composite_fwd_contract_kernel<CT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int px = a.tile_w * a.tile_h;
  const int vec = a.C % 4 == 0 && reinterpret_cast<uintptr_t>(a.colors) % 16 == 0;
  const dim3 grid(a.num_tiles * (px / 32), (a.C + contract_slice<CT>() - 1) / contract_slice<CT>());
  composite_fwd_contract_kernel<CT><<<grid, CONTRACT_THREADS, smem, a.stream>>>(
      a.colors, a.tile_start, a.tile_count, a.bg, a.out_t, a.list_w, a.list_id, a.list_n, a.C,
      px, vec, a.out_color);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers. tile_w * tile_h must be a multiple of
// 32 and at most 512 (checked by the caller). Without strip lists (null
// list_w) one kernel composites C <= 32 channels. With them (list_w
// [P * PX / 32, 32] floats, list_id [P * PX / 32] and list_n [T * PX / 32]
// ints, P = pair slots) the walk fills the lists and the contraction sums
// any C. *launched (a host pointer) receives the number of kernels
// launched: 1, or 2 with lists. Returns a cudaError_t.
int sgt_composite_fwd(const void* geom, const void* colors,
                      const void* pair_gaussian, const void* tile_start,
                      const void* tile_count, const void* bg, int C,
                      int num_tiles, int grid_w, int tile_w, int tile_h,
                      void* out_color, void* out_depth, void* out_t,
                      void* out_contrib, void* list_w, void* list_id, void* list_n,
                      void* stream, int* launched) {
  *launched = 0;
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const float*>(geom), static_cast<const float*>(colors),
               static_cast<const int32_t*>(pair_gaussian), static_cast<const int32_t*>(tile_start),
               static_cast<const int32_t*>(tile_count), static_cast<const float*>(bg),
               C, num_tiles, grid_w, tile_w, tile_h,
               static_cast<float*>(out_color), static_cast<float*>(out_depth),
               static_cast<float*>(out_t), static_cast<int32_t*>(out_contrib),
               static_cast<float*>(list_w), static_cast<int32_t*>(list_id),
               static_cast<int32_t*>(list_n), static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (a.list_w == nullptr) {
    if (C > 32) return static_cast<int>(cudaErrorInvalidValue);
    if (C <= 1) e = launch_walk<1, false>(a);
    else if (C <= 3) e = launch_walk<3, false>(a);
    else if (C <= 4) e = launch_walk<4, false>(a);
    else if (C <= 8) e = launch_walk<8, false>(a);
    else if (C <= 16) e = launch_walk<16, false>(a);
    else if (C <= 24) e = launch_walk<24, false>(a);
    else e = launch_walk<32, false>(a);
    *launched = e == cudaSuccess;
    return static_cast<int>(e);
  }
  e = launch_walk<1, true>(a);
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  if (C <= 128) e = launch_contract<4>(a);
  else if (C <= 256) e = launch_contract<8>(a);
  else e = launch_contract<24>(a);
  *launched += e == cudaSuccess;
  return static_cast<int>(e);
}

}  // extern "C"
