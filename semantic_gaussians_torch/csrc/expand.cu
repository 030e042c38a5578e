// Pair expand: pair slot -> (tile id, gaussian id, owner rank).
//
// Replaces the TPU kernel semantic_gaussians_tpu/ops/expand.py::_kernel
// (run by expand_pairs, called from ops/binning.py::bin_gaussians).
//
// For each pair slot p < budget, over the depth-ordered exclusive offsets:
//   owner = #{j : offsets[j] <= p} - 1          (binary search, upper bound)
//   rect  = packed x0<<16 | y0<<8 | w of the owner
//   tile  = (y0 + local / w) * ntx + x0 + local % w,   local = p - offset
//   cull  = tile_min_qn over the tile's pixel-centre rect > 1 + 1e-4
//           retires the pair to the sentinel tile.
// Invalid slots (p >= num_pairs) get (num_tiles, n, num_dense); culled
// valid slots get (num_tiles, n, owner).
//
// What bounds it on the H100: bytes. Each slot writes 12 bytes and reads
// ~log2(N) offsets (L2-resident: the table is N * 36 bytes, 3.6 MB at
// N = 100k) plus one owner row; the arithmetic is a few dozen flops. The
// TPU kernel's one-hot MXU contraction (owner by compare+count over a
// window, rect columns by an exact-f32 3-way bf16 matmul) existed because
// a TPU has no fast gather; on the GPU a thread simply searches and loads.
// Neighbouring slots share an owner, so the search's loads coalesce and hit
// L1/L2. Integer / and % replace the TPU's exact f32 divide (the same
// result for 0 <= local < 2^22).
//
// Rounding: tile_min_qn feeds a cull DECISION that the tests compare bit for
// bit with the plain torch version and the JAX package. It is evaluated op
// for op in the JAX order with the _rn intrinsics (no FMA contraction; the
// library is also built with -fmad=false), so every product and sum rounds
// as the separate torch ops do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float TIGHTCULL_MARGIN = 1.0001f;  // float32(1.0 + 1e-4)

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// q(dx, dy) = e0 dx^2 + 2 (e1 dx dy) + e2 dy^2, left to right.
__device__ __forceinline__ float qform(float e0, float e1, float e2, float dx,
                                       float dy) {
  float t0 = __fmul_rn(__fmul_rn(e0, dx), dx);
  float t1 = __fmul_rn(2.0f, __fmul_rn(__fmul_rn(e1, dx), dy));
  float t2 = __fmul_rn(__fmul_rn(e2, dy), dy);
  return __fadd_rn(__fadd_rn(t0, t1), t2);
}

// Exact min of the normalized PD form over the box [lox,hix]x[loy,hiy]
// (semantic_gaussians_tpu/ops/expand.py::tile_min_qn, same op order).
__device__ __forceinline__ float tile_min_qn(float lox, float hix, float loy,
                                             float hiy, float e0, float e1,
                                             float e2) {
  bool inside = (lox <= 0.0f) && (hix >= 0.0f) && (loy <= 0.0f) && (hiy >= 0.0f);
  float e0s = fmaxf(e0, 1e-20f);
  float e2s = fmaxf(e2, 1e-20f);
  float dy1 = clipf(__fdiv_rn(-__fmul_rn(e1, lox), e2s), loy, hiy);
  float dy2 = clipf(__fdiv_rn(-__fmul_rn(e1, hix), e2s), loy, hiy);
  float dx1 = clipf(__fdiv_rn(-__fmul_rn(e1, loy), e0s), lox, hix);
  float dx2 = clipf(__fdiv_rn(-__fmul_rn(e1, hiy), e0s), lox, hix);
  float qn = fminf(fminf(qform(e0, e1, e2, lox, dy1), qform(e0, e1, e2, hix, dy2)),
                   fminf(qform(e0, e1, e2, dx1, loy), qform(e0, e1, e2, dx2, hiy)));
  return inside ? 0.0f : qn;
}

__global__ void expand_kernel(const int32_t* __restrict__ offsets,
                              const int32_t* __restrict__ rect_packed,
                              const int32_t* __restrict__ idx,
                              const float* __restrict__ cull,  // [5, n] or null
                              const int32_t* __restrict__ num_pairs,
                              const int32_t* __restrict__ num_dense, int n,
                              int budget, int ntx, int num_tiles, int tile_w,
                              int tile_h, int32_t* __restrict__ tile_out,
                              int32_t* __restrict__ gkey_out,
                              int32_t* __restrict__ owner_out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= budget) return;
  if (p >= *num_pairs) {
    tile_out[p] = num_tiles;
    gkey_out[p] = n;
    owner_out[p] = *num_dense;
    return;
  }
  // upper bound: first j with offsets[j] > p; offsets[0] = 0 <= p.
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (offsets[mid] <= p) lo = mid + 1; else hi = mid;
  }
  int owner = lo - 1;
  int pr = rect_packed[owner];
  int x0 = pr >> 16, y0 = (pr >> 8) & 255, w = pr & 255;
  int local = p - offsets[owner];
  int q = local / w;
  int tx = x0 + (local - q * w);
  int ty = y0 + q;
  bool live = true;
  if (cull != nullptr) {
    float lox = __fsub_rn((float)(tx * tile_w), cull[owner]);
    float hix = __fadd_rn(lox, (float)(tile_w - 1));
    float loy = __fsub_rn((float)(ty * tile_h), cull[n + owner]);
    float hiy = __fadd_rn(loy, (float)(tile_h - 1));
    float qn = tile_min_qn(lox, hix, loy, hiy, cull[2 * n + owner],
                           cull[3 * n + owner], cull[4 * n + owner]);
    live = !(qn > TIGHTCULL_MARGIN);
  }
  tile_out[p] = live ? ty * ntx + tx : num_tiles;
  gkey_out[p] = live ? idx[owner] : n;
  owner_out[p] = owner;
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; num_pairs / num_dense are int32
// scalars on the device (no host sync). Returns a cudaError_t.
int sgt_expand_pairs(const void* offsets, const void* rect_packed,
                     const void* idx, const void* cull, const void* num_pairs,
                     const void* num_dense, int n, int budget, int ntx,
                     int num_tiles, int tile_w, int tile_h, void* tile_out,
                     void* gkey_out, void* owner_out, void* stream) {
  if (budget <= 0) return static_cast<int>(cudaSuccess);
  constexpr int threads = 256;
  int blocks = (budget + threads - 1) / threads;
  expand_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(rect_packed),
      static_cast<const int32_t*>(idx), static_cast<const float*>(cull),
      static_cast<const int32_t*>(num_pairs),
      static_cast<const int32_t*>(num_dense), n, budget, ntx, num_tiles,
      tile_w, tile_h, static_cast<int32_t*>(tile_out),
      static_cast<int32_t*>(gkey_out), static_cast<int32_t*>(owner_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
