// Pair expand: pair slot -> (tile id, Gaussian id, owner rank).
//
// Replaces the TPU kernel semantic_gaussians_tpu/ops/expand.py::_kernel
// (:121; pallas_call at :320, run by expand_pairs from
// ops/binning.py::bin_gaussians).
//
// For each pair slot p < budget, over the depth-ordered exclusive offsets:
//   owner = #{j : offsets[j] <= p} - 1
//   rect  = packed x0<<16 | y0<<8 | w of the owner
//   tile  = (y0 + local / w) * ntx + x0 + local % w,   local = p - offset
//   cull  = tile_min_qn over the tile's pixel-centre rect > 1 + 1e-4
//           retires the pair to the sentinel tile.
// Invalid slots (p >= num_pairs) get (num_tiles, n, num_dense); culled
// valid slots get (num_tiles, n, owner).
//
// What bounds it on the H100: bytes. Every slot of the budget writes 12
// bytes; each Gaussian's row is read once: offset, rect and id (12 B) and,
// with the cull, its table (20 B). The cull's ~65 f32 operations a valid
// slot are far below the bytes at 67 TFLOP/s.
//
// What the design does about it:
// * A block owns CHUNK consecutive slots, SLOTS a thread, and writes each
//   output as one 16-byte store a thread (a warp stores 512 contiguous
//   bytes an output); a budget that is not a multiple of 4 takes one store
//   a slot.
// * Blocks whose first slot is at or past num_pairs (most of a budget) read
//   nothing but the two scalars and write the sentinels. Such a block lives
//   about one load latency, so their rate follows the number of resident
//   blocks: the kernel keeps to 48 registers, five blocks an SM (four cost
//   up to 60% at 1M Gaussians).
// * The owners of a block's valid slots are a contiguous window of the
//   table of at most CHUNK rows: every emitting Gaussian owns at least one
//   slot and the zero-count ones come last (offset = total), so each owner
//   after the first starts a run inside the chunk. Two warps find the
//   window's ends, each by a search of 128 probes a round whose loads are
//   issued together (3 dependent rounds at n = 100k and 1M, against a
//   binary search's 17-20 a slot); the block stages the window's rows in
//   shared memory with coalesced loads, each row read once, with a
//   multiplier per row that turns the tile decode's local / w into one
//   multiply-high; each thread finds its first slot's owner by a binary
//   search in shared memory and steps forward for the next slots, since
//   owners are monotone in the slot.
// * Valid blocks come first in the grid, so their chains (scalars, search,
//   staging, decode) start in the first wave. Orders that mixed tail
//   chunks in among them (alternating ends, or one wave of blocks that
//   loop over chunks) were slower at 100k, and decoding a thread's four
//   slots without branches took registers the occupancy needs.
// * A window wider than CHUNK (offsets outside the binning contract, e.g.
//   zero-count Gaussians between emitting ones) takes a search of the
//   global table per slot instead: slower, the same result.
// The TPU kernel found owners by a compare-and-count over a 640-row window
// and fetched their rows by a one-hot contraction on the MXU, because a
// TPU has no fast gather; the card gathers from shared memory directly.
// Integer division replaces the TPU's exact f32 divide (the same result for
// 0 <= local < 2^22).
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
constexpr int THREADS = 256;
constexpr int SLOTS = 4;                // ops/expand.py: SLOTS_PER_THREAD
constexpr int CHUNK = THREADS * SLOTS;  // ops/expand.py: CHUNK
constexpr int CULL_ROWS = 5;            // mean_x, mean_y, e0, e1, e2

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

struct Shape {
  int n, ntx, num_tiles, tile_w, tile_h;
};

// The tile and key of valid slot p of the owner whose run starts at `off`,
// with packed rect `pr`, its rect width's multiplier `magic` (0: none) and
// id `id`; `c` points at the owner's mean_x in a [5, stride] cull table
// (null: no cull).
__device__ __forceinline__ void emit(int p, int off, int pr, uint32_t magic, int id,
                                     const float* c, int stride, const Shape& sh, int& tile,
                                     int& gkey) {
  int x0 = pr >> 16, y0 = (pr >> 8) & 255, w = pr & 255;
  int local = p - off;
  int q = magic == 0u ? (w == 1 ? local : local / w) : (int)__umulhi((uint32_t)local, magic);
  int tx = x0 + (local - q * w);
  int ty = y0 + q;
  bool live = true;
  if (c != nullptr) {
    float lox = __fsub_rn((float)(tx * sh.tile_w), c[0]);
    float hix = __fadd_rn(lox, (float)(sh.tile_w - 1));
    float loy = __fsub_rn((float)(ty * sh.tile_h), c[stride]);
    float hiy = __fadd_rn(loy, (float)(sh.tile_h - 1));
    float qn = tile_min_qn(lox, hix, loy, hiy, c[2 * stride], c[3 * stride], c[4 * stride]);
    live = !(qn > TIGHTCULL_MARGIN);
  }
  tile = live ? ty * sh.ntx + tx : sh.num_tiles;
  gkey = live ? id : sh.n;
}

// #{j < n : offsets[j] <= p} for non-decreasing offsets, by a whole warp
// (p the same in every lane): each round probes PROBES evenly spaced
// entries of the range that holds the answer (LANE_PROBES a lane, loaded
// together) and keeps the gap where the comparison flips, so a range of s
// entries shrinks below s / PROBES: 3 rounds at n = 100k and at 1M.
constexpr int LANE_PROBES = 4;
constexpr int PROBES = 32 * LANE_PROBES;

__device__ int warp_upper_bound(const int32_t* __restrict__ offsets, int n, int p) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + PROBES - 1) / PROBES;
    int q[LANE_PROBES], v[LANE_PROBES];
#pragma unroll
    for (int i = 0; i < LANE_PROBES; ++i) {
      q[i] = lo + (i * 32 + lane + 1) * step - 1;
      v[i] = __ldg(offsets + min(q[i], hi - 1));
    }
    int c = 0;  // probes with offsets <= p: a prefix of the PROBES
#pragma unroll
    for (int i = 0; i < LANE_PROBES; ++i)
      c += __popc(__ballot_sync(0xffffffffu, q[i] < hi && v[i] <= p));
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  return lo;
}

// A thread's SLOTS values of one output, from slot p0 (a multiple of
// SLOTS): one 16-byte store where the output is aligned and the slots are
// inside the budget, else one store a slot.
__device__ __forceinline__ void store(int32_t* __restrict__ out, int p0, int budget,
                                      bool vec, const int (&v)[SLOTS]) {
  if (vec && p0 + SLOTS <= budget) {
    *reinterpret_cast<int4*>(out + p0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (p0 + s < budget) out[p0 + s] = v[s];
  }
}

// The window's rows: offsets, packed rects, ids and the cull table.
struct Window {
  int32_t off[CHUNK];
  int32_t rect[CHUNK];
  uint32_t magic[CHUNK];  // local / w = umulhi(local, magic) (0: w = 1)
  int32_t idx[CHUNK];
  float cull[CULL_ROWS * CHUNK];
};

// At most 48 registers: five resident blocks an SM (see the note above).
__global__ void __launch_bounds__(THREADS, 5)
expand_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ rect_packed,
              const int32_t* __restrict__ idx,
              const float* __restrict__ cull,  // [5, n] or null
              const int32_t* __restrict__ num_pairs_p,
              const int32_t* __restrict__ num_dense_p, Shape sh, int budget, bool vec,
              int32_t* __restrict__ tile_out, int32_t* __restrict__ gkey_out,
              int32_t* __restrict__ owner_out) {
  __shared__ Window win;
  __shared__ int ends[2];
  const int num_pairs = __ldg(num_pairs_p);
  const int num_dense = __ldg(num_dense_p);
  const int chunk0 = blockIdx.x * CHUNK;
  const int p0 = chunk0 + threadIdx.x * SLOTS;
  int tile[SLOTS], gkey[SLOTS], owner[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    tile[s] = sh.num_tiles;
    gkey[s] = sh.n;
    owner[s] = num_dense;
  }
  if (chunk0 < num_pairs) {  // the same in the whole block
    const int last = min(chunk0 + CHUNK, num_pairs) - 1;
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int u = warp_upper_bound(offsets, sh.n, warp == 0 ? chunk0 : last);
      if ((threadIdx.x & 31) == 0) ends[warp] = max(u - 1, 0);
    }
    __syncthreads();
    const int first = ends[0];
    const int rows = ends[1] - first + 1;
    if (rows <= CHUNK) {
      for (int r = threadIdx.x; r < rows; r += THREADS) {
        win.off[r] = __ldg(offsets + first + r);
        const int pr = __ldg(rect_packed + first + r);
        win.rect[r] = pr;
        // m = floor((2^32 - 1) / w) + 1 lies in [2^32 / w, 2^32 / w + 1), so
        // umulhi(local, m) = floor(local / w) for 2 <= w < 256 and local <
        // 2^16 (a rect has at most 255 x 255 tiles): the excess local (m -
        // 2^32 / w) / 2^32 < 2^-16 never reaches the next integer, which is
        // at least 1 / w away. w = 1 (m = 2^32) is marked 0.
        win.magic[r] = (pr & 255) == 1 ? 0u : 0xFFFFFFFFu / (uint32_t)(pr & 255) + 1u;
        win.idx[r] = __ldg(idx + first + r);
        if (cull != nullptr) {
#pragma unroll
          for (int c = 0; c < CULL_ROWS; ++c)
            win.cull[c * CHUNK + r] = __ldg(cull + (size_t)c * sh.n + first + r);
        }
      }
      __syncthreads();
      int k = -1;  // the window row owning the slot
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int p = p0 + s;
        if (p >= num_pairs) break;
        if (k < 0) {  // the thread's first slot: win.off[0] <= chunk0 <= p
          int lo = 1, hi = rows;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (win.off[mid] <= p) lo = mid + 1; else hi = mid;
          }
          k = lo - 1;
        } else {
          while (k + 1 < rows && win.off[k + 1] <= p) ++k;
        }
        owner[s] = first + k;
        emit(p, win.off[k], win.rect[k], win.magic[k], win.idx[k],
             cull != nullptr ? win.cull + k : nullptr, CHUNK, sh, tile[s], gkey[s]);
      }
    } else {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int p = p0 + s;
        if (p >= num_pairs) break;
        int lo = 0, hi = sh.n;  // upper bound of p in the whole table
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(offsets + mid) <= p) lo = mid + 1; else hi = mid;
        }
        const int o = max(lo - 1, 0);
        owner[s] = o;
        emit(p, __ldg(offsets + o), __ldg(rect_packed + o), 0u, __ldg(idx + o),
             cull != nullptr ? cull + o : nullptr, sh.n, sh, tile[s], gkey[s]);
      }
    }
  }
  store(tile_out, p0, budget, vec, tile);
  store(gkey_out, p0, budget, vec, gkey);
  store(owner_out, p0, budget, vec, owner);
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; num_pairs / num_dense are int32
// scalars on the device (no host sync). `chunk` is the caller's CHUNK: any
// other value than this file's is refused. Returns a cudaError_t.
int sgt_expand_pairs(const void* offsets, const void* rect_packed,
                     const void* idx, const void* cull, const void* num_pairs,
                     const void* num_dense, int n, int budget, int ntx,
                     int num_tiles, int tile_w, int tile_h, int chunk, void* tile_out,
                     void* gkey_out, void* owner_out, void* stream) {
  if (chunk != CHUNK || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (budget <= 0) return static_cast<int>(cudaSuccess);
  const bool vec = ((reinterpret_cast<uintptr_t>(tile_out) |
                     reinterpret_cast<uintptr_t>(gkey_out) |
                     reinterpret_cast<uintptr_t>(owner_out)) & 15) == 0;
  const int blocks = (budget + CHUNK - 1) / CHUNK;
  expand_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(rect_packed),
      static_cast<const int32_t*>(idx), static_cast<const float*>(cull),
      static_cast<const int32_t*>(num_pairs), static_cast<const int32_t*>(num_dense),
      Shape{n, ntx, num_tiles, tile_w, tile_h}, budget, vec,
      static_cast<int32_t*>(tile_out), static_cast<int32_t*>(gkey_out),
      static_cast<int32_t*>(owner_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
