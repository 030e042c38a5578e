// Segment-sum cost probe: the windowed chunk fold.
//
// Replaces the two TPU probe kernels of the segment-sum experiments:
// tools/exp_panel.py::_k_noslide (static_off False / True) and
// tools/exp_panel2.py::kern_a (mode "window" / "fold"). Both are one
// function with one switch. For chunk c of CHUNK = 512 consecutive pairs,
// with base[c] and off[c] precomputed by the caller (off = 0 in fold mode):
//
//   out[off[c] + j, :] += sum_i cot[i, :] * [owners[i] - base[c] == j]
//
// for 0 <= j < win, summed over ALL chunks into one [panel, D] panel. It is
// deliberately not a segment sum: it forces the whole cotangent stream to be
// read and folded, so nothing can be elided. Rows that would land outside
// [0, panel) are dropped (the caller's offsets keep off + win <= panel).
//
// Layout: cot is [P, D] row-major (the port's pair-row layout, see
// segsum.cu), out is [panel, D].
//
// The TPU kernels walk the chunks on one core in grid order, carry the
// panel in VMEM and fold each chunk with a one-hot MXU product. Here blocks
// run in parallel and in no order, so the fold is split in two kernels.
//
// What bounds it on the H100: bytes. Every cot row (D floats) and owner is
// read once, the panel is written once; one add per element read. What the
// design does about it:
//
//   1. probe_fold_kernel: one block of 512 threads per group of consecutive
//      chunks, about one group an SM.
//      * The accumulator lives in shared memory: `acc_blocks` (a power of
//        two) blocks of 128 panel rows, addressed as a ring (panel block b
//        sits in slot b % acc_blocks), which follows the chunks' windows as they move up
//        the panel. A block of rows goes to device memory only when the
//        window has moved past it (or at the end): into the group's own
//        [panel, D] partial, stored the first time and added to after that,
//        with one bit per 128-row block in the group's mask. A group
//        writes only the rows it touched.
//      * The stream is pipelined: a ring of STAGES chunks (512 x D floats
//        and 512 owners each, contiguous in device memory) is filled by
//        cp.async, 16 bytes a thread, while the block folds the chunk
//        before.
//      * Runs are found by walking, not searching: a thread owns one (slice
//        of consecutive rows, four channels; one where D is no multiple of
//        4), carries register sums while the owner stays the same and adds
//        them to the accumulator when it changes; first and last runs of the slices are joined in slice
//        order (segchain.cuh). When a chunk's owners are non-decreasing, as
//        pair owners are, every accumulator cell has one writer a chunk. A
//        chunk whose owners are out of order takes a thread per (window
//        row, channel) that scans all 512 rows: any owners are right.
//   2. probe_reduce_kernel: out[r, :] = the sum, in group order, of the
//      partials of the groups whose mask covers r (zero if none); eight
//      threads take an eighth of the groups each and are added in order.
//
// No float atomics anywhere: a cell's sum is rows in order within a slice,
// slices within a chunk, chunks within a group, groups in order. Two runs
// give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segchain.cuh"

namespace {

constexpr int CHUNK = 512;
constexpr int THREADS = 512;
constexpr int BLK = 128;      // panel rows per accumulator block and mask bit
constexpr int MAX_COPIES = 8;  // 16-byte copies a thread makes per chunk (D <= 32)
constexpr int RTHREADS = 256, RCELLS = 32, RPARTS = RTHREADS / RCELLS;

struct Shape {
  int D, win, panel;
  int slices;      // slices of a chunk
  int srows;       // rows of a slice
  int sstride;     // floats between slices in a stage
  int acc_blocks;  // accumulator blocks in shared memory, a power of two
};

// Floats of one stage of the stream: the chunk's slices, padded to 16 bytes.
__host__ __device__ inline int stage_size(const Shape& sh) {
  return (sh.slices * sh.sstride + 3) & ~3;
}

using segchain::Pack;

// STAGES chunks of the stream in shared memory; a walking thread carries V
// channels (4 where D is a multiple of 4, else 1).
template <int STAGES, int V>
__global__ void __launch_bounds__(THREADS) probe_fold_kernel(
    const float* __restrict__ cot, const int32_t* __restrict__ owners,
    const int32_t* __restrict__ base, const int32_t* __restrict__ off, int n_chunks,
    int chunks_per_block, Shape sh, float* __restrict__ partial,
    uint32_t* __restrict__ masks) {
  extern __shared__ __align__(16) float smem[];
  const int D = sh.D, SB = sh.acc_blocks;
  const int stage_floats = stage_size(sh);
  float* acc = smem;                                                  // SB x BLK x D
  float* ring = acc + SB * BLK * D;                                   // STAGES x stage_floats
  int* s_own = reinterpret_cast<int*>(ring + STAGES * stage_floats);  // STAGES x CHUNK
  float* hval = reinterpret_cast<float*>(s_own + STAGES * CHUNK);     // slices x D
  float* tval = hval + sh.slices * D;                                 // slices x D
  int* hkey = reinterpret_cast<int*>(tval + sh.slices * D);           // slices
  int* tkey = hkey + sh.slices;
  int* single = tkey + sh.slices;
  unsigned* begins2 = reinterpret_cast<unsigned*>(single + sh.slices);  // 2 x 2, by chunk parity

  const int tid = threadIdx.x;
  float* mine = partial + (size_t)blockIdx.x * sh.panel * D;
  const int c0 = blockIdx.x * chunks_per_block;
  const int c1 = min(n_chunks, c0 + chunks_per_block);

  // Where this thread's 16-byte copies of a chunk go: the same for every
  // chunk, so the slice arithmetic is done once.
  int copy_to[MAX_COPIES];
#pragma unroll
  for (int k = 0; k < MAX_COPIES; ++k) {
    const int f = 4 * (tid + k * THREADS), span = sh.srows * D;
    copy_to[k] = f < CHUNK * D ? f + f / span * (sh.sstride - span) : -1;
  }
  auto load = [&](int c) {  // chunk c into its stage; always one commit group
    if (c < c1) {
      float* dst = ring + (c - c0) % STAGES * stage_floats;
      const float* src = cot + (size_t)c * CHUNK * D + 4 * tid;
#pragma unroll
      for (int k = 0; k < MAX_COPIES; ++k) {
        if (copy_to[k] >= 0) segchain::cp_async(dst + copy_to[k], src + 4 * k * THREADS, 4);
      }
      if (tid < CHUNK / 4) {
        segchain::cp_async(s_own + (c - c0) % STAGES * CHUNK + 4 * tid,
                           owners + (size_t)c * CHUNK + 4 * tid, 4);
      }
    }
    segchain::cp_async_commit();
  };

  for (int i = tid; i < SB * BLK * D; i += THREADS) acc[i] = 0.0f;
  for (int k = 0; k < STAGES - 1; ++k) load(c0 + k);

  // Accumulator state, the same in every thread: the window holds panel
  // blocks [lo, lo + SB); `touched` marks those with sums in shared memory,
  // `written` those this group has stored to its partial.
  int lo = 0;
  uint32_t touched = 0, written = 0;
  auto flush = [&](uint32_t which) {  // callers put a barrier before and after
    for (int b = 0; b < sh.panel / BLK; ++b) {
      if (!(which >> b & 1)) continue;
      float4* a = reinterpret_cast<float4*>(acc + (b & (SB - 1)) * BLK * D);
      float4* g = reinterpret_cast<float4*>(mine + (size_t)b * BLK * D);
      const bool add = written >> b & 1;
      for (int i = tid; i < BLK * D / 4; i += THREADS) {
        float4 v = a[i];
        if (add) {
          const float4 w = g[i];
          v = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
        }
        g[i] = v;
        a[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    written |= which;
    touched &= ~which;
  };

  const int groups = D / V;  // channel groups of a row
  const int s = tid / groups, d = tid % groups * V;
  const bool walker = s < sh.slices;
  // each chunk's scalars are read one chunk ahead, off the critical path
  int b_next = c0 < c1 ? base[c0] : 0, o_next = off && c0 < c1 ? off[c0] : 0;
  for (int c = c0; c < c1; ++c) {
    const int b = b_next, o = o_next;
    if (c + 1 < c1) {
      b_next = base[c + 1];
      o_next = off ? off[c + 1] : 0;
    }
    unsigned* begins = begins2 + 2 * ((c - c0) & 1);  // last read two chunks ago
    if (tid == 0) begins[0] = 0, begins[1] = 0;
    load(c + STAGES - 1);  // into the stage of chunk c - 1, which is folded
    segchain::cp_async_wait<STAGES - 1>();
    __syncthreads();  // chunk c has landed; chunk c - 1's sums are in acc
    const int* own = s_own + (c - c0) % STAGES * CHUNK;
    const float* rows = ring + (c - c0) % STAGES * stage_floats;
    const int sorted = __syncthreads_and(tid == 0 || tid >= CHUNK || own[tid] >= own[tid - 1]);
    const int r_lo = max(o, 0), r_hi = min(o + sh.win, sh.panel);  // target rows
    if (r_hi <= r_lo) continue;
    const int nb0 = r_lo / BLK, nb1 = (r_hi - 1) / BLK;
    if (!touched) lo = nb0;
    if (nb0 < lo || nb1 >= lo + SB) {
      // The window has moved: store the blocks it leaves behind (all of
      // them if it moved back) and start the ring's window at nb0.
      const uint32_t leave = nb0 < lo ? touched : touched & ((1u << nb0) - 1u);
      __syncthreads();
      flush(leave);
      __syncthreads();
      lo = nb0;
    }
    touched |= (nb1 >= 31 ? ~0u : (1u << (nb1 + 1)) - 1u) & ~((1u << nb0) - 1u);

    // acc cell of owner g, channel ch (null if the row is dropped)
    auto cell = [&](int g, int ch) -> float* {
      const int j = g - b, r = o + j;
      if (j < 0 || j >= sh.win || r < 0 || r >= sh.panel) return nullptr;
      return acc + ((r / BLK & (SB - 1)) * BLK + r % BLK) * D + ch;
    };
    auto add_to = [&](int g, const Pack<V>& sum) {  // acc[g's row, d..d+V) += sum
      if (float* p = cell(g, d)) {
        Pack<V> a = Pack<V>::load(p);
        a.add(sum);
        a.store(p);
      }
    };
    if (sorted) {
      if (walker) {
        const int i0 = s * sh.srows, i1 = min(i0 + sh.srows, CHUNK);
        const float* col = rows + s * sh.sstride + d;
        int cur = own[i0];
        bool one = true;
        Pack<V> sum = {}, hv = {};
        // four rows a step, so that their loads are in flight together
        for (int i = i0; i < i1; i += 4) {
          int gs[4];
          Pack<V> vs[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = min(i + k, i1 - 1);
            gs[k] = own[r];
            vs[k] = Pack<V>::load(col + (r - i0) * D);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (i + k >= i1) break;
            if (gs[k] == cur) {
              sum.add(vs[k]);
              continue;
            }
            if (one) {
              hv = sum;
              one = false;
            } else {
              add_to(cur, sum);
            }
            cur = gs[k];
            sum = vs[k];
          }
        }
        hv.store(hval + s * D + d);
        sum.store(tval + s * D + d);
        if (d == 0) {
          hkey[s] = own[i0];
          tkey[s] = cur;
          single[s] = one;
          if (!(s > 0 && one && own[i0 - 1] == cur)) segchain::mark_chain_begin(begins, s);
        }
      }
      __syncthreads();
      if (walker) {
        // the sum of the chain that ends with slice e, this thread's channels
        auto chain = [&](int e) {
          return segchain::chain_sum<V>(tval + d, D, segchain::chain_start(begins, e), e);
        };
        if (!single[s]) {
          Pack<V> sum = Pack<V>::load(hval + s * D + d);
          if (s > 0 && tkey[s - 1] == hkey[s]) {
            Pack<V> before = chain(s - 1);
            before.add(sum);
            sum = before;
          }
          add_to(hkey[s], sum);
        }
        if (s == sh.slices - 1 || tkey[s] != hkey[s + 1]) add_to(tkey[s], chain(s));
      }
    } else {
      for (int idx = tid; idx < (r_hi - r_lo) * D; idx += THREADS) {
        const int r = r_lo + idx / D, ch = idx % D, g = b + r - o;
        float sum = 0.0f;
        bool any = false;
        for (int i = 0; i < CHUNK; ++i) {
          if (own[i] == g) {
            sum += rows[i / sh.srows * sh.sstride + i % sh.srows * D + ch];
            any = true;
          }
        }
        if (any) *cell(g, ch) += sum;
      }
      __syncthreads();  // the next load overwrites a stage that is read here
    }
  }
  __syncthreads();
  flush(touched);
  if (tid == 0) masks[blockIdx.x] = written;
}

__global__ void __launch_bounds__(RTHREADS) probe_reduce_kernel(
    const float* __restrict__ partial, const uint32_t* __restrict__ masks, int groups,
    int cells, int D, float* __restrict__ out) {
  __shared__ float part[RPARTS][RCELLS];
  const int lane = threadIdx.x % RCELLS, gs = threadIdx.x / RCELLS;
  const int idx = blockIdx.x * RCELLS + lane;
  const int per = (groups + RPARTS - 1) / RPARTS;
  float sum = 0.0f;
  if (idx < cells) {
    const int bit = idx / D / BLK;
    for (int g = gs * per; g < min(groups, (gs + 1) * per); ++g) {
      if (masks[g] >> bit & 1) sum += partial[(size_t)g * cells + idx];
    }
  }
  part[gs][lane] = sum;
  __syncthreads();
  if (gs == 0 && idx < cells) {
    for (int k = 1; k < RPARTS; ++k) sum += part[k][lane];
    out[idx] = sum;
  }
}

template <int STAGES, int V>
cudaError_t launch_fold(const float* cot, const int32_t* owners, const int32_t* base,
                        const int32_t* off, int n_chunks, int chunks_per_block, int groups,
                        const Shape& sh, size_t smem, float* partial, uint32_t* masks,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(probe_fold_kernel<STAGES, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  probe_fold_kernel<STAGES, V><<<groups, THREADS, smem, s>>>(
      cot, owners, base, off, n_chunks, chunks_per_block, sh, partial, masks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers, cot and owners 16-byte aligned. cot
// [n_chunks * 512, D] float32, owners [n_chunks * 512] int32, base
// [n_chunks] int32, off [n_chunks] int32 or null (fold: every offset 0),
// partial [groups, panel, D] float32 and masks [groups] int32 scratch
// (neither need be zeroed), out [panel, D] float32. `stages` (2 to 4) chunks
// of the stream and `acc_blocks` (a power of two, at least a window and a
// block: 8) blocks of 128 accumulator rows are held in shared memory; the
// wrapper sizes them to fit. Launches two kernels. Returns a cudaError_t.
int sgt_segsum_probe(const void* cot, const void* owners, const void* base,
                     const void* off, int n_chunks, int D, int win, int panel,
                     int groups, int chunks_per_block, int stages, int acc_blocks,
                     void* partial, void* masks, void* out, void* stream) {
  if (n_chunks <= 0 || D <= 0 || D > 4 * MAX_COPIES || panel <= 0 || panel % BLK ||
      panel / BLK > 32 || win <= 0 || groups <= 0 ||
      (long long)groups * chunks_per_block < n_chunks || stages < 2 || stages > 4 ||
      acc_blocks & (acc_blocks - 1) || acc_blocks * BLK < win + BLK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  sh.D = D;
  sh.win = win;
  sh.panel = panel;
  // Walkers: a thread a (slice, group of V channels), slices of 8 rows or more.
  const int v = D % 4 ? 1 : 4;
  const int want = THREADS / (D / v) < CHUNK / 8 ? THREADS / (D / v) : CHUNK / 8;
  sh.srows = (CHUNK + want - 1) / want;
  sh.slices = (CHUNK + sh.srows - 1) / sh.srows;
  const int span = sh.srows * D;
  // Slices apart by a stride that spreads a warp's threads over the banks,
  // where a slice is a whole number of 16-byte copies (see segsum.cu).
  sh.sstride = span % 4 ? span : span + ((((D + 3) & ~3) - span) % 32 + 32) % 32;
  sh.acc_blocks = acc_blocks < panel / BLK ? acc_blocks : panel / BLK;
  const size_t smem =
      sizeof(float) * ((size_t)sh.acc_blocks * BLK * D + (size_t)stages * stage_size(sh) +
                       2 * sh.slices * D) +
      sizeof(int) * (stages * CHUNK + 3 * sh.slices + 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cot);
  const int32_t* o = static_cast<const int32_t*>(owners);
  const int32_t* b = static_cast<const int32_t*>(base);
  const int32_t* f = static_cast<const int32_t*>(off);
  float* p = static_cast<float*>(partial);
  uint32_t* m = static_cast<uint32_t*>(masks);
  auto fold = v == 4 ? (stages == 4   ? launch_fold<4, 4>
                        : stages == 3 ? launch_fold<3, 4>
                                      : launch_fold<2, 4>)
                     : (stages == 4   ? launch_fold<4, 1>
                        : stages == 3 ? launch_fold<3, 1>
                                      : launch_fold<2, 1>);
  cudaError_t err = fold(c, o, b, f, n_chunks, chunks_per_block, groups, sh, smem, p, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cells = panel * D;
  probe_reduce_kernel<<<(cells + RCELLS - 1) / RCELLS, RTHREADS, 0, s>>>(
      p, m, groups, cells, D, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
