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
// run in parallel and in no order, so the fold is split in two kernels:
//
//   1. probe_partial_kernel: one block of 256 threads per group of
//      consecutive chunks. The block zeroes its own [panel, D] partial panel
//      in global scratch, then takes its chunks in order. Per chunk it loads
//      the 512 window columns (owners - base) into shared memory, finds the
//      touched column range [lo, hi] with integer shared atomics, and gives
//      each thread one (column j, channel d) of that range: the thread sums
//      the chunk's rows whose column is j in row order (binary search of the
//      run when the chunk's columns are non-decreasing, as pair owners are;
//      a scan of all 512 columns otherwise) and adds the sum to its block's
//      partial panel. One writer per element, fixed order.
//   2. probe_reduce_kernel: out[r, d] = sum over groups, in group order.
//
// No float atomics anywhere, so two runs give the same bits.
//
// What bounds it on the H100: bytes. Every cot row (D floats) and owner is
// read once, the panel is written once; one add per element read. The
// partial panels (groups x panel x D floats, zeroed, updated and reduced)
// are traffic on top of that bound, mostly served from L2.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 512;
constexpr int THREADS = 256;

// First i in [0, CHUNK) with col[i] >= j (CHUNK if none); col non-decreasing.
__device__ __forceinline__ int lower_bound(const int* col, int j) {
  int lo = 0, hi = CHUNK;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] < j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) probe_partial_kernel(
    const float* __restrict__ cot, const int32_t* __restrict__ owners,
    const int32_t* __restrict__ base, const int32_t* __restrict__ off, int n_chunks,
    int D, int win, int panel, int chunks_per_block, float* __restrict__ partial) {
  __shared__ int s_col[CHUNK];
  __shared__ int s_lo, s_hi;
  const int tid = threadIdx.x;
  float* mine = partial + (size_t)blockIdx.x * panel * D;
  for (int idx = tid; idx < panel * D; idx += THREADS) mine[idx] = 0.0f;
  const int c0 = blockIdx.x * chunks_per_block;
  const int c1 = min(n_chunks, c0 + chunks_per_block);
  for (int c = c0; c < c1; ++c) {
    const int b = base[c];
    const int o = off ? off[c] : 0;
    const size_t first_row = (size_t)c * CHUNK;
    if (tid == 0) {
      s_lo = INT_MAX;
      s_hi = -1;
    }
    int lmin = INT_MAX, lmax = -1;
    for (int i = tid; i < CHUNK; i += THREADS) {
      const int col = owners[first_row + i] - b;
      s_col[i] = col;
      if (col >= 0 && col < win) {
        lmin = min(lmin, col);
        lmax = max(lmax, col);
      }
    }
    __syncthreads();  // s_col, and thread 0's reset of s_lo / s_hi
    bool ordered = true;
    for (int i = max(tid, 1); i < CHUNK; i += THREADS) {
      ordered = ordered && s_col[i] >= s_col[i - 1];
    }
    if (lmax >= 0) {
      atomicMin(&s_lo, lmin);
      atomicMax(&s_hi, lmax);
    }
    const int sorted = __syncthreads_and(ordered);
    const int lo = s_lo, hi = s_hi;
    const int cells = hi >= lo ? (hi - lo + 1) * D : 0;
    for (int idx = tid; idx < cells; idx += THREADS) {
      const int j = lo + idx / D, d = idx % D;
      const int row = o + j;
      if (row < 0 || row >= panel) continue;
      const float* src = cot + first_row * D + d;
      float acc = 0.0f;
      bool any = false;
      if (sorted) {
        const int i0 = lower_bound(s_col, j), i1 = lower_bound(s_col, j + 1);
        any = i1 > i0;
        for (int i = i0; i < i1; ++i) acc += src[(size_t)i * D];
      } else {
        for (int i = 0; i < CHUNK; ++i) {
          if (s_col[i] == j) {
            acc += src[(size_t)i * D];
            any = true;
          }
        }
      }
      if (any) mine[(size_t)row * D + d] += acc;
    }
    // The next chunk rewrites s_col / s_lo / s_hi, and another thread of
    // this block may own the same partial element then.
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) probe_reduce_kernel(
    const float* __restrict__ partial, int groups, int cells, float* __restrict__ out) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= cells) return;
  float acc = 0.0f;
  for (int g = 0; g < groups; ++g) acc += partial[(size_t)g * cells + idx];
  out[idx] = acc;
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers. cot [n_chunks * 512, D] float32, owners
// [n_chunks * 512] int32, base [n_chunks] int32, off [n_chunks] int32 or
// null (fold: every offset 0), partial [groups, panel, D] float32 scratch
// (need not be zeroed), out [panel, D] float32. Launches two kernels.
// Returns a cudaError_t.
int sgt_segsum_probe(const void* cot, const void* owners, const void* base,
                     const void* off, int n_chunks, int D, int win, int panel,
                     int groups, int chunks_per_block, void* partial, void* out,
                     void* stream) {
  if (n_chunks <= 0 || D <= 0 || panel <= 0 || groups <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_partial_kernel<<<groups, THREADS, 0, s>>>(
      static_cast<const float*>(cot), static_cast<const int32_t*>(owners),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(off), n_chunks, D,
      win, panel, chunks_per_block, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cells = panel * D;
  probe_reduce_kernel<<<(cells + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(partial), groups, cells, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
