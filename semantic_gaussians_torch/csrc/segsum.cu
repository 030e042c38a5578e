// Contiguous segment sum: out[g, :] = sum of rows i of cot with owners[i] == g.
//
// Replaces the TPU kernels semantic_gaussians_tpu/ops/segsum.py::_kernel_vmem
// and ::_kernel_panel (run by segsum_contiguous from ops/rasterize.py's
// pack_gather VJP). Those two compute one function and differ only in how
// a TPU's VMEM holds the accumulator (whole, or a rolling panel); a GPU
// needs neither, so this one kernel replaces both.
//
// Layout: cot is [P, D] row-major (a pair's gradient row is contiguous, as
// the composite backward writes it), out is [num_rows, D]. owners is
// non-decreasing (generation-order pair owners); the kernel relies only on
// that, not on the steps of at most 1 that the JAX kernels need. Rows at
// or past *limit (when given: the valid pair count) are treated as zero, so
// the long tail of invalid slots, which all share the last owner, is never
// read.
//
// Grid: one block of 256 threads per group of S = max(1, 256 / D)
// consecutive segments. The block finds its S + 1 segment boundaries by
// binary search over owners, then each thread takes one (segment, column)
// and sums the segment's rows in row order. No float atomics: each output
// element has one writer and a fixed summation order, so two runs give the
// same bits. Neighbouring threads read neighbouring columns of the same or
// the next rows, so the loads coalesce.
//
// What bounds it on the H100: bytes. Each live row is read once (D floats)
// and each output row written once; one add per element read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// First i in [0, n) with owners[i] >= g (n if none).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ owners, int n,
                                           int g) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (owners[mid] < g) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) segsum_kernel(
    const float* __restrict__ cot, const int32_t* __restrict__ owners,
    const int32_t* __restrict__ limit, int P, int D, int num_rows, int segs,
    float* __restrict__ out) {
  extern __shared__ int s_bound[];  // segs + 1
  const int g0 = blockIdx.x * segs;
  const int ns = min(segs, num_rows - g0);
  const int n = limit ? max(0, min(*limit, P)) : P;
  for (int k = threadIdx.x; k <= ns; k += blockDim.x) {
    s_bound[k] = lower_bound(owners, n, g0 + k);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ns * D; idx += blockDim.x) {
    const int s = idx / D, d = idx % D;
    float acc = 0.0f;
    for (int i = s_bound[s]; i < s_bound[s + 1]; ++i) acc += cot[(size_t)i * D + d];
    out[(size_t)(g0 + s) * D + d] = acc;
  }
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; limit may be null. Returns a cudaError_t.
int sgt_segsum(const void* cot, const void* owners, const void* limit, int P,
               int D, int num_rows, void* out, void* stream) {
  if (num_rows <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const int segs = D >= THREADS ? 1 : THREADS / D;
  const int blocks = (num_rows + segs - 1) / segs;
  segsum_kernel<<<blocks, THREADS, (segs + 1) * sizeof(int),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cot), static_cast<const int32_t*>(owners),
      static_cast<const int32_t*>(limit), P, D, num_rows, segs,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
