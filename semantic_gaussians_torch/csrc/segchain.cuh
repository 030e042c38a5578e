// What the two summing kernels (segsum.cu, segsum_probe.cu) share: cp.async
// copies into shared memory (which the wide composite backward,
// composite_bwd.cu, uses too) and the slice-chain sum of their segmented
// reductions.
//
// Both kernels cut a tile of rows into slices of consecutive rows. A thread
// owns one (slice, V neighbouring columns; V is 4 where the width allows 16-byte
// accesses, else 1): it walks the slice's rows in order, carries a
// register sum while the row key stays the same and flushes when it changes.
// A run of equal keys that lies inside one slice is complete. The slice's
// first and last runs may continue in the neighbouring slices, so the walk
// leaves them in shared memory:
//
//   hkey[s], tkey[s]   key of the slice's first / last run
//   single[s]          the slice is one run (hkey == tkey, keys sorted)
//   hval[s][c]         sum of the first run (slices that are not single)
//   tval[s][c]         sum of the last run (of the whole slice if single)
//
// A chain is a maximal sequence of partial runs with one key: the last run
// of some slice k, then single slices k+1..e-1, and either the single slice
// e or the first run of slice e. `chain_sum` adds tval[k..e] in slice order,
// so a key's total is always the same tree: rows in order inside a slice,
// slices in order inside a tile.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace segchain {

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int floats) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (floats == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
  } else if (floats == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's committed groups are in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// V floats of one row: the neighbouring columns a walking thread carries.
template <int V>
struct Pack {
  float v[V];
  // p is 16-byte aligned where V == 4
  __device__ __forceinline__ static Pack load(const float* p) {
    Pack r;
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) r.v[k] = p[k];
    }
    return r;
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) p[k] = v[k];
    }
  }
  __device__ __forceinline__ void add(const Pack& o) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] += o.v[k];
  }
};

// Which slices begin a chain: one bit a slice (at most 64 slices) in two
// words of shared memory, zeroed before the walk. The thread that walks
// column 0 of slice s marks it unless the slice is single and continues the
// key of the row before it (integer atomics: the order of marking does not
// matter). Slice 0 always begins a chain.
__device__ __forceinline__ void mark_chain_begin(unsigned* begins, int s) {
  atomicOr(&begins[s >> 5], 1u << (s & 31));
}

// First slice of the chain that ends with the last run of slice e: the last
// slice at or before e that begins a chain. Read after the barrier that
// follows the walk.
__device__ __forceinline__ int chain_start(const unsigned* begins, int e) {
  const unsigned long long all = (unsigned long long)begins[1] << 32 | begins[0];
  return 63 - __clzll(all & (~0ull >> (63 - e)));
}

// Sum of the chain of slices k..e for the V columns whose per-slice sums
// start at tval[s * stride], in slice order.
template <int V>
__device__ __forceinline__ Pack<V> chain_sum(const float* tval, int stride, int k, int e) {
  Pack<V> sum = Pack<V>::load(tval + k * stride);
#pragma unroll 4
  for (int j = k + 1; j <= e; ++j) sum.add(Pack<V>::load(tval + j * stride));
  return sum;
}

}  // namespace segchain
