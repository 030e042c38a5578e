// Adam over every leaf of a train state: one launch a step.
//
// Replaces no TPU kernel: the JAX package's Adam (core/optimizer.py) is
// left to XLA, which fuses each leaf's update into one pass. The port's
// plain version (core/optimizer.adam_update's loop) is ~14 torch
// elementwise ops a leaf, each of which reads one or two leaf-sized tensors
// from device memory and writes one: ~6x the bytes the update needs, and
// the largest phase of the RGB train step.
//
// What bounds it on the H100: bytes. Each element reads p, g, m and v once
// and writes p', m' and v' once, 28 B; a few float32 operations (three
// IEEE divisions and a square root among them) are far below the bytes.
// At 1M Gaussians and SH degree 3 a state holds 59 floats a slot (1.65 GB
// moved, 0.49 ms at 3.35 TB/s); a 512-wide feature field adds 512 (16.0 GB).
//
// What the design does about it:
// * One launch walks every leaf. The host hands in a table of leaves
//   (pointers to p, g, m, v, the three outputs and the leaf's learning
//   rate, its element count and its eps); the grid's blocks are laid out
//   leaf after leaf, so a small leaf (opacity, 1M floats) runs beside the
//   others and leaves no tail of its own. Each leaf has its own eps:
//   Gaussian Grouping's classifier (weight and bias) is a second Adam, at
//   eps 1e-8 beside the Gaussians' 1e-15, and steps in the same launch.
// * A block covers CHUNK consecutive floats of one leaf, PER floats a
//   thread at a stride of THREADS, so each load and store of a warp is one
//   coalesced 128-byte line; a thread issues all its loads before any
//   arithmetic. One path for every leaf: no alignment or length is asked.
//   Two floats a thread come within 0.3% of float4 loads and stores on the
//   H100 at the train cells' shapes; one a thread is 3% slower (12% at a
//   512-wide field), four 0.7%.
// * A gradient need only have contiguous rows: autograd hands the train
//   step the SH leaves' and the feature field's gradients as slices of one
//   joined gradient ([N, 16, 3] and [N, 3 + D], cut by the concatenation's
//   backward), rows of w floats at a row stride of more. Such a gradient is
//   read where it lies (a copy would move its bytes twice): a float's row
//   and column come from its index, by one 32-bit division.
// * The bias corrections bc1 = 1 - b1^t and bc2 = 1 - b2^t and each leaf's
//   learning rate are read from device memory, where torch computed them
//   in the same step: the kernel allocates nothing, never synchronises and
//   launches on the caller's stream, so the train step's CUDA graph
//   captures it and every replay sees its own step's values.
// * The outputs are fresh tensors (the wrapper's): the update is
//   functional, as the plain loop is, and a graph's carry buffers (its
//   inputs) are left as they are.
//
// Rounding: the same operations in the same order as the plain loop, each
// rounded once (the library is built with -fmad=false, and divisions and
// the square root are IEEE):
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p - (lr * (m' / bc1)) / (sqrt(v' / bc2) + eps)
// with the Python constants b1, 1 - b1, b2, 1 - b2 and each leaf's eps
// rounded to float32 as torch rounds a scalar operand, so kernel and loop
// agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 12;
constexpr int THREADS = 256;
constexpr int PER = 2;                      // floats a thread
constexpr long long CHUNK = THREADS * PER;  // floats a block
constexpr int PTRS = 8;  // a leaf's pointers: p, g, m, v, p', m', v', lr

struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  const float* lr;
  long long n;      // elements
  long long w;      // a row's elements (a slot's floats)
  long long gs;     // the gradient's row stride in elements (w where it is contiguous)
  long long first;  // the leaf's first block in the grid
  float eps;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int count;
  const float* bc1;
  const float* bc2;
  float b1, omb1, b2, omb2;
};

__global__ void __launch_bounds__(THREADS) adam_kernel(const Table t) {
  // This block's leaf: the last one that starts at or before it. Each
  // field is picked at a fixed index of the table, so the table stays in
  // the kernel's parameter space.
  const long long b = blockIdx.x;
  Leaf L = t.leaf[0];
#pragma unroll
  for (int i = 1; i < MAX_LEAVES; ++i) {
    if (i < t.count && b >= t.leaf[i].first) L = t.leaf[i];
  }
  const float bc1 = *t.bc1, bc2 = *t.bc2, lr = *L.lr;
  // the block's first float e0 lies in row r0 at column c0 of the gradient
  const long long e0 = (b - L.first) * CHUNK;
  const bool flat = L.gs == L.w;
  const unsigned w = static_cast<unsigned>(L.w);
  const long long r0 = flat ? 0 : e0 / L.w;
  const unsigned c0 = flat ? 0 : static_cast<unsigned>(e0 - r0 * L.w);

  float p[PER], g[PER], m[PER], v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const unsigned off = threadIdx.x + u * THREADS;
    const long long j = e0 + off;
    if (j < L.n) {
      long long gj = j;
      if (!flat) {
        const unsigned c = c0 + off, r = c / w;
        gj = (r0 + r) * L.gs + (c - r * w);
      }
      p[u] = L.p[j];
      g[u] = L.g[gj];
      m[u] = L.m[j];
      v[u] = L.v[j];
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const long long j = e0 + threadIdx.x + u * THREADS;
    if (j < L.n) {
      const float m1 = t.b1 * m[u] + t.omb1 * g[u];
      const float v1 = t.b2 * v[u] + (t.omb2 * g[u]) * g[u];
      L.p_out[j] = p[u] - (lr * (m1 / bc1)) / (sqrtf(v1 / bc2) + L.eps);
      L.m_out[j] = m1;
      L.v_out[j] = v1;
    }
  }
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One Adam step over `leaves` leaves. `ptrs` (host memory) holds PTRS
// device pointers a leaf, in the order p, g, m, v, p', m', v', lr (lr a
// float32 scalar); `sizes` (host) three numbers a leaf: its element count,
// a row's elements w and the gradient's row stride (w where the gradient
// is contiguous; p, m, v and the outputs are); `eps` (host) a leaf's eps.
// bc1 and bc2 are float32 device scalars. b1, omb1 = 1 - b1, b2, omb2 =
// 1 - b2 and each eps are float32 as torch rounds them. Leaves of no
// elements are skipped. Returns a cudaError_t.
int sgt_adam(const void* const* ptrs, const long long* sizes, const float* eps, int leaves,
             const void* bc1, const void* bc2, float b1, float omb1, float b2, float omb2,
             void* stream) {
  if (leaves < 0 || leaves > MAX_LEAVES) return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.bc1 = static_cast<const float*>(bc1);
  t.bc2 = static_cast<const float*>(bc2);
  t.b1 = b1;
  t.omb1 = omb1;
  t.b2 = b2;
  t.omb2 = omb2;
  long long blocks = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long n = sizes[3 * i], w = sizes[3 * i + 1], gs = sizes[3 * i + 2];
    if (n <= 0) continue;
    if (w <= 0 || w > 0x7fffffffLL - CHUNK || n % w || gs < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* const* q = ptrs + PTRS * i;
    Leaf& L = t.leaf[t.count++];
    L.p = static_cast<const float*>(q[0]);
    L.g = static_cast<const float*>(q[1]);
    L.m = static_cast<const float*>(q[2]);
    L.v = static_cast<const float*>(q[3]);
    L.p_out = static_cast<float*>(const_cast<void*>(q[4]));
    L.m_out = static_cast<float*>(const_cast<void*>(q[5]));
    L.v_out = static_cast<float*>(const_cast<void*>(q[6]));
    L.lr = static_cast<const float*>(q[7]);
    L.n = n;
    L.w = w;
    L.gs = gs;
    L.eps = eps[i];
    L.first = blocks;
    blocks += (L.n + CHUNK - 1) / CHUNK;
  }
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  adam_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
