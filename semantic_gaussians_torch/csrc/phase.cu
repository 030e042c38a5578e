// Phase markers: one empty kernel per phase edge of a train step.
//
// A marker is launched <<<1, 1>>> on the caller's stream where a phase
// begins (utils/tracing.py), and the phase lasts on that stream until the
// next marker. A CUDA graph captures the launch as a node, so the markers
// show in a profiler's trace of every replay, where no host code runs. Each
// kernel is extern "C": the trace names it exactly `sgt_phase_<phase>`.
//
// The phases, in the order tracing.PHASES gives them (sgt_phase's `which`).

#include <cuda_runtime.h>

#define SGT_PHASES(X) \
  X(project)          \
  X(bin)              \
  X(composite)        \
  X(loss)             \
  X(feat_loss)        \
  X(feat_loss_bwd)    \
  X(obj_loss)         \
  X(reg3d)            \
  X(reg3d_bwd)        \
  X(obj_loss_bwd)     \
  X(loss_bwd)         \
  X(composite_bwd)    \
  X(segsum)           \
  X(project_bwd)      \
  X(update)           \
  X(carry)            \
  X(between)

extern "C" {

#define SGT_DEFINE(name) \
  __global__ void sgt_phase_##name() {}
SGT_PHASES(SGT_DEFINE)
#undef SGT_DEFINE

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch marker `which` (its place in SGT_PHASES) on `stream`. Returns a
// cudaError_t.
int sgt_phase(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int i = 0;
#define SGT_LAUNCH(name)                   \
  if (which == i++) {                      \
    sgt_phase_##name<<<1, 1, 0, s>>>();    \
    return static_cast<int>(cudaGetLastError()); \
  }
  SGT_PHASES(SGT_LAUNCH)
#undef SGT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
