// Phase marks of the captured erosion step on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's step is one XLA program, whose
// phases the TPU profiler names by its HLO ops. A CUDA graph replay shows
// only a flat run of kernels, so the port captures one empty kernel per
// phase boundary into the step's graph (soillib_tpu_torch/core/trace.py
// `mark`, under stream capture only). Each mark is its own kernel, so its
// name in a device trace says where the step is: soil_mark_<name>, with
// <name> one of core/trace.py `MARKS`. perfbench/marks.py reads the
// phases off the marks' device start times.
//
// Bound: none; one block of one thread that does no work. A graph runs its
// nodes in the order of the capturing stream, so a mark starts after every
// node captured before it has finished and before any node captured after
// it starts. Its cost is one kernel node, a microsecond or two a mark.
//
// The names are extern "C" so that the trace shows them unmangled.

#include <cuda_runtime.h>

#define SOIL_MARK(name) \
  extern "C" __global__ void soil_mark_##name() {}

SOIL_MARK(step_begin)
SOIL_MARK(fluvial_end)
SOIL_MARK(debris_end)
SOIL_MARK(update_end)
SOIL_MARK(step_end)

#undef SOIL_MARK

namespace {

// In the order of core/trace.py MARKS.
const void* const kMarks[] = {
    (const void*)soil_mark_step_begin, (const void*)soil_mark_fluvial_end,
    (const void*)soil_mark_debris_end, (const void*)soil_mark_update_end,
    (const void*)soil_mark_step_end};
constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// C entry points (bound with ctypes by core/trace.py).

// Loads every mark kernel into the current context, so that no module is
// loaded lazily while a stream is being captured. Returns the CUDA error.
extern "C" int soil_mark_prepare() {
  for (int i = 0; i < kNumMarks; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kMarks[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Launches mark `which` (an index into MARKS) on `stream`. Returns the
// CUDA error of the launch.
extern "C" int soil_mark_launch(int which, cudaStream_t stream) {
  switch (which) {
    case 0: soil_mark_step_begin<<<1, 1, 0, stream>>>(); break;
    case 1: soil_mark_fluvial_end<<<1, 1, 0, stream>>>(); break;
    case 2: soil_mark_debris_end<<<1, 1, 0, stream>>>(); break;
    case 3: soil_mark_update_end<<<1, 1, 0, stream>>>(); break;
    case 4: soil_mark_step_end<<<1, 1, 0, stream>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
