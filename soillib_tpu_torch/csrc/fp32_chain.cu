// FP32 throughput probe on Hopper (sm_90a).
//
// Replaces the TPU kernel of bench.py `_vpu_chain_time` (the Pallas kernel
// at bench.py:98, launched at :114): K = 4 independent chains per element,
// carried across `reps` rounds of U = 16 applications of one op, then the
// chains' sum written out so that nothing is dead code. The JAX bench times
// it to price the cohort round's operations (`measure_vpu`); the port's
// bench (soillib_tpu_torch/bench.py) does the same with this kernel.
//
//   x   (n,) float32   chain seeds; chain k starts at x * (1 + 0.001 k)
//   out (n,) float32   the K chains' sum after reps x U applications
//
// The op is a template parameter, so each timed launch issues exactly one
// kind of instruction sequence:
//   FMA   __fmaf_rn(y, 1.0000001f, 1e-9f)             one FFMA
//   FMA2  the same twice, constants 1.0000001/0.9999999 two FFMA
//   EXP   expf(-y) + 0.1f
//   DIV   1.5f / (y + 1.0f)
//   SQRT  sqrtf(y + 0.25f)
// The FMA is written as the intrinsic because the package builds with
// -fmad=false (soillib_tpu_torch/_native.py), which would otherwise split
// y * a + b into a multiply and an add. EXP, DIV and SQRT are compiled
// with the package's own flags (no --use_fast_math, IEEE division and
// square root), so the cost weights the bench derives from them price the
// very expf, division and sqrtf that csrc/cohort_round.cu executes.
//
// Bound: operations, n x K x U x reps of them, at the card's FP32 issue
// rate (132 SMs x 128 lanes x the SM clock; one FFMA per lane and cycle).
// The design keeps every SM's four schedulers issuing: the TPU kernel's
// (8, 1024) VMEM block has no meaning here; instead the wrapper launches
// several 256-thread blocks per SM, and each thread carries K = 4
// independent chains, enough independent FFMAs to cover their latency.
// Memory traffic is 8 bytes per thread per launch, nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K = 4;
constexpr int U = 16;
constexpr int NTHREADS = 256;

enum Op { FMA = 0, FMA2 = 1, EXP = 2, DIV = 3, SQRT = 4 };

template <int OP>
__device__ __forceinline__ float apply(float y) {
  if constexpr (OP == FMA) {
    return __fmaf_rn(y, 1.0000001f, 1e-9f);
  } else if constexpr (OP == FMA2) {
    return __fmaf_rn(__fmaf_rn(y, 1.0000001f, 1e-9f), 0.9999999f, 1e-9f);
  } else if constexpr (OP == EXP) {
    return expf(-y) + 0.1f;
  } else if constexpr (OP == DIV) {
    return 1.5f / (y + 1.0f);
  } else {
    return sqrtf(y + 0.25f);
  }
}

template <int OP>
__global__ void __launch_bounds__(NTHREADS)
fp32_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int n, int reps) {
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float x0 = x[i];
  float y[K];
#pragma unroll
  for (int k = 0; k < K; ++k) y[k] = x0 * (float)(1.0 + 0.001 * k);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) y[k] = apply<OP>(y[k]);
    }
  }
  float acc = y[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = acc + y[k];
  out[i] = acc;
}

template <int OP>
cudaError_t launch(const float* x, float* out, int n, int reps,
                   cudaStream_t stream) {
  const int blocks = (n + NTHREADS - 1) / NTHREADS;
  fp32_chain_kernel<OP><<<blocks, NTHREADS, 0, stream>>>(x, out, n, reps);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes by ops/fp32_chain.py). op: 0 fma,
// 1 fma2, 2 exp, 3 div, 4 sqrt. Returns the CUDA error of the launch.
extern "C" int fp32_chain_launch(int op, const float* x, float* out, int n,
                                 int reps, cudaStream_t stream) {
  if (n <= 0 || reps < 0) return (int)cudaErrorInvalidValue;
  switch (op) {
    case FMA: return (int)launch<FMA>(x, out, n, reps, stream);
    case FMA2: return (int)launch<FMA2>(x, out, n, reps, stream);
    case EXP: return (int)launch<EXP>(x, out, n, reps, stream);
    case DIV: return (int)launch<DIV>(x, out, n, reps, stream);
    case SQRT: return (int)launch<SQRT>(x, out, n, reps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
