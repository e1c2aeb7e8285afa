// One round of the linear upwind transport sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel soillib_tpu/ops/sweep.py:_sweep_kernel (its
// Pallas launch is `_sweep_call`, driven by `transport_advance`). That
// kernel runs K = 16 rounds per device-memory pass on VMEM windows with a
// K-cell halo; this one runs ONE round per launch, exactly as the plain
// version (soillib_tpu_torch/ops/sweep.py `upwind_push_cf`) does:
//
//   out = PUSH(att * (E + G)),  all (C, W, H) float32, channel-first,
//   x-major (index = (c * W + x) * H + y); vx, vy (W, H) unit directions.
//
// PUSH sends a cell's payload toward +x/-x/+y/-y in the ratio |vx| : |vy|
// of its own direction (`_round_weights`, computed here from vx, vy, two
// fewer streams than four stored masks). Each receiving cell gathers the +x
// payload of (x-1, y), the -x payload of (x+1, y), the +y payload of
// (x, y-1) and the -y payload of (x, y+1) and adds them in that order, the
// term order of `upwind_push_cf`. A donor outside the domain contributes
// +0.0, the zero pad of the plain version, so outflow across the domain
// edge is lost (particles exit, path.cu:104) and nothing wraps.
//
// Design. One thread per cell, blocks of 32 (y) x 8 (x) threads so a warp
// reads 32 consecutive floats. The four donor weights are computed once per
// cell and reused across the C channels; a donor's payload is recomputed by
// each of its (up to four) receivers from reads the caches serve.
//
// Bound. A round must read G, E, att (3C floats) and vx, vy (2) and write
// out (C) per cell: (4C + 2) * 4 B per cell-round, 120 B at C = 7 and 24 B
// at C = 1; at 4096^2 that is 0.12 ms (C = 1) and 0.60 ms (C = 7) at the
// H100's 3.35 TB/s. A handful of float operations per cell and channel
// leave it bytes-bound. K-round temporal blocking in shared memory (fewer
// bytes per round, as the TPU kernel does) is later work.
//
// Build without --use_fast_math and with -fmad=false
// (soillib_tpu_torch/_native.py): the plain version rounds every multiply,
// add and divide on its own, and the kernel matches it bitwise.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BY = 32;  // threads along y (contiguous)
constexpr int BX = 8;   // threads along x

// `_round_weights`: the share of a cell's payload leaving toward +x, -x,
// +y, -y.
struct Weights {
  float xp, xn, yp, yn;
};

__device__ __forceinline__ Weights round_weights(float vx, float vy) {
  const float ax = fabsf(vx), ay = fabsf(vy);
  float denom = ax + ay;
  denom = denom == 0.0f ? 1.0f : denom;
  const float wx = ax / denom, wy = ay / denom;
  return {vx > 0.0f ? wx : 0.0f, vx < 0.0f ? wx : 0.0f,
          vy > 0.0f ? wy : 0.0f, vy < 0.0f ? wy : 0.0f};
}

__global__ void __launch_bounds__(BX* BY)
transport_round_kernel(const float* __restrict__ G,
                       const float* __restrict__ E,
                       const float* __restrict__ att,
                       const float* __restrict__ vx,
                       const float* __restrict__ vy, float* __restrict__ out,
                       int C, int W, int H) {
  const int y = blockIdx.x * BY + threadIdx.x;
  const int x = blockIdx.y * BX + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t WH = (size_t)W * H;
  const size_t i = (size_t)x * H + y;
  const bool hxm = x > 0, hxp = x + 1 < W, hym = y > 0, hyp = y + 1 < H;
  // Weight of each donor toward this cell (0 for a missing donor).
  const float m1 = hxm ? round_weights(vx[i - H], vy[i - H]).xp : 0.0f;
  const float m2 = hxp ? round_weights(vx[i + H], vy[i + H]).xn : 0.0f;
  const float m3 = hym ? round_weights(vx[i - 1], vy[i - 1]).yp : 0.0f;
  const float m4 = hyp ? round_weights(vx[i + 1], vy[i + 1]).yn : 0.0f;
  for (int c = 0; c < C; ++c) {
    const float* g = G + c * WH;
    const float* e = E + c * WH;
    const float* a = att + c * WH;
    float t1 = 0.0f, t2 = 0.0f, t3 = 0.0f, t4 = 0.0f;
    if (hxm) t1 = (a[i - H] * (e[i - H] + g[i - H])) * m1;
    if (hxp) t2 = (a[i + H] * (e[i + H] + g[i + H])) * m2;
    if (hym) t3 = (a[i - 1] * (e[i - 1] + g[i - 1])) * m3;
    if (hyp) t4 = (a[i + 1] * (e[i + 1] + g[i + 1])) * m4;
    out[c * WH + i] = ((t1 + t2) + t3) + t4;
  }
}

}  // namespace

// C entry point (bound with ctypes by ops/sweep.py): one round from G into
// `out` (a separate buffer). Returns the CUDA error of the launch (0 on
// success).
extern "C" int transport_round_launch(const float* G, const float* E,
                                      const float* att, const float* vx,
                                      const float* vy, float* out, int C,
                                      int W, int H, cudaStream_t stream) {
  if (C <= 0 || W <= 0 || H <= 0 || (W + BX - 1) / BX > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(BY, BX);
  const dim3 grid((H + BY - 1) / BY, (W + BX - 1) / BX);
  transport_round_kernel<<<grid, block, 0, stream>>>(G, E, att, vx, vy, out,
                                                     C, W, H);
  return (int)cudaGetLastError();
}
