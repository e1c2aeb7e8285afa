// The particle estimators' trajectory loop on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the Monte-Carlo estimators
// (soillib_tpu/models/erosion.py `_fluvial_particles`, `_debris_particles`)
// as XLA gathers, elementwise rounds and scatter-adds. On the card the same
// loop in plain torch (soillib_tpu_torch/models/erosion.py
// `_particle_rounds_plain`) is ~114 small kernels a round, 255 rounds an
// estimator at the flagship's maxage 256: launch-bound. This kernel is the
// reference's own design (erosion.cu:29-141, `__transport_fluvial`): one
// thread a particle runs its whole trajectory with its state in registers
// and adds its deposits into the cell-major flux with atomics.
//
//   state  px, py, spx, spy (N) float; ind (N) int64, the x-major cell;
//          alive (N) bool; att (A, N) the attenuations; src (C, N) the
//          sources, which travel with their particle
//   cell4  (W*H) float4 (gx, gy, mx, my): the Godunov gradient and the
//          momentum at each cell, packed by the wrapper
//   dis    (W*H) float, the discharge (fluvial only)
//   flux   (W*H, 8) float, cell-major, padded to 8 channels: flux[:, :C]
//          += deposits; the padding stays 0
//
// KIND 0 fluvial: C = 7 deposits (w, m, vx, vy, a0, a1, a2) under A = 3
// attenuations (w, m, v); KIND 1 debris: C = 6 (d, vx, vy, a0, a1, a2)
// under A = 2 (d, v). `Kind<KIND>::sel` maps a deposit to its attenuation.
//
// Each round does what the plain loop does, in its order and with its
// operations: the in-bounds test; the cell the particle is in, and on
// entering a new one the deposit src * att[sel]; the unit speed, its
// _EPS test and the DDA step (`_stepsize_xy`: fminf/fmaxf, which keep the
// non-NaN operand as torch.fmin/fmax do); the estimator's `advance`
// (models/erosion.py `FluvialAdvance`, `DebrisAdvance`) at the new cell;
// the move. Built with -fmad=false and without fast math
// (soillib_tpu_torch/_native.py), with expf, sqrtf, IEEE division and
// truncating casts, so each particle's trajectory is bitwise the plain
// loop's on the card; only the order in which different particles' deposits
// add into a cell differs (the atomics' order, which changes from run to
// run). A particle that dies (out of bounds, or a speed below _EPS) stays
// dead and deposits nothing more, so its thread leaves the loop.
//
// Bound. A live particle-round reads 4 (debris) or 5 (fluvial) floats of
// per-cell fields at its cell (16 or 20 B) and, on entering a cell, adds 6
// or 7 floats (24 or 28 B) with reductions whose result is unused (RED):
// at 3.35 TB/s, the flagship's ~2.1M particle-rounds an estimator need
// ~0.03 ms. The loop is a chain of dependent steps (a lookup, then expf and
// divisions, then the next position), and every lookup and deposit goes to
// a scattered address, one L2 request each: so the design cuts requests.
// The lookups are one 16-byte load of the packed (gx, gy, mx, my) and, for
// fluvial, one of dis, issued as soon as the round knows its cell; the
// deposits are two 16-byte vector reductions into the flux row, padded to
// 8 floats (32 B, one sector) where 7 scalar ones would be 7 requests. The
// fields (1.3 MB at 256^2) stay in L2 and are read through the read-only
// path, and blocks of BLOCK = 64 threads spread the flagship's 8192
// particles over 128 of the 132 SMs.
//
// Live particle-rounds (the rounds a particle starts in bounds and alive)
// are summed per block and added, one atomic a block, to the kind's 64-bit
// counter in `live_rounds`, a variable of this module on each device (no
// allocation of the caller's holds it): particle_rounds_read reads it and
// particle_rounds_reset sets it to 0.
//
// With a log (the wrapper's path under torch.use_deterministic_algorithms):
// one round a launch; every particle writes its cell and its deposits (0
// where it entered none, or is dead) to log_ind / log_val, (N) and (N, C),
// for a deterministic index_add_, and the launch writes the state back.

#include <cuda_runtime.h>
#include <math.h>

// Constants are rounded from their double values, as the Python code's
// float literals are (a decimal-to-float literal can differ in the last bit).
#define F32(x) ((float)(x))

namespace {

constexpr int FLUVIAL = 0;
constexpr int DEBRIS = 1;
// Threads a block: the flagship's 8192 particles fill 128 of 132 SMs.
constexpr int BLOCK = 64;

constexpr float EPS = F32(1e-12);
constexpr float SQRT2 = F32(1.4142135623730951);
// The smallest normal float32 (models/erosion.py `_TINY`).
constexpr float TINY = 1.17549435e-38f;

template <int KIND>
struct Kind;

// The live particle-rounds of each kind that ran on this device.
__device__ unsigned long long live_rounds[2];

// sel(c): the attenuation of deposit c, from the table `SEL`, which
// models/erosion.py `FluvialAdvance.sel` and `DebrisAdvance.sel` equal
// (tests/test_torch_particles.py reads it from this file).
template <>
struct Kind<FLUVIAL> {
  static constexpr int C = 7;
  static constexpr int A = 3;
  static __host__ __device__ constexpr int sel(int c) {
    constexpr int SEL[C] = {0, 1, 2, 2, 1, 1, 1};
    return SEL[c];
  }
};

template <>
struct Kind<DEBRIS> {
  static constexpr int C = 6;
  static constexpr int A = 2;
  static __host__ __device__ constexpr int sel(int c) {
    constexpr int SEL[C] = {0, 1, 1, 0, 0, 0};
    return SEL[c];
  }
};

}  // namespace

// The launch's scalars (ops/particles.py `_Params`). r: the estimator's
// constants as `kernel_scalars()` gives them:
//   fluvial g, nu, force x, force y, tau + nu, fD / 8, evapRate, kd
//   debris  g, nu, tau, theta, yield stress, kdd, kds, (unused)
struct ParticleParams {
  int W, H, N, rounds;
  float bx, by;  // float32(W - 1e-3), float32(H - 1e-3)
  float llen;    // the cell diagonal
  float r[8];
};

// The launch's arrays (ops/particles.py `_Arrays`).
struct ParticleArrays {
  float* px;
  float* py;
  long long* ind;
  float* spx;
  float* spy;
  unsigned char* alive;
  float* att;
  const float* src;
  const float4* cell4;
  const float* dis;
  float* flux;
  long long* log_ind;
  float* log_val;
};

namespace {

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < TINY ? 0.f : x;
}

template <int KIND>
__global__ void __launch_bounds__(BLOCK)
    particle_rounds_kernel(ParticleParams p, ParticleArrays a) {
  using K = Kind<KIND>;
  constexpr int C = K::C;
  constexpr int A = K::A;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long live = 0;

  if (i < p.N) {
    const int N = p.N;
    float px = a.px[i], py = a.py[i], spx = a.spx[i], spy = a.spy[i];
    long long ind = a.ind[i];
    bool alive = a.alive[i] != 0;
    float att[A], src[C];
#pragma unroll
    for (int k = 0; k < A; ++k) att[k] = a.att[(long long)k * N + i];
#pragma unroll
    for (int c = 0; c < C; ++c) src[c] = a.src[(long long)c * N + i];
    const float Wf = (float)p.W, Hf = (float)p.H;

    for (int r = 0; r < p.rounds; ++r) {
      alive = alive && px >= 0.f && py >= 0.f && px < Wf && py < Hf;
      if (!alive) {
        if (a.log_ind != nullptr) {
          a.log_ind[i] = ind;
#pragma unroll
          for (int c = 0; c < C; ++c) a.log_val[(long long)i * C + c] = 0.f;
        }
        break;
      }
      ++live;

      const long long nind =
          (long long)(int)fminf(fmaxf(px, 0.f), p.bx) * p.H +
          (long long)(int)fminf(fmaxf(py, 0.f), p.by);
      const bool entered = nind != ind;
      if (entered) ind = nind;
      // This round's lookups at its cell, ahead of the deposits.
      const float4 f4 = __ldg(a.cell4 + ind);
      float disi = 0.f;
      if constexpr (KIND == FLUVIAL) disi = __ldg(a.dis + ind);

      float d[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        d[c] = (c < C && entered) ? src[c] * att[K::sel(c)] : 0.f;
      if (a.log_ind != nullptr) {
        a.log_ind[i] = ind;
#pragma unroll
        for (int c = 0; c < C; ++c) a.log_val[(long long)i * C + c] = d[c];
      } else if (entered) {
        float4* row = reinterpret_cast<float4*>(a.flux + ind * 8);
        atomicAdd(row, make_float4(d[0], d[1], d[2], d[3]));
        atomicAdd(row + 1, make_float4(d[4], d[5], d[6], d[7]));
      }

      const float v_norm = sqrtf(spx * spx + spy * spy);
      if (!(v_norm >= EPS)) {
        alive = false;
        break;
      }
      // v_safe = max(v_norm, EPS) = v_norm here.
      const float ux = spx / v_norm, uy = spy / v_norm;
      const float xn = floorf(px), yn = floorf(py);
      const float tx =
          fminf(fmaxf((xn - px) / ux, (xn + 1.f - px) / ux), SQRT2);
      const float ty =
          fminf(fmaxf((yn - py) / uy, (yn + 1.f - py) / uy), SQRT2);
      const float stp = 0.5f * (tx + ty);
      const float dL = stp * p.llen;
      const float ds = dL / v_norm;

      const float g = p.r[0], nu = p.r[1];
      const float gxi = f4.x, gyi = f4.y, mxi = f4.z, myi = f4.w;
      float nsx, nsy;
      if constexpr (KIND == FLUVIAL) {
        const float ax = -(g * gxi) + nu * mxi + p.r[2];
        const float ay = -(g * gyi) + nu * myi + p.r[3];
        const float w1 = 1.f / (1.f + dL * p.r[4]);
        const float decay_v = p.r[5] / (EPS + disi);
        att[0] = att[0] * expf(-ds * p.r[6]);
        att[1] = att[1] * expf(-ds * p.r[7]);
        att[2] = att[2] * expf(-dL * decay_v);
        nsx = w1 * spx + (dL * w1) * ax;
        nsy = w1 * spy + (dL * w1) * ay;
      } else {
        const float tau = p.r[2], theta = p.r[3], tau_y = p.r[4];
        const float debrisHeight = EPS + att[0] * src[0];
        const float ax = -(g * gxi) + nu * mxi;
        const float ay = -(g * gyi) + nu * myi;
        const float decay = nu + tau / debrisHeight;
        const float w1 = 1.f / (1.f + dL * decay);
        const float excess = sqrtf(gxi * gxi + gyi * gyi) - theta;
        const float excessStress = g * (excess - tau_y / debrisHeight);
        const float shearRate = excessStress < 0.f ? p.r[5] : p.r[6];
        const float decay_d = ds * shearRate * excessStress / v_norm;
        att[0] = flush(att[0] * flush(expf(decay_d)));
        att[1] = att[1] * expf(-dL * decay);
        nsx = w1 * spx + (w1 * dL) * ax;
        nsy = w1 * spy + (w1 * dL) * ay;
      }
      px = px + stp * ux;
      py = py + stp * uy;
      spx = nsx;
      spy = nsy;
    }

    if (a.log_ind != nullptr) {
      a.px[i] = px;
      a.py[i] = py;
      a.spx[i] = spx;
      a.spy[i] = spy;
      a.ind[i] = ind;
      a.alive[i] = alive ? 1 : 0;
#pragma unroll
      for (int k = 0; k < A; ++k) a.att[(long long)k * N + i] = att[k];
    }
  }

  // The block's live particle-rounds, one atomic a block.
  __shared__ unsigned long long warp_live[BLOCK / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    live += __shfl_down_sync(0xffffffffu, live, off);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < BLOCK / 32; ++w) s += warp_live[w];
    if (s != 0) atomicAdd(&live_rounds[KIND], s);
  }
}

}  // namespace

// C entry point (bound with ctypes by ops/particles.py). kind: 0 fluvial,
// 1 debris. Launches ceil(N / BLOCK) blocks of BLOCK threads on `stream`;
// with a log (a->log_ind and a->log_val not null) p->rounds must be 1.
// Returns the CUDA error of the launch (0 on success; cudaErrorInvalidValue
// for an unknown kind or an empty grid).
extern "C" int particle_rounds_launch(int kind, const ParticleParams* p,
                                      const ParticleArrays* a,
                                      cudaStream_t stream) {
  if (p->W <= 0 || p->H <= 0 || p->N <= 0 || p->rounds < 0)
    return (int)cudaErrorInvalidValue;
  if ((a->log_ind == nullptr) != (a->log_val == nullptr) ||
      (a->log_ind != nullptr && p->rounds != 1))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((p->N + BLOCK - 1) / BLOCK);
  if (kind == FLUVIAL) {
    if (a->dis == nullptr) return (int)cudaErrorInvalidValue;
    particle_rounds_kernel<FLUVIAL><<<blocks, BLOCK, 0, stream>>>(*p, *a);
  } else if (kind == DEBRIS) {
    particle_rounds_kernel<DEBRIS><<<blocks, BLOCK, 0, stream>>>(*p, *a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The live particle-rounds of each kind on the current device, once its
// work has ended: out[0] fluvial, out[1] debris. Returns the CUDA error.
extern "C" int particle_rounds_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, live_rounds, sizeof(live_rounds));
}

// Sets the current device's live particle-rounds to 0, once its work has
// ended. Returns the CUDA error.
extern "C" int particle_rounds_reset() {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[2] = {0, 0};
  err = cudaMemcpyToSymbol(live_rounds, zero, sizeof(zero));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}
