// Per-tile fixed points of the tiled flow accumulation on Hopper (sm_90a).
//
// Replaces two TPU kernels of soillib_tpu/ops/graph_tiled.py:
//   _local_fp_kernel (Pallas launch in `_local_fp_pallas`): phases 1 and 4,
//     per 128^2 tile the one-hot push fixed point G <- push(w * (src + G))
//     over the slot graph with every cross-tile edge cut;
//   _trace_kernel (Pallas launch in `_trace_pallas`): phase 2, per tile the
//     pull fixed point of the chain-exit pointer X (int32) and the path
//     weight D (float32): X <- in_tile ? X[recv] : X0,
//     D <- in_tile ? w * D[recv] : D0.
// Both iterate to BITWISE convergence, at most `cap` rounds per tile. The
// plain versions are soillib_tpu_torch/ops/graph_tiled.py `local_fp_plain`
// and `trace_plain` (full-grid fixed points, checked every 32 rounds); a
// tile converges exactly, so the two agree bitwise.
//
// Layout: (W, H) fields, x-major (index = x * H + y), int32 slots
// 0..K-1 in the neighbor order of soillib_tpu_torch/core/grid.py (D4: K = 4,
// D8: K = 8), -1 at roots. The grid need not be a multiple of the tile:
// cells past W or H are roots that carry nothing.
//
// Design. One block of 1024 threads per tile; thread (lx0, ly) owns the 16
// cells (lx0 + 8k, ly), so a warp covers 32 consecutive y: coalesced global
// access and conflict-free shared memory. The whole tile iterates in shared
// memory and reaches device memory once per input and output.
//  * Local push: each cell's donor set is fixed, so it is computed once as
//    an 8-bit mask (bit d: the neighbor at cell - shift_d lies in the tile
//    and its slot is d). A round writes every cell's payload w * (src + G)
//    to shared memory (64 KB), then each receiver sums its donors' payloads
//    for d = 0..K-1 in order, starting from +0.0. `_push_once` adds +0.0
//    for every non-donor; that sum never holds -0.0, so adding +0.0 changes
//    nothing and skipping it keeps the result bitwise equal. Cross-tile
//    edges need no cut: a donor in the tile with slot d delivers to this
//    cell, which is in the tile. Own G, src and w stay out of shared memory
//    (G in registers; src and w re-read through the read-only cache).
//  * Trace: each cell's in-tile receiver is fixed; a round pulls X and D of
//    every receiver from shared memory (64 KB each) into registers, then,
//    after a barrier, writes them back. The cut edges (receiver outside the
//    tile) and the receivers' flat indices X0 come from the slot itself.
//  * Convergence: a block-wide __syncthreads_or of "some cell's bits
//    changed" ends the loop; the rounds run are written per tile.
//
// Bound. Each kernel must read its inputs and write its outputs once: 16 B
// per cell for the local push (slot, src, w, G) and for the trace (slot, w,
// X, D). The operations grow with the rounds a tile needs (its longest
// in-tile path), three float operations per cell-round for the push
// (add, multiply, the donor sum), one multiply for the trace; on the
// terrain of the port's smoke run the rounds make them operation-bound.
// The shared-memory traffic of those rounds is what this simple form pays
// for; a wavefront or pointer-jumping order is later work.
//
// Build without --use_fast_math and with -fmad=false
// (soillib_tpu_torch/_native.py), as every kernel of the package.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 128;
constexpr int NT = 1024;           // threads per block
constexpr int ROWS = NT / TILE;    // x rows covered by one pass of a block
constexpr int CPT = TILE / ROWS;   // cells per thread
constexpr int FIXED = 15;          // trace code of a cell that never updates

// Neighbor shift d of soillib_tpu_torch/core/grid.py D8_SHIFTS (D4 = the
// first four): (-1,0) (0,-1) (0,1) (1,0) (-1,-1) (-1,1) (1,-1) (1,1).
__host__ __device__ constexpr int dx_of(int d) {
  return d == 0 ? -1 : d < 3 ? 0 : d == 3 ? 1 : d < 6 ? -1 : 1;
}
__host__ __device__ constexpr int dy_of(int d) {
  return d == 0 ? 0 : d == 1 ? -1 : d == 2 ? 1 : d == 3 ? 0 : (d & 1) ? 1 : -1;
}

__device__ __forceinline__ bool in_tile(int l) { return l >= 0 && l < TILE; }

template <int K>
__global__ void __launch_bounds__(NT, 1)
local_fp_kernel(const int* __restrict__ lslot, const float* __restrict__ src,
                const float* __restrict__ w, float* __restrict__ out,
                int* __restrict__ rounds, int W, int H, int cap) {
  extern __shared__ float pay[];  // TILE * TILE payloads
  const int ly = threadIdx.x % TILE;
  const int lx0 = threadIdx.x / TILE;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int y = y0 + ly;

  float G[CPT];
  unsigned mask[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int lx = lx0 + ROWS * k;
    const int x = x0 + lx;
    unsigned m = 0;
    if (x < W && y < H) {
#pragma unroll
      for (int d = 0; d < K; ++d) {
        const int dlx = lx - dx_of(d);  // the donor sits at cell - shift_d
        const int dly = ly - dy_of(d);
        if (in_tile(dlx) && in_tile(dly) && x0 + dlx < W && y0 + dly < H &&
            lslot[(size_t)(x0 + dlx) * H + (y0 + dly)] == d)
          m |= 1u << d;
      }
    }
    mask[k] = m;
    G[k] = 0.0f;
  }

  int r = 0;
  for (;;) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int lx = lx0 + ROWS * k;
      const int x = x0 + lx;
      if (x < W && y < H) {
        const size_t i = (size_t)x * H + y;
        pay[lx * TILE + ly] = w[i] * (src[i] + G[k]);
      }
    }
    __syncthreads();
    int ch = 0;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int li = (lx0 + ROWS * k) * TILE + ly;
      float g = 0.0f;
#pragma unroll
      for (int d = 0; d < K; ++d)
        if (mask[k] & (1u << d)) g = g + pay[li - (dx_of(d) * TILE + dy_of(d))];
      ch |= __float_as_int(g) != __float_as_int(G[k]);
      G[k] = g;
    }
    ++r;
    if (!__syncthreads_or(ch) || r >= cap) break;
  }

#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int x = x0 + lx0 + ROWS * k;
    if (x < W && y < H) out[(size_t)x * H + y] = G[k];
  }
  if (threadIdx.x == 0) rounds[blockIdx.x * gridDim.y + blockIdx.y] = r;
}

template <int K>
__global__ void __launch_bounds__(NT, 1)
trace_kernel(const int* __restrict__ slot, const float* __restrict__ w,
             int* __restrict__ X, float* __restrict__ D,
             int* __restrict__ rounds, int W, int H, int cap) {
  extern __shared__ int smem[];
  int* Xs = smem;                                       // TILE * TILE
  float* Ds = reinterpret_cast<float*>(smem + TILE * TILE);  // TILE * TILE
  const int ly = threadIdx.x % TILE;
  const int lx0 = threadIdx.x / TILE;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int y = y0 + ly;

  // 4-bit code per cell: the slot of an in-tile receiver, or FIXED for
  // roots, cut-edge cells and cells past the grid (they keep X0, D0).
  unsigned long long codes = 0;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int lx = lx0 + ROWS * k;
    const int x = x0 + lx;
    int X0 = -1;
    float D0 = 0.0f;
    unsigned code = FIXED;
    if (x < W && y < H) {
      const size_t i = (size_t)x * H + y;
      const int s = slot[i];
      if (s >= 0 && s < K) {
        D0 = w[i];
        if (in_tile(lx + dx_of(s)) && in_tile(ly + dy_of(s)))
          code = (unsigned)s;
        else
          X0 = (x + dx_of(s)) * H + (y + dy_of(s));
      }
    }
    codes |= (unsigned long long)code << (4 * k);
    Xs[lx * TILE + ly] = X0;
    Ds[lx * TILE + ly] = D0;
  }
  __syncthreads();

  int r = 0;
  for (;;) {
    int Xn[CPT];
    float Dn[CPT];
    int ch = 0;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const unsigned c = (unsigned)(codes >> (4 * k)) & 15u;
      if (c != FIXED) {
        const int lx = lx0 + ROWS * k;
        const int li = lx * TILE + ly;
        const int ri = li + dx_of(c) * TILE + dy_of(c);
        Xn[k] = Xs[ri];
        Dn[k] = w[(size_t)(x0 + lx) * H + y] * Ds[ri];
        ch |= (Xn[k] != Xs[li]) |
              (__float_as_int(Dn[k]) != __float_as_int(Ds[li]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const unsigned c = (unsigned)(codes >> (4 * k)) & 15u;
      if (c != FIXED) {
        const int li = (lx0 + ROWS * k) * TILE + ly;
        Xs[li] = Xn[k];
        Ds[li] = Dn[k];
      }
    }
    ++r;
    if (!__syncthreads_or(ch) || r >= cap) break;
  }

#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int lx = lx0 + ROWS * k;
    const int x = x0 + lx;
    if (x < W && y < H) {
      const size_t i = (size_t)x * H + y;
      X[i] = Xs[lx * TILE + ly];
      D[i] = Ds[lx * TILE + ly];
    }
  }
  if (threadIdx.x == 0) rounds[blockIdx.x * gridDim.y + blockIdx.y] = r;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int W, int H,
                   cudaStream_t stream, Args... args) {
  // Above 48 KB, dynamic shared memory must be allowed per kernel.
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  kernel<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes by ops/graph_tiled.py). d8: 1 for D8,
// 0 for D4; cap: the most rounds a tile may run; rounds: one int32 per tile
// (x-major over the tile grid), the rounds it ran. Return the CUDA error of
// the launch (0 on success).
extern "C" int tile_local_fp_launch(const int* lslot, const float* src,
                                    const float* w, float* out, int* rounds,
                                    int W, int H, int d8, int cap,
                                    cudaStream_t stream) {
  if (W <= 0 || H <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * TILE * TILE;
  if (d8)
    return (int)launch(local_fp_kernel<8>, smem, W, H, stream, lslot, src, w,
                       out, rounds, W, H, cap);
  return (int)launch(local_fp_kernel<4>, smem, W, H, stream, lslot, src, w,
                     out, rounds, W, H, cap);
}

extern "C" int tile_trace_launch(const int* slot, const float* w, int* X,
                                 float* D, int* rounds, int W, int H, int d8,
                                 int cap, cudaStream_t stream) {
  if (W <= 0 || H <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(int) + sizeof(float)) * TILE * TILE;
  if (d8)
    return (int)launch(trace_kernel<8>, smem, W, H, stream, slot, w, X, D,
                       rounds, W, H, cap);
  return (int)launch(trace_kernel<4>, smem, W, H, stream, slot, w, X, D,
                     rounds, W, H, cap);
}
