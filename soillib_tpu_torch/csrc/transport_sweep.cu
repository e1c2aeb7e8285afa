// K rounds of the linear upwind transport sweep per launch on Hopper
// (sm_90a).
//
// Replaces the TPU kernel soillib_tpu/ops/sweep.py:_sweep_kernel (its
// Pallas launch is `_sweep_call`, driven by `transport_advance`), which
// runs K = 16 rounds per device-memory pass on VMEM windows with a K-cell
// halo. Each round is the plain version's (soillib_tpu_torch/ops/sweep.py
// `upwind_push_cf`):
//
//   G <- PUSH(att * (E + G)),  all (C, W, H) float32, channel-first,
//   x-major (index = (c * W + x) * H + y); vx, vy (W, H) unit directions.
//
// PUSH sends a cell's payload toward +x/-x/+y/-y in the ratio |vx| : |vy|
// of its own direction (`_round_weights`). Each receiving cell gathers the
// +x payload of (x-1, y), the -x payload of (x+1, y), the +y payload of
// (x, y-1) and the -y payload of (x, y+1) and adds them in that order, the
// term order of `upwind_push_cf`. A donor outside the domain contributes
// +0.0, the zero pad of the plain version, so outflow across the domain
// edge is lost (particles exit, path.cu:104) and nothing wraps.
//
// Bound. The reference's round is 9 operations per cell and channel (the
// payload's add and product, four products, three adds) and its weights
// once per pass; its bytes are E, att and G in, G out, vx and vy once per
// 16-round pass: (4C + 2) * 4 B, 1.5 B per cell-round at C = 1 and 7.5 B at
// C = 7, so it is bytes-bound. The first design of this port ran one round
// per launch and moved (4C + 2) * 4 B per cell-ROUND through device memory
// (24 B at C = 1, 120 B at C = 7), recomputing each donor's weights and
// payload at each of its receivers.
//
// Design: trapezoid temporal blocking in shared memory.
//  * A tile of TX x TY owned cells (rows along x, columns along y) is
//    loaded as a window with a SWEEP_K-cell ring on every side: WX x WY
//    cells. A launch runs up to SWEEP_K rounds on it and writes only the
//    owned cells: one device-memory pass per launch. It reads G from one
//    buffer and writes another (never in place: the neighbouring tiles read
//    the same ring).
//  * Each thread holds a group of RX x CY cells (a warp spans the window's
//    columns, CY consecutive columns a lane) in registers: E, att, G, the
//    payload and the four donor weights. A round forms each payload once;
//    the neighbours inside a group come from registers, and only the
//    group's edge cells go through a double-buffered shared array (one
//    barrier a round), one plane per column of the group so that a warp's
//    accesses are consecutive words. The gather keeps the plain term order.
//  * The weights are formed once per tile: each cell's own four outflow
//    weights go through shared memory to its receivers.
//  * Light cone: round r of R only forms payloads within R - r cells of the
//    owned tile and updates cells within R - 1 - r; the ring beyond is
//    loaded and never computed.
//  * Domain edges: cells outside the domain are never computed or written;
//    their payload slots hold +0.0 and the weight of such a donor is set to
//    +0.0 by an explicit test when the weights are formed, so its term is
//    +0.0 * +0.0 = +0.0 exactly, the plain pad. No loaded value is ever
//    multiplied by a zero fill.
//  * Channels: a loop inside the block (the weights are shared), so there
//    is no channel cap.
//  * Persistent blocks (BPS an SM) walk the (tile, channel) items. While an
//    item runs its rounds, the next item's window (G, E, att; vx, vy for
//    channel 0) lands in a staging area of shared memory: one thread issues
//    a tensor-map copy of each field's box and the others wait on an
//    mbarrier (boxes past the field's edge fill +0.0). Fields whose rows
//    are not 16-byte aligned (H not a multiple of 4) are staged by each
//    thread's own 4-byte cp.async instead.
// What binds it (PERF.md §6): the rounds' issue slots and their shared
// loads at C = 7; at C = 1 the window loads, which the staging overlaps
// with the rounds only in part (one 512-thread block an SM at ~128
// registers).
// Device-memory traffic per launch: the window's vx, vy and its C channels
// of E, att and G in, the owned G out (chip_smoke.py reports the bytes per
// owned cell-round of this geometry).
//
// The host computes the launch geometry (ops/sweep.py `sweep_geometry`)
// and passes it in; the entry point refuses any other.
//
// Build without --use_fast_math and with -fmad=false
// (soillib_tpu_torch/_native.py): the plain version rounds every multiply,
// add and divide on its own, and the kernel matches it bitwise.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int SWEEP_K = 8;               // rounds a launch at most; the ring
constexpr int TX = 32;                   // owned rows (x) of a tile
constexpr int WY = 128;                  // window columns (y)
constexpr int CY = 4;                    // columns of one thread
constexpr int NTX = 16;                  // threads in x (32 in y: a warp)
constexpr int WX = TX + 2 * SWEEP_K;     // window rows
constexpr int TY = WY - 2 * SWEEP_K;     // owned columns
constexpr int RX = WX / NTX;             // window rows of one thread
constexpr int WIN = WX * WY;             // window cells
// Shared memory: the double-buffered payloads, the staged window of the
// next (tile, channel): G, E, att and, for channel 0, vx, vy; and the
// staging's mbarrier.
constexpr int STAGED = 5;
constexpr int SMEM = (2 + STAGED) * WIN * 4 + 8;
constexpr int BPS = 1;                   // persistent blocks an SM
static_assert(WX % NTX == 0, "the window's rows split evenly over threads");
static_assert(WY == 32 * CY && SWEEP_K % CY == 0 && TY > 0,
              "a warp spans the window's columns, owned columns in whole "
              "groups of CY");

// The tensor maps of the five fields, as (H, W, C) boxes of WY x WX x 1.
struct Maps {
  CUtensorMap G, E, att, vx, vy;
};

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

// Asynchronous 4-byte copy into shared memory; with `ok` false nothing is
// read and the slot is filled with +0.0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tensor-memory-accelerator path: one thread loads a whole window
// box into shared memory and the transaction count lands on an mbarrier;
// coordinates outside the field are filled with +0.0.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int y, int x, int c, unsigned mbar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"((unsigned long long)map), "r"(y), "r"(x), "r"(c), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();  // a copy that never lands: fail loudly
  }
}

// Where one thread's RX x CY cells of a tile lie in the domain.
struct Cells {
  int x0;      // x of the first row
  int y0;      // y of the first column
  int lo, hi;  // rows inside the domain: i in [lo, hi]
  int cn;      // columns inside the domain: j in [cl, cn)
  int cl;
};

__device__ __forceinline__ Cells cells_of(int tile, int tiles_y, int W,
                                          int H) {
  Cells s;
  s.x0 = (tile / tiles_y) * TX - SWEEP_K + (int)threadIdx.y * RX;
  s.y0 = (tile % tiles_y) * TY - SWEEP_K + (int)threadIdx.x * CY;
  s.lo = max(0, -s.x0);
  s.hi = min(RX - 1, W - 1 - s.x0);
  s.cl = max(0, -s.y0);
  s.cn = min(CY, H - s.y0);
  return s;
}

// Payload slots in shared memory, one plane a column of the thread's
// group (column y = CY * l + j of the window is plane j, lane l), so that
// a warp's accesses to one plane and row are consecutive words.
__device__ __forceinline__ int slot(int j, int r, int l) {
  return (j * WX + r) * 32 + l;
}

__global__ void __launch_bounds__(WY / CY * NTX, BPS)
transport_rounds_kernel(const __grid_constant__ Maps maps,
                        const float* __restrict__ G,
                        const float* __restrict__ E,
                        const float* __restrict__ att,
                        const float* __restrict__ vx,
                        const float* __restrict__ vy, float* __restrict__ out,
                        int C, int W, int H, int rounds, int aligned) {
  extern __shared__ __align__(128) float smem[];
  float* const s0 = smem;               // payloads, even rounds
  float* const s1 = smem + WIN;         // payloads, odd rounds
  float* const stage = smem + 2 * WIN;  // [STAGED][WX][WY]
  const unsigned mbar = smem_addr(smem + (2 + STAGED) * WIN);
  const int l = threadIdx.x;            // lane: window columns CY * l + j
  const int row0 = threadIdx.y * RX;    // first window row of this thread
  const bool leader = threadIdx.x == 0 && threadIdx.y == 0;
  const int tiles_y = (H + TY - 1) / TY;
  const int tiles = tiles_y * ((W + TX - 1) / TX);
  const size_t WH = (size_t)W * H;
  // Distance of each column to the owned tile (the light cone's y part).
  int dy[CY];
#pragma unroll
  for (int j = 0; j < CY; ++j) {
    const int col = CY * l + j;
    dy[j] = max(max(SWEEP_K - col, col - (SWEEP_K + TY - 1)), 0);
  }

  // Stage channel c of a tile (G, E, att; vx, vy too for c = 0) into the
  // staging area, row-major [WX][WY] a field: by the tensor maps (one
  // thread, an mbarrier) when the fields are aligned, else by each
  // thread's own asynchronous copies; cells outside the domain are
  // filled with +0.0 and read nothing.
  auto stage_item = [&](int tile, int c) {
    const int nf = c == 0 ? STAGED : 3;
    if (aligned) {
      if (!leader) return;
      const int x0 = (tile / tiles_y) * TX - SWEEP_K;
      const int y0 = (tile % tiles_y) * TY - SWEEP_K;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              mbar),
          "r"(nf * WIN * 4)
          : "memory");
      tma_box(stage, &maps.G, y0, x0, c, mbar);
      tma_box(stage + WIN, &maps.E, y0, x0, c, mbar);
      tma_box(stage + 2 * WIN, &maps.att, y0, x0, c, mbar);
      if (nf == STAGED) {
        tma_box(stage + 3 * WIN, &maps.vx, y0, x0, 0, mbar);
        tma_box(stage + 4 * WIN, &maps.vy, y0, x0, 0, mbar);
      }
      return;
    }
    const Cells s = cells_of(tile, tiles_y, W, H);
#pragma unroll
    for (int i = 0; i < RX; ++i) {
#pragma unroll
      for (int j = 0; j < CY; ++j) {
        const bool ok = i >= s.lo && i <= s.hi && j >= s.cl && j < s.cn;
        const size_t k = ok ? (size_t)(s.x0 + i) * H + s.y0 + j : 0;
        float* const d = stage + (row0 + i) * WY + CY * l + j;
        cp_async4(d, G + c * WH + k, ok);
        cp_async4(d + WIN, E + c * WH + k, ok);
        cp_async4(d + 2 * WIN, att + c * WH + k, ok);
        if (nf == STAGED) {
          cp_async4(d + 3 * WIN, vx + k, ok);
          cp_async4(d + 4 * WIN, vy + k, ok);
        }
      }
    }
    cp_async_commit();
  };
  // This thread's 4 staged values of field f in window row r.
  auto staged = [&](int f, int r) {
    return reinterpret_cast<const float4*>(stage + f * WIN + r * WY)[l];
  };

  if (aligned && leader) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int tile = blockIdx.x, c = 0;
  unsigned parity = 0;
  if (tile < tiles) stage_item(tile, 0);
  float m1[RX][CY], m2[RX][CY], m3[RX][CY], m4[RX][CY];
  while (tile < tiles) {
    if (aligned) {
      mbar_wait(mbar, parity);
      parity ^= 1;
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // the staged window is complete and visible; the
                      // last item's payloads are read
    const Cells s = cells_of(tile, tiles_y, W, H);
    if (c == 0) {
      // The weights: each cell's own outflow weights through shared
      // memory (x pair, then y pair), each receiver reading its donors'.
      Weights w[RX][CY];
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        const float4 u = staged(3, row0 + i), v = staged(4, row0 + i);
        const float us[CY] = {u.x, u.y, u.z, u.w};
        const float vs[CY] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < CY; ++j) {
          w[i][j] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (i >= s.lo && i <= s.hi && j >= s.cl && j < s.cn)
            w[i][j] = round_weights(us[j], vs[j]);
          s0[slot(j, row0 + i, l)] = w[i][j].xp;
          s1[slot(j, row0 + i, l)] = w[i][j].xn;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        const int x = s.x0 + i, r = row0 + i;
#pragma unroll
        for (int j = 0; j < CY; ++j) {
          // A donor outside the domain or the window sends +0.0.
          m1[i][j] = x > 0 && r > 0 ? s0[slot(j, r - 1, l)] : 0.0f;
          m2[i][j] = x + 1 < W && r + 1 < WX ? s1[slot(j, r + 1, l)] : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RX; ++i) {
#pragma unroll
        for (int j = 0; j < CY; ++j) {
          s0[slot(j, row0 + i, l)] = w[i][j].yp;
          s1[slot(j, row0 + i, l)] = w[i][j].yn;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        const int r = row0 + i;
#pragma unroll
        for (int j = 0; j < CY; ++j) {
          const int y = s.y0 + j, col = CY * l + j;
          m3[i][j] = y > 0 && col > 0
                         ? s0[j > 0 ? slot(j - 1, r, l) : slot(CY - 1, r, l - 1)]
                         : 0.0f;
          m4[i][j] = y + 1 < H && col + 1 < WY
                         ? s1[j < CY - 1 ? slot(j + 1, r, l) : slot(0, r, l + 1)]
                         : 0.0f;
        }
      }
      __syncthreads();
      // Payload slots of cells outside the domain hold +0.0 in both
      // buffers for all of the tile's channels.
#pragma unroll
      for (int i = 0; i < RX; ++i) {
#pragma unroll
        for (int j = 0; j < CY; ++j) {
          if (!(i >= s.lo && i <= s.hi && j >= s.cl && j < s.cn)) {
            s0[slot(j, row0 + i, l)] = 0.0f;
            s1[slot(j, row0 + i, l)] = 0.0f;
          }
        }
      }
    }
    float g[RX][CY], e[RX][CY], a[RX][CY], p[RX][CY];
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const float4 gv = staged(0, row0 + i), ev = staged(1, row0 + i),
                   av = staged(2, row0 + i);
      g[i][0] = gv.x, g[i][1] = gv.y, g[i][2] = gv.z, g[i][3] = gv.w;
      e[i][0] = ev.x, e[i][1] = ev.y, e[i][2] = ev.z, e[i][3] = ev.w;
      a[i][0] = av.x, a[i][1] = av.y, a[i][2] = av.z, a[i][3] = av.w;
#pragma unroll
      for (int j = 0; j < CY; ++j) p[i][j] = 0.0f;
    }
    // The staging area is free: prefetch the next item behind the rounds
    // (the proxy fence orders these reads before the copies' writes).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    int next_tile = tile, next_c = c + 1;
    if (next_c == C) {
      next_c = 0;
      next_tile += gridDim.x;
    }
    if (next_tile < tiles) stage_item(next_tile, next_c);

    for (int r = 0; r < rounds; ++r) {
      float* const sp = (r & 1) ? s1 : s0;
      // Payloads within rounds - r of the owned tile, updates within
      // rounds - 1 - r: rows [SWEEP_K - d, SWEEP_K + TX - 1 + d] of the
      // window, as this thread's i, and the columns as near.
      const int dp = rounds - r, du = rounds - 1 - r;
      const int plo = max(s.lo, SWEEP_K - dp - row0);
      const int phi = min(s.hi, SWEEP_K + TX - 1 + dp - row0);
      const int ulo = max(s.lo, SWEEP_K - du - row0);
      const int uhi = min(s.hi, SWEEP_K + TX - 1 + du - row0);
#pragma unroll
      for (int i = 0; i < RX; ++i) {
#pragma unroll
        for (int j = 0; j < CY; ++j) {
          if (i >= plo && i <= phi && j >= s.cl && j < s.cn && dy[j] <= dp) {
            p[i][j] = a[i][j] * (e[i][j] + g[i][j]);
            // Only the cells other threads read: the first and last rows
            // and columns of the group.
            if (i == 0 || i == RX - 1 || j == 0 || j == CY - 1)
              sp[slot(j, row0 + i, l)] = p[i][j];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RX; ++i) {
#pragma unroll
        for (int j = 0; j < CY; ++j) {
          if (i >= ulo && i <= uhi && j >= s.cl && j < s.cn && dy[j] <= du) {
            const float pl = i > 0 ? p[i - 1][j] : sp[slot(j, row0 - 1, l)];
            const float pr =
                i < RX - 1 ? p[i + 1][j] : sp[slot(j, row0 + RX, l)];
            const float pu =
                j > 0 ? p[i][j - 1] : sp[slot(CY - 1, row0 + i, l - 1)];
            const float pd =
                j < CY - 1 ? p[i][j + 1] : sp[slot(0, row0 + i, l + 1)];
            const float t1 = pl * m1[i][j], t2 = pr * m2[i][j];
            const float t3 = pu * m3[i][j], t4 = pd * m4[i][j];
            g[i][j] = ((t1 + t2) + t3) + t4;
          }
        }
      }
    }
    // Owned cells inside the domain: whole aligned groups as one vector.
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const int r = row0 + i;
      const int col = CY * l;
      if (r < SWEEP_K || r >= SWEEP_K + TX || i < s.lo || i > s.hi ||
          col < SWEEP_K || col >= SWEEP_K + TY)
        continue;
      float* const o = out + c * WH + (size_t)(s.x0 + i) * H + s.y0;
      if (aligned && s.cn == CY) {
        *reinterpret_cast<float4*>(o) =
            make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < CY; ++j)
          if (j < s.cn) o[j] = g[i][j];
      }
    }
    tile = next_tile;
    c = next_c;
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of a (C, W, H) field as WY x WX x 1 boxes; false if the
// driver refuses it.
static bool encode_map(EncodeTiled encode, CUtensorMap* map, const float* p,
                       int C, int W, int H) {
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)W, (cuuint64_t)C};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 4, (cuuint64_t)W * H * 4};
  const cuuint32_t box[3] = {WY, WX, 1}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)p, dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// C entry point (bound with ctypes by ops/sweep.py): `rounds` rounds from G
// into `out` (a separate buffer) in one launch of the geometry the host
// computed (block, grid: one persistent block an SM or one a tile, ring,
// dynamic shared bytes); any other geometry is refused with
// cudaErrorInvalidValue. Returns the CUDA error of the launch (0 on
// success).
extern "C" int transport_rounds_launch(const float* G, const float* E,
                                       const float* att, const float* vx,
                                       const float* vy, float* out, int C,
                                       int W, int H, int rounds, int block_x,
                                       int block_y, int grid_x, int grid_y,
                                       int ring, int smem,
                                       cudaStream_t stream) {
  if (C <= 0 || W <= 0 || H <= 0 || rounds < 1 || rounds > SWEEP_K ||
      G == out)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((H + TY - 1) / TY) * ((W + TX - 1) / TX);
  if (block_x != WY / CY || block_y != NTX || ring != SWEEP_K ||
      smem != SMEM ||
      grid_y != 1 || grid_x != (tiles < BPS * sms ? tiles : BPS * sms) ||
      tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // The tensor maps and the vector stores need rows on 16-byte
  // boundaries: H a multiple of 4 and 16-byte aligned fields. Otherwise
  // each thread stages its own cells and stores them one by one.
  Maps maps = {};
  const bool aligned = H % 4 == 0 &&
                       ((uintptr_t)G | (uintptr_t)E | (uintptr_t)att |
                        (uintptr_t)vx | (uintptr_t)vy | (uintptr_t)out) %
                               16 ==
                           0;
  if (aligned) {
    static EncodeTiled encode = nullptr;
    if (!encode) {
      cudaDriverEntryPointQueryResult found;
      err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                    (void**)&encode, cudaEnableDefault,
                                    &found);
      if (err != cudaSuccess) return (int)err;
      if (found != cudaDriverEntryPointSuccess || !encode)
        return (int)cudaErrorSymbolNotFound;
    }
    if (!encode_map(encode, &maps.G, G, C, W, H) ||
        !encode_map(encode, &maps.E, E, C, W, H) ||
        !encode_map(encode, &maps.att, att, C, W, H) ||
        !encode_map(encode, &maps.vx, vx, 1, W, H) ||
        !encode_map(encode, &maps.vy, vy, 1, W, H))
      return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(transport_rounds_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return (int)err;
  transport_rounds_kernel<<<grid_x, dim3(block_x, block_y), SMEM, stream>>>(
      maps, G, E, att, vx, vy, out, C, W, H, rounds, (int)aligned);
  return (int)cudaGetLastError();
}
