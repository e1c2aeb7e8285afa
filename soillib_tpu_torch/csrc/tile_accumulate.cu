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
// The plain versions are soillib_tpu_torch/ops/graph_tiled.py
// `local_fp_plain` and `trace_plain`: full-grid Jacobi rounds from G = 0
// (X0, D0) until the grid is bitwise stable, checked every 32 rounds, or
// until `cap` rounds. Both kernels are bitwise equal to them.
//
// Layout: (W, H) fields, x-major (index = x * H + y), int32 slots
// 0..K-1 in the neighbor order of soillib_tpu_torch/core/grid.py (D4: K = 4,
// D8: K = 8), -1 at roots. The grid need not be a multiple of the tile:
// cells past W or H are roots that carry nothing.
//
// Design: each cell is computed ONCE, in dependency order, in shared memory.
// The converged value of the plain fixed point is a fixed expression of a
// cell's donors (push) or of its receiver (trace):
//   push:  G_i = ((+0 + p_d0) + p_d1) + ... over the in-tile donors in slot
//          order, p = w * (src + G). `_push_once` also adds +0.0 for every
//          non-donor; a sum that starts at +0.0 never holds -0.0, so those
//          terms change nothing and skipping them keeps the sum bitwise.
//   trace: X_i = X_recv, D_i = w_i * D_recv; cells that never update (roots,
//          cut edges, cells past the grid) keep X0, D0.
// Evaluating each cell once, after what it depends on is final, performs the
// same floating-point operations in the same order as the Jacobi rounds, so
// the result is the plain fixed point bit for bit. A Jacobi round touches all
// 16,384 cells of a tile and a tile needs its longest in-tile chain plus one
// rounds (151 on average on the DEM path at 4096^2); here a tile does 16,384
// cell updates in all and reads each input once.
//  * Local push: per cell a donor mask (bit d: the neighbor at cell - shift_d
//    lies in the tile and its slot is d) and a pending-donor count. Level l
//    lists the cells of depth l (the longest in-tile chain ending there);
//    level 0 is the leaves. The block computes a level's cells; each
//    decrements its receiver's count with a shared atomic, and the
//    receivers whose count reaches zero are appended to the next level's
//    list (one shared atomic a warp), one barrier a level. (A last-arrival
//    continuation, where the thread that brings a count to zero goes on with
//    the receiver and no barrier is kept, ran 3.2x slower on the DEM path:
//    a warp's lanes walk chains of different lengths one after another;
//    tools/tile_variants.py keeps it as a variant.)
//  * Trace: dependencies run the other way. A worklist is seeded with the
//    cells that never update and have donors; each final cell hands its
//    in-tile donors (X = X_recv, D = w * D_recv) to the next level's list.
//    `w` is read once per cell.
//  * A drainage network's deep levels are narrow (a few trunk channels): a
//    level of at most WARP_TAIL cells runs in warp 0 alone, __syncwarp in
//    place of the block barrier, and so do the levels after it until one
//    widens again (the trace's levels run upstream and may).
//  * Where the schedule cannot finish, the tile runs the Jacobi loop of the
//    earlier design in the same launch, under the same cap: the in-tile
//    graph has a cycle (some cell never becomes ready), or its dependency
//    depth L exceeds the cap. L is the longest in-tile chain in EDGES ending
//    at a cell (push) or leaving it (trace): after r Jacobi rounds every cell
//    of depth <= r is final, so the plain version's `cap` rounds reach the
//    fixed point exactly when L <= cap; for L > cap it returns the truncated
//    sum of `cap` rounds, which only the Jacobi loop reproduces.
//  * `rounds` (one int32 per tile, x-major over the tile grid) holds L >= 0
//    where the schedule ran, or -r where the tile took the Jacobi branch and
//    ran r rounds.
//  * Shared memory: push 13 B a cell (src then payload, w, receiver code,
//    mask and count, worklist entry), 212,992 B a tile; trace 12 B
//    a cell (X, D, receiver code, donor mask, worklist entry), 196,608 B. One
//    tile a block, NT threads, one block an SM.
//
// Bound. Each kernel must read its inputs and write its outputs once: 16 B
// per cell for the local push (slot, src, w, G) and for the trace (slot, w,
// X, D); a few operations a cell, so bytes bound both. The schedule's
// sequential depth (the longest chain, 150 levels a tile on average on the
// DEM path) is latency: a level's shared loads, atomics and barrier.
//
// Build without --use_fast_math and with -fmad=false
// (soillib_tpu_torch/_native.py), as every kernel of the package.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 128;
constexpr int T2 = TILE * TILE;
constexpr int NT = 1024;              // threads per block, one tile a block
constexpr int CPT = T2 / NT;          // cells per thread in the strided loops
constexpr int WARP_TAIL = 32;         // a level of at most this many cells
                                      // and all after it: warp 0 alone
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 15;         // code of a cell without an in-tile receiver
static_assert(T2 % NT == 0, "the strided loops cover the tile");

constexpr size_t PUSH_SMEM = 13 * (size_t)T2;
constexpr size_t TRACE_SMEM = 12 * (size_t)T2;

// Neighbor shift d of soillib_tpu_torch/core/grid.py D8_SHIFTS (D4 = the
// first four): (-1,0) (0,-1) (0,1) (1,0) (-1,-1) (-1,1) (1,-1) (1,1).
__host__ __device__ constexpr int dx_of(int d) {
  return d == 0 ? -1 : d < 3 ? 0 : d == 3 ? 1 : d < 6 ? -1 : 1;
}
__host__ __device__ constexpr int dy_of(int d) {
  return d == 0 ? 0 : d == 1 ? -1 : d == 2 ? 1 : d == 3 ? 0 : (d & 1) ? 1 : -1;
}
// Tile-local index offset of neighbor d (local index = lx * TILE + ly).
__host__ __device__ constexpr int off_of(int d) {
  return dx_of(d) * TILE + dy_of(d);
}

__device__ __forceinline__ bool in_tile(int l) { return l >= 0 && l < TILE; }

// Exclusive prefix sum of n over the (whole) warp; `total` gets the sum.
__device__ __forceinline__ int warp_scan(int n, int& total) {
  const int lane = threadIdx.x & 31;
  int x = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  total = __shfl_sync(FULL, x, 31);
  return x - n;
}

// The lane's place among n entries of the warp (called by all 32 lanes):
// with ONE (n is 0 or 1) a ballot, else a prefix sum; `total` gets the sum.
template <bool ONE>
__device__ __forceinline__ int warp_place(int n, int& total) {
  if (ONE) {
    const unsigned b = __ballot_sync(FULL, n);
    total = __popc(b);
    return __popc(b & ((1u << (threadIdx.x & 31)) - 1));
  }
  return warp_scan(n, total);
}

// Reserves n consecutive entries a lane of a list counted by `counter`
// (called by all 32 lanes): one shared atomic a warp. Returns the lane's
// first entry.
template <bool ONE>
__device__ __forceinline__ int warp_append(int* counter, int n) {
  int total;
  const int before = warp_place<ONE>(n, total);
  int base = 0;
  if ((threadIdx.x & 31) == 0 && total) base = atomicAdd(counter, total);
  return __shfl_sync(FULL, base, 0) + before;
}

// Runs the levels of a worklist from entries [head, end) (level `level`)
// until a level is empty or past `cap`. prep(q) readies the entry at q (or
// nothing for q >= end) and returns how many entries it appends to the
// next level (at most one with ONE); emit(q, at) writes them from entry
// `at` on. A level wider than WARP_TAIL is shared by the block, its
// appends counted in cnt[1 + level % 3] (zeroed two levels ahead), one
// barrier a level; narrower levels run in warp 0 alone, __syncwarp between
// them, until one widens again. cnt[4..6] hand the state back.
template <bool ONE, typename Prep, typename Emit>
__device__ __forceinline__ void run_levels(int* cnt, int& head, int& end,
                                           int& level, int cap, Prep prep,
                                           Emit emit) {
  const int tid = threadIdx.x, lane = tid & 31;
  while (head < end && level <= cap) {
    if (end - head > WARP_TAIL) {
      int* next = &cnt[1 + level % 3];
      if (tid == 0) cnt[1 + (level + 1) % 3] = 0;
      for (int q0 = head + (tid & ~31); q0 < end; q0 += NT) {
        const int q = q0 + lane;
        const int at = warp_append<ONE>(next, prep(q));
        emit(q, end + at);
      }
      __syncthreads();
      head = end;
      end += *next;
      ++level;
      continue;
    }
    if (tid < 32) {
      while (head < end && level <= cap && end - head <= WARP_TAIL) {
        int n_next = 0;
        for (int q0 = head; q0 < end; q0 += 32) {
          const int q = q0 + lane;
          int total;
          const int at = warp_place<ONE>(prep(q), total);
          emit(q, end + n_next + at);
          n_next += total;
        }
        __syncwarp();
        head = end;
        end += n_next;
        ++level;
      }
      if (tid == 0) {
        cnt[4] = head;
        cnt[5] = end;
        cnt[6] = level;
      }
    }
    __syncthreads();
    head = cnt[4];
    end = cnt[5];
    level = cnt[6];
    // The next wide level's counter starts at zero for every warp.
    if (tid == 0) cnt[1 + level % 3] = 0;
    __syncthreads();
  }
}

struct TileGeom {
  int x0, y0, nx, ny, H;
  __device__ __forceinline__ bool in_grid(int li) const {
    return (li >> 7) < nx && (li & (TILE - 1)) < ny;
  }
  __device__ __forceinline__ int global(int li) const {
    return (x0 + (li >> 7)) * H + y0 + (li & (TILE - 1));
  }
};

__device__ __forceinline__ TileGeom tile_geom(int W, int H) {
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  return {x0, y0, min(TILE, W - x0), min(TILE, H - y0), H};
}

template <int K>
__global__ void __launch_bounds__(NT, 1)
local_fp_kernel(const int* __restrict__ lslot, const float* __restrict__ src,
                const float* __restrict__ w, float* __restrict__ out,
                int* __restrict__ rounds, int W, int H, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* val = reinterpret_cast<float*>(smem);    // src, then the payload
  float* ws = val + T2;                           // w
  unsigned char* code = reinterpret_cast<unsigned char*>(ws + T2);
  // donor mask | pending donors << 8, two cells a 32-bit word
  unsigned short* meta = reinterpret_cast<unsigned short*>(code + T2);
  unsigned short* aux = meta + T2;  // the worklist
  __shared__ int cnt[8];
  const int tid = threadIdx.x;
  const TileGeom t = tile_geom(W, H);

  // The receiver code of every cell: its slot where the receiver lies in the
  // tile and the grid, else NONE.
#pragma unroll 8
  for (int li = tid; li < T2; li += NT) {
    unsigned c = NONE;
    float s = 0.0f, wv = 0.0f;
    if (t.in_grid(li)) {
      const int i = t.global(li);
      const int sl = lslot[i];
      s = src[i];
      wv = w[i];
      if (sl >= 0 && sl < K) {
        const int rx = (li >> 7) + dx_of(sl), ry = (li & (TILE - 1)) + dy_of(sl);
        if (rx >= 0 && rx < t.nx && ry >= 0 && ry < t.ny) c = (unsigned)sl;
      }
    }
    val[li] = s;
    ws[li] = wv;
    code[li] = (unsigned char)c;
  }
  if (tid < 8) cnt[tid] = 0;
  __syncthreads();

  // Donor masks and counts; the leaves (no donors) are level 0.
#pragma unroll 4
  for (int k = 0; k < CPT; ++k) {
    const int li = tid + k * NT;
    const int lx = li >> 7, ly = li & (TILE - 1);
    unsigned m = 0;
    bool leaf = false;
    if (t.in_grid(li)) {
#pragma unroll
      for (int d = 0; d < K; ++d)
        if (in_tile(lx - dx_of(d)) && in_tile(ly - dy_of(d)) &&
            code[li - off_of(d)] == d)
          m |= 1u << d;
      leaf = m == 0;
    }
    meta[li] = (unsigned short)(m | (__popc(m) << 8));
    const int at = warp_append<true>(&cnt[0], leaf);
    if (leaf) aux[at] = (unsigned short)li;
  }
  __syncthreads();

  // One cell: G from its donors' final payloads in slot order, then its own
  // payload. Returns G.
  auto solve = [&](int c) {
    const unsigned m = meta[c] & 0xffu;
    float g = 0.0f;
#pragma unroll
    for (int d = 0; d < K; ++d)
      if (m & (1u << d)) g = g + val[c - off_of(d)];
    out[t.global(c)] = g;
    val[c] = ws[c] * (val[c] + g);
    return g;
  };
  // Decrements the receiver's pending count; true for the last arrival.
  auto arrive = [&](int r) {
    unsigned* word = reinterpret_cast<unsigned*>(meta) + (r >> 1);
    const int sh = ((r & 1) << 4) + 8;
    const unsigned old = atomicSub(word, 1u << sh);
    return ((old >> sh) & 15u) == 1u;
  };

  bool exact;
  int depth;
  {
    // Level l lists the cells of depth l; each solved cell appends the
    // receiver it made ready.
    int head = 0, end = cnt[0], level = 0, ready = -1;
    run_levels<true>(
        cnt, head, end, level, cap,
        [&](int q) {
          ready = -1;
          if (q < end) {
            const int c = aux[q];
            solve(c);
            const unsigned s = code[c];
            if (s != NONE && arrive(c + off_of((int)s)))
              ready = c + off_of((int)s);
          }
          return (int)(ready >= 0);
        },
        [&](int, int at) {
          if (ready >= 0) aux[at] = (unsigned short)ready;
        });
    depth = max(level - 1, 0);
    exact = head == end && end == t.nx * t.ny && depth <= cap;
  }

  if (!exact) {
    // The Jacobi branch: rounds from G = 0 until the tile is bitwise stable
    // or `cap` rounds, G in registers, the payloads in shared memory.
    float G[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) G[k] = 0.0f;
    int r = 0;
    for (;;) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int li = tid + k * NT;
        if (t.in_grid(li)) val[li] = ws[li] * (src[t.global(li)] + G[k]);
      }
      __syncthreads();
      int ch = 0;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int li = tid + k * NT;
        const unsigned m = meta[li] & 0xffu;
        float g = 0.0f;
#pragma unroll
        for (int d = 0; d < K; ++d)
          if (m & (1u << d)) g = g + val[li - off_of(d)];
        ch |= __float_as_int(g) != __float_as_int(G[k]);
        G[k] = g;
      }
      ++r;
      if (!__syncthreads_or(ch) || r >= cap) break;
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int li = tid + k * NT;
      if (t.in_grid(li)) out[t.global(li)] = G[k];
    }
    depth = -r;
  }
  if (tid == 0) rounds[blockIdx.x * gridDim.y + blockIdx.y] = depth;
}

// X0, D0 and the receiver code of every tile cell: the slot of an in-tile
// receiver (which may lie past the grid: it never updates), else NONE for
// roots, cut edges and cells past the grid. Returns the thread's count of
// cells that update.
template <int K>
__device__ __forceinline__ int trace_init(const int* __restrict__ slot,
                                          const float* __restrict__ w,
                                          int* Xs, float* Ds,
                                          unsigned char* code,
                                          const TileGeom& t) {
  int n_in = 0;
#pragma unroll 8
  for (int li = threadIdx.x; li < T2; li += NT) {
    int X0 = -1;
    float D0 = 0.0f;
    unsigned c = NONE;
    if (t.in_grid(li)) {
      const int i = t.global(li);
      const int s = slot[i];
      if (s >= 0 && s < K) {
        D0 = w[i];
        const int lx = li >> 7, ly = li & (TILE - 1);
        if (in_tile(lx + dx_of(s)) && in_tile(ly + dy_of(s)))
          c = (unsigned)s;
        else
          X0 = (t.x0 + lx + dx_of(s)) * t.H + (t.y0 + ly + dy_of(s));
      }
    }
    Xs[li] = X0;
    Ds[li] = D0;
    code[li] = (unsigned char)c;
    n_in += c != NONE;
  }
  return n_in;
}

template <int K>
__global__ void __launch_bounds__(NT, 1)
trace_kernel(const int* __restrict__ slot, const float* __restrict__ w,
             int* __restrict__ X, float* __restrict__ D,
             int* __restrict__ rounds, int W, int H, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* Xs = reinterpret_cast<int*>(smem);
  float* Ds = reinterpret_cast<float*>(Xs + T2);   // w, then w * D_recv
  unsigned char* code = reinterpret_cast<unsigned char*>(Ds + T2);
  unsigned char* mask = code + T2;
  unsigned short* wl = reinterpret_cast<unsigned short*>(mask + T2);
  __shared__ int cnt[8];
  const int tid = threadIdx.x;
  const TileGeom t = tile_geom(W, H);

  if (tid < 8) cnt[tid] = 0;
  int n_in = trace_init<K>(slot, w, Xs, Ds, code, t);
  __syncthreads();
  n_in = __reduce_add_sync(0xffffffffu, n_in);
  if ((tid & 31) == 0) atomicAdd(&cnt[7], n_in);
  // Donor masks of every tile cell (cells past the grid may be receivers);
  // the seeds are the cells that never update and have donors.
  for (int li = tid; li < T2; li += NT) {
    const int lx = li >> 7, ly = li & (TILE - 1);
    unsigned m = 0;
#pragma unroll
    for (int d = 0; d < K; ++d)
      if (in_tile(lx - dx_of(d)) && in_tile(ly - dy_of(d)) &&
          code[li - off_of(d)] == d)
        m |= 1u << d;
    mask[li] = (unsigned char)m;
    const bool seed = m && code[li] == NONE;
    const int at = warp_append<true>(&cnt[0], seed);
    if (seed) wl[at] = (unsigned short)li;
  }
  __syncthreads();

  bool exact;
  int depth;
  {
    // Level l holds the cells l edges above a seed (see local_fp_kernel).
    const int seeds = cnt[0];
    int head = 0, end = seeds, level = 0;
    // The donors of the cell at q (or of none): each takes X and w * D of
    // it and is listed from `at` on.
    auto hand = [&](int q, int at) {
      const int c = wl[q];
      const int Xc = Xs[c];
      const float Dc = Ds[c];
      const unsigned m = mask[c];
#pragma unroll
      for (int d = 0; d < K; ++d)
        if (m & (1u << d)) {
          const int i = c - off_of(d);
          Xs[i] = Xc;
          Ds[i] = Ds[i] * Dc;
          wl[at++] = (unsigned short)i;
        }
    };
    run_levels<false>(
        cnt, head, end, level, cap,
        [&](int q) { return q < end ? __popc(mask[wl[q]]) : 0; },
        [&](int q, int at) {
          if (q < end) hand(q, at);
        });
    depth = max(level - 1, 0);
    exact = head == end && end - seeds == cnt[7] && depth <= cap;
  }

  if (!exact) {
    // The Jacobi branch from X0, D0: rounds until the tile is bitwise
    // stable or `cap` rounds.
    trace_init<K>(slot, w, Xs, Ds, code, t);
    __syncthreads();
    int r = 0;
    for (;;) {
      int Xn[CPT];
      float Dn[CPT];
      int ch = 0;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int li = tid + k * NT;
        const unsigned c = code[li];
        if (c != NONE) {
          const int ri = li + off_of((int)c);
          Xn[k] = Xs[ri];
          Dn[k] = w[t.global(li)] * Ds[ri];
          ch |= (Xn[k] != Xs[li]) |
                (__float_as_int(Dn[k]) != __float_as_int(Ds[li]));
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int li = tid + k * NT;
        if (code[li] != NONE) {
          Xs[li] = Xn[k];
          Ds[li] = Dn[k];
        }
      }
      ++r;
      if (!__syncthreads_or(ch) || r >= cap) break;
    }
    depth = -r;
  }

  for (int li = tid; li < T2; li += NT) {
    if (t.in_grid(li)) {
      const int i = t.global(li);
      X[i] = Xs[li];
      D[i] = Ds[li];
    }
  }
  if (tid == 0) rounds[blockIdx.x * gridDim.y + blockIdx.y] = depth;
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
// 0 for D4; cap: the most Jacobi rounds a tile may run (the plain version's
// cap); rounds: one int32 per tile (x-major over the tile grid), the tile's
// dependency depth L >= 0, or -r where it ran r Jacobi rounds (see the
// header). Return the CUDA error of the launch (0 on success).
extern "C" int tile_local_fp_launch(const int* lslot, const float* src,
                                    const float* w, float* out, int* rounds,
                                    int W, int H, int d8, int cap,
                                    cudaStream_t stream) {
  if (W <= 0 || H <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  if (d8)
    return (int)launch(local_fp_kernel<8>, PUSH_SMEM, W, H, stream, lslot,
                       src, w, out, rounds, W, H, cap);
  return (int)launch(local_fp_kernel<4>, PUSH_SMEM, W, H, stream, lslot, src,
                     w, out, rounds, W, H, cap);
}

extern "C" int tile_trace_launch(const int* slot, const float* w, int* X,
                                 float* D, int* rounds, int W, int H, int d8,
                                 int cap, cudaStream_t stream) {
  if (W <= 0 || H <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  if (d8)
    return (int)launch(trace_kernel<8>, TRACE_SMEM, W, H, stream, slot, w, X,
                       D, rounds, W, H, cap);
  return (int)launch(trace_kernel<4>, TRACE_SMEM, W, H, stream, slot, w, X, D,
                     rounds, W, H, cap);
}
