// Rounds of the age-structured cohort sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel soillib_tpu/ops/cohort.py:_cohort_kernel (its
// Pallas launch is `_cohort_call`, driven by `cohort_advance`), which runs
// K = 16 rounds per device-memory pass on VMEM windows with a K-cell halo.
// Both kernels here compute what the plain version
// (soillib_tpu_torch/ops/cohort.py `cohort_round` with `shift_push`) does,
// round for round:
//
//   st  (S, W, H)  cohort state: NSTATE = 10 moment channels + C carried
//   aux (4, W, H)  accel x, accel y, domain mask, rules aux field
//   G   (C, W, H)  deposits, updated in place: G += carried arrivals
//   out (S, W, H)  next state (the arrivals), a separate buffer
//
// with S = 17, C = 7 (fluvial, albedo on), 14/4 (fluvial, albedo off),
// 16/6 (debris, albedo on), 13/3 (debris, albedo off). All float32,
// channel-first, x-major (index = (c * W + x) * H + y).
//
// One node: `cohort_rounds_kernel`, up to K1 = 2 rounds per launch. A
// block of RX1 x RY1 = 24 x 32 threads holds one cell each: a 20 x 28
// owned tile inside a K1-cell ring. Each thread loads its cell's state
// once into registers (the aux fields and, for owned cells, the deposits
// into shared memory) and keeps it there across the launch's rounds. Round
// r evaluates the round physics (`_round_payloads`) only where the owned
// tile still needs it, within rounds - r
// cells of it (the light cone; a warp is one row, so rows beyond the reach
// issue nothing), then exchanges XG = 4 channels per barrier through a
// double-buffered shared array: each thread stores its four payloads per
// channel, and each cell within the reach sums the +x payload of (x-1, y), the -x of
// (x+1, y), the +y of (x, y-1) and the -y of (x, y+1), in that order (the
// term order of `shift_push`), replacing its state channel in place. Cells
// outside the domain emit zero payloads in every round: the zero boundary
// of `shift_push` (particles leaving the domain die, erosion.cu:281). Owned
// cells add each round's carried arrivals to their deposits in round order
// (G + a0 + a1, the plain order) and write state and deposits once.
// Colors (CohortClosure(colors=M)): each color group is a contiguous
// channel slice and ops/cohort.py launches once per group, in color order,
// into the same G; colored solves run one round per launch, so their
// deposits keep the plain batched round's order (bitwise, as with one
// color).
//
// Bound. A round is ~1624 FMA-equivalent issue slots per cell for fluvial
// (exp, division and sqrt weighted by their measured cost), 1802 for
// debris: 0.82 / 0.90 ms at 4096^2 on the H100's FP32 issue rate. Moving
// the state, aux and deposits through device memory once per 16 rounds
// would take 0.065 ms, so the operations bind. One round per launch with a
// 1-cell ring (the first design) paid 208 B per cell-round and 1.42x the
// physics; this one pays ~120 B and 1.31x (20 x 28 owned of 24 x 32, rows
// idle outside the light cone), at 768 threads (24 warps) a block, one
// block per SM.
//
// Quality closures. With CohortClosure(nodes=N), N in {2, 4} (node_rule
// "face"), the state holds N full ensembles per cell, S = N (NSTATE + C)
// channels node-major, and arrivals are routed to a node by the face they
// enter through (ops/cohort.py `_cohort_round_nodes`). The kernel
// `cohort_round_nodes_kernel<KIND, ALBEDO, NODES>` runs one round per
// launch: it evaluates each node's round with the unchanged
// single-ensemble physics and sums every face's payloads over the source
// nodes, in node order, BEFORE the push, as the plain version does
// ((p0 + p1) + p2) + p3. Those sums, 4 faces x (NSTATE + C) channels per
// cell, are held in dynamic shared memory; beside them, asynchronous
// copies (cp.async) bring node j + 1's state into shared memory while node
// j's physics runs, and the owned cells' deposits at the start (111,616 B
// a block for nodes=4 fluvial, two blocks an SM). Blocks of 8 x 32 cells
// form thread-block clusters of CLN = 4 along x: a block reads the face
// sums of its x-neighbours across a block edge from the neighbouring
// block's shared memory (distributed shared memory, a cluster barrier
// between write and read), so only the cluster's first and last rows and
// each block's first and last columns are a recomputed ring: 30 x 30 owned
// of 32 x 32, 1.14x the physics (1.42x with a ring around every block).
// Node k of nodes=4 then receives
// face k from its donor only; nodes=2 receives (+x) + (-x), respectively
// (+y) + (-y); deposits are G + (((o0 + o1) + o2) + o3), respectively
// G + (o0 + o1). A payload the plain version leaves out (None: the
// own-axis offset moments toward +x and +y, channels 6/8 and 7/9) is
// skipped here too, never added as +0.0, so the kernel takes the plain
// version's adds and no others.
//
// Closure variants. Every CohortClosure the JAX package accepts is a
// library of its own, this file built with the COHORT_* defines below
// (ops/cohort.py `KernelVariant`, built at first use; the default
// closure's library is built without them, and its code is what it was
// before the variants). The physics variants change `round_payloads` only:
// the legacy dispersion split (offsets off: exit weights from E[v+-],
// offsets 1/2 and 1/3 on every face, no absent payload), offstep off
// (Var[dL] from stepsize_var) or per face stream, the uniform velocity
// family, the cross-moment regression (xmom) and the rules evaluated per
// stream (perstream: four evaluations a cell, which spill at 80 registers
// in the one-node kernel). The node rules change the N-node kernel's
// routing. "sign" (nodes=4) doubles the face sums: each face's payload
// times the source node's quadrant share, per target, 8 slots a channel
// (181,248 B a block for fluvial, one block an SM); target k's arrival is
// the sum of its two faces in push order. "cluster" (nodes=4) and "speed"
// (nodes=2) keep the face rule's pooled sums; the receiving cell computes
// the routing masks from the four arrivals' (w, w vx, w vy) and its own
// round-entry node means (ops/cohort.py `_cluster_masks`), multiplies each
// arrival by its 0/1 mask as the plain version does (0 x -x = -0.0), sums
// the directions in order, and deposits the direction sum.
//
// Each cell's G is read and written only by the thread that owns the
// cell, so the in-place update has no race.
//
// Arithmetic follows the plain version operation by operation; in
// particular the Abramowitz-Stegun normal CDF (not erff), the cubic expm1
// series below |x| < 0.01 with the +-40 exponent clips, exp(-min(x, 88)),
// the 1e12 cap of the debris per-particle mass and the +-1e30 carried clip.
// Where JAX calls rsqrt this uses 1/sqrtf. Build without --use_fast_math
// and with -fmad=false (soillib_tpu_torch/_native.py): the plain version
// rounds every multiply and add on its own.
// fminf/fmaxf stand for the NaN-propagating jnp/torch min/max; the two
// agree on every finite input.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// Constants are rounded from their double values, as the Python code's
// float literals are (a decimal-to-float literal can differ in the last bit).
#define F32(x) ((float)(x))

namespace cg = cooperative_groups;

// The closure variant (CohortClosure) a library is built for, as -D
// defines (soillib_tpu_torch/_native.py, ops/cohort.py `KernelVariant`);
// the default closure's library is built without them.
#ifndef COHORT_OFFSETS
#define COHORT_OFFSETS 1    // offsets: 1 quadrant-offset routing, 0 legacy
#endif
#ifndef COHORT_OFFSTEP
#define COHORT_OFFSTEP 1    // offstep: 0 off, 1 pooled, 2 per face stream
#endif
#ifndef COHORT_UNIFORM
#define COHORT_UNIFORM 0    // vdist: 0 "gauss", 1 "uniform"
#endif
#ifndef COHORT_XMOM
#define COHORT_XMOM 0
#endif
#ifndef COHORT_PERSTREAM
#define COHORT_PERSTREAM 0
#endif
#ifndef COHORT_RULE
#define COHORT_RULE 0       // node rule: 0 face, 1 sign, 2 cluster, 3 speed
#endif

namespace {

constexpr int NSTATE = 10;

enum NodeRule { FACE = 0, SIGN = 1, CLUSTER = 2, SPEED = 3 };
constexpr bool OFFSETS = COHORT_OFFSETS != 0;
// Offset-conditional step moments: 0 off (Var[dL] from stepsize_var),
// 1 pooled per cell, 2 per face stream. Only with the offsets closure.
constexpr int OFFSTEP = OFFSETS ? COHORT_OFFSTEP : 0;
constexpr bool UNIFORM = COHORT_UNIFORM != 0;
constexpr bool XMOM = COHORT_XMOM != 0;
constexpr bool PERSTREAM = COHORT_PERSTREAM != 0;
constexpr int RULE = COHORT_RULE;
static_assert(RULE >= FACE && RULE <= SPEED, "unknown node rule");
static_assert(RULE != SIGN || OFFSETS, "node_rule sign needs the offsets");
// Face-sum slots a channel holds in the N-node kernel: one per face, or,
// for the sign rule, one per (face, target quadrant), 2 per face.
constexpr int FACES = RULE == SIGN ? 8 : 4;
// Blocks an SM holds of the N-node kernel: two, unless the sign rule's
// doubled face sums leave shared memory for one.
constexpr int NODES_MIN_BLOCKS = RULE == SIGN ? 1 : 2;

// One-node geometry (mirrored by ops/cohort.py `kernel_geometry`).
constexpr int K1 = 2;                  // rounds per launch at most = ring
constexpr int RX1 = 24;                // block rows (x), ring included
constexpr int RY1 = 32;                // block cols (y): one warp per row
constexpr int NT1 = RX1 * RY1;
constexpr int TX1 = RX1 - 2 * K1;      // owned rows
constexpr int TY1 = RY1 - 2 * K1;      // owned cols
constexpr int XG = 4;                  // channels per exchange step

// N-node geometry: blocks of BXN x BYN, clusters of CLN blocks along x.
constexpr int BXN = 8;
constexpr int BYN = 32;
constexpr int NTN = BXN * BYN;
constexpr int CLN = 4;
constexpr int TXN = CLN * BXN - 2;     // owned rows per cluster
constexpr int TYN = BYN - 2;           // owned cols per block

constexpr double SQRT2_D = 1.4142135623730951;
constexpr float SQRT2 = (float)SQRT2_D;
constexpr float INV_SQRT2 = (float)(1.0 / SQRT2_D);
constexpr float EPS = F32(1e-12);
constexpr float EPS2 = (float)(1e-12 * 1e-12);
constexpr float INV_EPS = (float)(1.0 / 1e-12);
constexpr float OFF_WMIN = F32(0.05);
constexpr float VMIN = (float)(0.05 * 0.05 / 12.0);
constexpr float TWELFTH = (float)(1.0 / 12.0);
constexpr float THIRD = (float)(1.0 / 3.0);
constexpr float SIXTH = (float)(1.0 / 6.0);
constexpr float RATE_CLIP = 1e4f;  // exact in float

enum RuleKind { FLUVIAL = 0, DEBRIS = 1 };

}  // namespace

// Scalar parameters of one launch (mirrored by ops/cohort.py
// `_CohortParams`). r[] holds the rule set's scalars:
//   fluvial: r0 = tau + nu, r1 = evapRate, r2 = kd
//   debris:  r0 = rho, r1 = nu, r2 = tau, r3 = g, r4 = kdd, r5 = kds,
//            r6 = yield stress
struct CohortParams {
  int W, H;
  float Llen, Llen2;
  float r[8];
};

namespace {

template <int KIND, bool ALBEDO>
struct Rules;

template <bool ALBEDO>
struct Rules<FLUVIAL, ALBEDO> {
  static constexpr int C = ALBEDO ? 7 : 4;
  static constexpr int NK = 3;
  // (water, mass, vel_x, vel_y[, albedo r, g, b])
  __device__ static constexpr int cls(int c) {
    return c == 0 ? 0 : (c == 1 ? 1 : (c < 4 ? 2 : 1));
  }
};

template <bool ALBEDO>
struct Rules<DEBRIS, ALBEDO> {
  static constexpr int C = ALBEDO ? 6 : 3;
  static constexpr int NK = 2;
  // (mass, vel_x, vel_y[, albedo r, g, b])
  __device__ static constexpr int cls(int c) {
    return (c == 1 || c == 2) ? 1 : 0;
  }
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float z) {
  return z > 0.f ? 1.f : (z < 0.f ? -1.f : z);
}

// ops/cohort.py _norm_cdf: Abramowitz-Stegun 7.1.26.
__device__ __forceinline__ float norm_cdf(float z, float gauss) {
  float x = fabsf(z) * (float)0.7071067811865476;
  float t = 1.f / (1.f + F32(0.3275911) * x);
  float poly = t * (F32(0.254829592) + t * (-F32(0.284496736) + t * (
      F32(1.421413741) + t * (-F32(1.453152027) + t * F32(1.061405429)))));
  float erf_abs = 1.f - poly * gauss;
  float erf_z = signf(z) * erf_abs;
  return 0.5f * (1.f + erf_z);
}

struct Streams {
  float Epos, Eneg, cpos, cneg, m2pos, m2neg, Ppos;
};

// ops/cohort.py _axis_streams, of the family UNIFORM selects.
__device__ __forceinline__ Streams axis_streams(float mu, float m2) {
  Streams s;
  float var = fmaxf(m2 - mu * mu, 0.f);
  bool small = var <= F32(1e-12) * fmaxf(m2, EPS);
  float sigma = small ? 0.f : sqrtf(var);
  if constexpr (UNIFORM) {
    // v ~ U[lo, hi], half-width sqrt(3) sigma.
    float s3 = F32(1.7320508075688772) * sigma;
    float lo = mu - s3, hi = mu + s3;
    float L = small ? 1.f : 2.f * s3;
    float inv_L = 1.f / fmaxf(L, EPS);
    float lo_p = fmaxf(lo, 0.f), hi_p = fmaxf(hi, 0.f);
    float lo_n = fminf(lo, 0.f), hi_n = fminf(hi, 0.f);
    s.Epos = small ? fmaxf(mu, 0.f)
                   : 0.5f * (hi_p * hi_p - lo_p * lo_p) * inv_L;
    s.Eneg = fmaxf(s.Epos - mu, 0.f);
    s.cpos = small ? mu : 0.5f * (lo_p + hi_p);
    s.cneg = small ? mu : 0.5f * (lo_n + hi_n);
    s.m2pos = small ? m2 : THIRD * (hi_p * hi_p + hi_p * lo_p + lo_p * lo_p);
    s.m2neg = small ? m2 : THIRD * (hi_n * hi_n + hi_n * lo_n + lo_n * lo_n);
    s.Ppos = small ? (mu > 0.f ? 1.f : (mu < 0.f ? 0.f : 0.5f))
                   : clampf(hi * inv_L, 0.f, 1.f);
    return s;
  }
  float sigma_s = small ? 1.f : sigma;
  float z = clampf(mu / sigma_s, -6.f, 6.f);
  float gauss = expf(-0.5f * z * z);
  float phi = gauss * (float)0.3989422804014327;
  float Phi = clampf(norm_cdf(z, gauss), F32(1e-9), 1.f);
  float Phn = clampf(1.f - Phi, F32(1e-9), 1.f);
  s.Epos = small ? fmaxf(mu, 0.f) : fmaxf(mu * Phi + sigma * phi, 0.f);
  s.Eneg = fmaxf(s.Epos - mu, 0.f);
  float lam_p = phi / Phi;
  float lam_n = phi / Phn;
  s.cpos = small ? mu : mu + sigma * lam_p;
  s.cneg = small ? mu : mu - sigma * lam_n;
  float m2p = small ? m2 : mu * mu + var + mu * sigma * lam_p;
  float m2n = small ? m2 : mu * mu + var - mu * sigma * lam_n;
  s.Ppos = small ? (mu > 0.f ? 1.f : (mu < 0.f ? 0.f : 0.5f)) : Phi;
  s.m2pos = fmaxf(m2p, 0.f);
  s.m2neg = fmaxf(m2n, 0.f);
  return s;
}

// ops/transport.py stepsize_expected.
__device__ __forceinline__ float step_axis(float a) {
  return a >= INV_SQRT2 ? 0.5f / a : SQRT2 - a;
}

__device__ __forceinline__ float stepsize_expected(float vx, float vy) {
  return 0.5f * (step_axis(fabsf(vx)) + step_axis(fabsf(vy)));
}

// ops/transport.py stepsize_var.
__device__ __forceinline__ float step_var_axis(float a) {
  bool big = a >= INV_SQRT2;
  float a_s = big ? a : 1.f;
  return big ? 1.f / (12.f * a_s * a_s) : F32(0.9428090415820634) * a - a * a;
}

__device__ __forceinline__ float stepsize_var(float vx, float vy) {
  return 0.25f * (step_var_axis(fabsf(vx)) + step_var_axis(fabsf(vy)));
}

// ops/transport.py _expm1_k.
__device__ __forceinline__ float expm1_k(float x) {
  if (fabsf(x) < F32(0.01)) return x * (1.f + x * (0.5f + x * SIXTH));
  return expf(x) - 1.f;
}

__device__ __forceinline__ float axis_mgf(float a, float beta) {
  bool tiny_a = a < F32(1e-20);
  float a_s = tiny_a ? 1.f : a;
  float u_star = fminf(SQRT2 * a, 1.f);
  float arg = clampf(beta * u_star / a_s, -40.f, 40.f);
  bool small_b = fabsf(beta) < F32(1e-12);
  float beta_s = small_b ? 1.f : beta;
  float integral = small_b ? u_star : (a_s / beta_s) * expm1_k(arg);
  float cap = expf(clampf(SQRT2 * beta, -40.f, 40.f));
  float tail = fmaxf(1.f - SQRT2 * a, 0.f) * cap;
  float full = integral + tail;
  return tiny_a ? cap : full;
}

// ops/transport.py expected_exp_step.
__device__ __forceinline__ float expected_exp_step(float vx, float vy,
                                                   float coef) {
  float beta = 0.5f * coef;
  return axis_mgf(fabsf(vx), beta) * axis_mgf(fabsf(vy), beta);
}

// ops/cohort.py _stream_geom: 1/RMS speed and the direction cosines.
__device__ __forceinline__ void stream_geom(float m2_own, float m2_t,
                                            float& inv_s, float& u_own,
                                            float& u_t) {
  float zo = fmaxf(m2_own, 0.f);
  float zt = fmaxf(m2_t, 0.f);
  float s2 = zo + zt;
  inv_s = s2 <= EPS2 ? INV_EPS : 1.f / sqrtf(s2);
  u_own = (zo <= 0.f ? 0.f : sqrtf(zo)) * inv_s;
  u_t = (zt <= 0.f ? 0.f : sqrtf(zt)) * inv_s;
}

__device__ __forceinline__ void stream_geom(float m2_own, float m2_t,
                                            float& u_own, float& u_t) {
  float inv_s;
  stream_geom(m2_own, m2_t, inv_s, u_own, u_t);
}

// ops/cohort.py _regress_coef.
[[maybe_unused]] __device__ __forceinline__ float regress_coef(float m2_own, float var_own,
                                              float cov) {
  bool small = var_own <= F32(1e-12) * fmaxf(m2_own, EPS);
  return small ? 0.f : cov / var_own;
}

// ops/cohort.py _cond_stream: a stream's transverse moments (mt, m2t,
// mxyc); without XMOM the terms of b are left out, as b = None leaves
// them out there.
__device__ __forceinline__ void cond_stream(float c_own, float m2_own,
                                            float mu_own, float mu_t,
                                            float m2_t, float b,
                                            float var_own, float& mt,
                                            float& m2t, float& mxyc) {
  if constexpr (!XMOM) {
    mt = mu_t;
    m2t = fmaxf(m2_t, mt * mt);
    mxyc = mu_t * c_own;
  } else {
    float dmu = c_own - mu_own;
    mt = mu_t + b * dmu;
    float ex2c = m2_own - 2.f * mu_own * c_own + mu_own * mu_own;
    m2t = m2_t + 2.f * mu_t * b * dmu + b * b * (ex2c - var_own);
    m2t = fmaxf(m2t, mt * mt);
    mxyc = mu_t * c_own + b * (m2_own - mu_own * c_own);
  }
}

// ops/cohort.py _trunc_step_moments.
__device__ __forceinline__ void trunc_step_moments(float m, float h, float a,
                                                   float& et, float& vt) {
  float lo = fmaxf(m - h, 0.f);
  float hi = fminf(m + h, 1.f);
  float inv_L = 1.f / fmaxf(hi - lo, F32(1e-6));
  float a_s = fmaxf(a, F32(1e-6));
  float inv_a = 1.f / a_s;
  float gs = clampf(SQRT2 * a_s, lo, hi);
  float w_lin = (gs - lo) * inv_L;
  float w_cap = (hi - gs) * inv_L;
  float e_lin = 0.5f * (lo + gs) * inv_a;
  float e2_lin = (gs * gs + gs * lo + lo * lo) * (inv_a * inv_a) * THIRD;
  et = w_lin * e_lin + w_cap * SQRT2;
  float et2 = w_lin * e2_lin + w_cap * 2.f;
  vt = fmaxf(et2 - et * et, 0.f);
}

// ops/cohort.py _stream_advance: (vox, voy, m2xo, m2yo, mxyo).
__device__ __forceinline__ void stream_advance(float w1, float dL, float dvar,
                                               float ax, float ay, float mx,
                                               float my, float m2x_,
                                               float m2y_, float mxy_,
                                               float* o) {
  float dax = dL * ax, day = dL * ay;
  float w2 = w1 * w1;
  o[0] = w1 * (mx + dax);
  o[1] = w1 * (my + day);
  o[2] = w2 * (m2x_ + 2.f * dax * mx + dax * dax + dvar * (ax * ax));
  o[3] = w2 * (m2y_ + 2.f * day * my + day * day + dvar * (ay * ay));
  o[4] = w2 * (mxy_ + dax * my + day * mx + dax * day + dvar * (ax * ay));
}

struct Quadrant {
  float p_x, gy_out, gx_out, v_gy, v_gx;
};

__device__ __forceinline__ Quadrant quadrant(float ux_m, float uy_m,
                                             float mgx, float mgy, float gwx,
                                             float gwy, float hwx,
                                             float hwy) {
  const float tiny = F32(1e-6);
  Quadrant q;
  float A = mgy * ux_m - mgx * uy_m;
  float Wu = gwy * ux_m + gwx * uy_m;
  q.p_x = clampf(0.5f + A / fmaxf(Wu, tiny), 0.f, 1.f);
  float c_y = fminf(mgx * (uy_m / ux_m), 1.f);
  float lo_y = clampf(c_y, mgy - hwy, mgy + hwy);
  float gy_c = 0.5f * (lo_y + mgy + hwy);
  q.gy_out = clampf(gy_c - c_y, 0.f, 1.f);
  float d_y = mgy + hwy - lo_y;
  q.v_gy = d_y * d_y * TWELFTH;
  float c_x = fminf(mgy * (ux_m / uy_m), 1.f);
  float lo_x = clampf(c_x, mgx - hwx, mgx + hwx);
  float gx_c = 0.5f * (lo_x + mgx + hwx);
  q.gx_out = clampf(gx_c - c_x, 0.f, 1.f);
  float d_x = mgx + hwx - lo_x;
  q.v_gx = d_x * d_x * TWELFTH;
  return q;
}

__device__ __forceinline__ float offset_width(float v, float m) {
  v = clampf(v, VMIN, TWELFTH);
  float wv = sqrtf(12.f * v);
  return fmaxf(fminf(wv, 2.f * fminf(m, 1.f - m)), OFF_WMIN);
}

// The rule set: friction weight w1 and the per-class transit factors.
template <int KIND, bool ALBEDO>
__device__ __forceinline__ float rules_eval(const CohortParams& p, float dL,
                                            float inv, float w,
                                            float carried0, float ux,
                                            float uy, float aux3,
                                            float* facs) {
  if constexpr (KIND == FLUVIAL) {
    // models/erosion.py make_fluvial_rules; aux3 = the static
    // momentum-decay rate.
    float w1 = 1.f / (1.f + dL * p.r[0]);
    facs[0] = expf(-fminf(dL * inv * p.r[1], 88.f));
    facs[1] = expf(-fminf(dL * inv * p.r[2], 88.f));
    facs[2] = expected_exp_step(ux, uy, aux3);
    return w1;
  } else {
    // models/erosion.py make_debris_rules; aux3 = excess slope.
    float den = w * p.r[0];
    bool big = carried0 > den * F32(1e12);
    float m_pp = big ? F32(1e12) : carried0 / den;
    float dh = EPS + m_pp;
    float decay = p.r[1] + p.r[2] / dh;
    float w1 = 1.f / (1.f + dL * decay);
    float es = p.r[3] * (aux3 - p.r[6] / dh);
    float sr = es < 0.f ? p.r[4] : p.r[5];
    facs[0] = expected_exp_step(
        ux, uy, clampf(p.Llen * inv * sr * es * inv, -RATE_CLIP, RATE_CLIP));
    facs[1] = expected_exp_step(ux, uy,
                                clampf(-p.Llen * decay, -RATE_CLIP, 0.f));
    return w1;
  }
}

// The payloads `_round_payloads` leaves out (None) under the offsets
// closure: the own-axis offset moments toward the face they reset to 0,
// +x for fx/fx^2 (channels 6, 8) and +y for fy/fy^2 (channels 7, 9). The
// legacy split leaves none out.
__device__ __forceinline__ constexpr bool absent(int c, int d) {
  return OFFSETS &&
         (((c == 6 || c == 8) && d == 0) || ((c == 7 || c == 9) && d == 2));
}

// One cell's round: pay[c][d] = payload of output channel c toward
// d in (+x, -x, +y, -y). ops/cohort.py _round_payloads under the closure
// the library is built for. With the sign rule, sh[8] receives the
// quadrant shares of each face: xp (++, +-), xn (-+, --), yp (++, -+),
// yn (+-, --).
template <int KIND, bool ALBEDO>
__device__ __forceinline__ void round_payloads(
    const CohortParams& p, const float* stv, const float* auxv,
    float (*pay)[4], float* sh = nullptr) {
  using R = Rules<KIND, ALBEDO>;
  const float Llen = p.Llen;
  float w = stv[0];
  float safe_w = fmaxf(w, EPS);
  float inv_w = 1.f / safe_w;
  float vbx = stv[1] * inv_w, vby = stv[2] * inv_w;
  float m2x = stv[3] * inv_w, m2y = stv[4] * inv_w;
  float mxy = stv[5] * inv_w;
  float axl = auxv[0], ayl = auxv[1];
  (void)mxy;
  (void)sh;

  float srms_sq = m2x + m2y;
  float sbar = srms_sq <= 0.f ? 0.f : sqrtf(srms_sq);
  bool alive = (sbar >= EPS) && (w > 0.f) && (auxv[2] > 0.f);

  Streams sx = axis_streams(vbx, m2x);
  Streams sy = axis_streams(vby, m2y);

  // Exit weights and the offset payload factors of channels 6-9 per face
  // (pf[0] fx, pf[1] fy, pf[2] fx^2, pf[3] fy^2); the absent ones unused.
  float wxp, wxn, wyp, wyn;
  float pf[4][4];
  float hwx = 0.f, hwy = 0.f;
  float mgx_p = 0.f, mgx_n = 0.f, mgy_p = 0.f, mgy_n = 0.f;
  if constexpr (OFFSETS) {
    float mfx = clampf(stv[6] * inv_w, 0.f, 1.f);
    float mfy = clampf(stv[7] * inv_w, 0.f, 1.f);
    float vfx = stv[8] * inv_w - mfx * mfx;
    float vfy = stv[9] * inv_w - mfy * mfy;
    float gwx = offset_width(vfx, mfx);
    float gwy = offset_width(vfy, mfy);

    const float tiny = F32(1e-6);
    float uxp_m = fmaxf(sx.cpos, tiny);
    float uxn_m = fmaxf(-sx.cneg, tiny);
    float uyp_m = fmaxf(sy.cpos, tiny);
    float uyn_m = fmaxf(-sy.cneg, tiny);
    hwx = 0.5f * gwx;
    hwy = 0.5f * gwy;

    mgx_p = 1.f - mfx;
    mgx_n = mfx;
    mgy_p = 1.f - mfy;
    mgy_n = mfy;
    Quadrant pp = quadrant(uxp_m, uyp_m, mgx_p, mgy_p, gwx, gwy, hwx, hwy);
    Quadrant pn = quadrant(uxp_m, uyn_m, mgx_p, mgy_n, gwx, gwy, hwx, hwy);
    Quadrant np = quadrant(uxn_m, uyp_m, mgx_n, mgy_p, gwx, gwy, hwx, hwy);
    Quadrant nn = quadrant(uxn_m, uyn_m, mgx_n, mgy_n, gwx, gwy, hwx, hwy);

    float Pxp = sx.Ppos, Pyp = sy.Ppos;
    float Pxn_ = 1.f - Pxp, Pyn_ = 1.f - Pyp;
    float a_pp = Pxp * Pyp, a_pn = Pxp * Pyn_;
    float a_np = Pxn_ * Pyp, a_nn = Pxn_ * Pyn_;

    float q_pp_x = a_pp * pp.p_x, q_pn_x = a_pn * pn.p_x;
    float q_np_x = a_np * np.p_x, q_nn_x = a_nn * nn.p_x;
    float q_pp_y = a_pp - q_pp_x, q_pn_y = a_pn - q_pn_x;
    float q_np_y = a_np - q_np_x, q_nn_y = a_nn - q_nn_x;

    wxp = q_pp_x + q_pn_x;
    wxn = q_np_x + q_nn_x;
    wyp = q_pp_y + q_np_y;
    wyn = q_pn_y + q_nn_y;

    if constexpr (RULE == SIGN) {
      // The shares of each face's exit weight by velocity-sign quadrant
      // (0 where the face's weight is not positive).
      const float qa[8] = {q_pp_x, q_pn_x, q_np_x, q_nn_x,
                           q_pp_y, q_np_y, q_pn_y, q_nn_y};
      const float wf[4] = {wxp, wxn, wyp, wyn};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float inv = wf[d] <= 0.f ? 0.f : 1.f / wf[d];
        sh[2 * d] = qa[2 * d] * inv;
        sh[2 * d + 1] = qa[2 * d + 1] * inv;
      }
    }

    float a_, b_;
    pf[1][0] = q_pp_x * (1.f - pp.gy_out) + q_pn_x * pn.gy_out;
    pf[1][1] = q_np_x * (1.f - np.gy_out) + q_nn_x * nn.gy_out;
    pf[0][2] = q_pp_y * (1.f - pp.gx_out) + q_np_y * np.gx_out;
    pf[0][3] = q_pn_y * (1.f - pn.gx_out) + q_nn_y * nn.gx_out;
    a_ = 1.f - pp.gy_out;
    b_ = pn.gy_out;
    pf[3][0] = q_pp_x * (a_ * a_ + pp.v_gy) + q_pn_x * (b_ * b_ + pn.v_gy);
    a_ = 1.f - np.gy_out;
    b_ = nn.gy_out;
    pf[3][1] = q_np_x * (a_ * a_ + np.v_gy) + q_nn_x * (b_ * b_ + nn.v_gy);
    a_ = 1.f - pp.gx_out;
    b_ = np.gx_out;
    pf[2][2] = q_pp_y * (a_ * a_ + pp.v_gx) + q_np_y * (b_ * b_ + np.v_gx);
    a_ = 1.f - pn.gx_out;
    b_ = nn.gx_out;
    pf[2][3] = q_pn_y * (a_ * a_ + pn.v_gx) + q_nn_y * (b_ * b_ + nn.v_gx);
    // The own-axis offset resets to the entry face: 1 toward -x / -y
    // (the face weight), 0 toward +x / +y (absent).
    pf[0][0] = pf[1][2] = pf[2][0] = pf[3][2] = 0.f;
    pf[0][1] = pf[2][1] = wxn;
    pf[1][3] = pf[3][3] = wyn;
  } else {
    // Legacy dispersion split: exit weights from the expected positive and
    // negative speeds, uniform offsets (1/2, 1/3) on every face.
    float denom = sx.Epos + sx.Eneg + sy.Epos + sy.Eneg;
    float inv_denom = 1.f / (denom <= 0.f ? 1.f : denom);
    wxp = sx.Epos * inv_denom;
    wxn = sx.Eneg * inv_denom;
    wyp = sy.Epos * inv_denom;
    wyn = sy.Eneg * inv_denom;
    const float wf[4] = {wxp, wxn, wyp, wyn};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      pf[0][d] = pf[1][d] = wf[d] * 0.5f;
      pf[2][d] = pf[3][d] = wf[d] * THIRD;
    }
  }

  // Transverse moments per stream (_cond_stream); the cross-moment
  // regression coefficients only with XMOM (Cauchy-Schwarz-clamped).
  float bx = 0.f, by = 0.f, varx = 0.f, vary = 0.f;
  if constexpr (XMOM) {
    varx = fmaxf(m2x - vbx * vbx, 0.f);
    vary = fmaxf(m2y - vby * vby, 0.f);
    float prod = varx * vary;
    float lim = prod <= 0.f ? 0.f : F32(0.99) * sqrtf(prod);
    float cov = clampf(mxy - vbx * vby, -lim, lim);
    bx = regress_coef(m2x, varx, cov);
    by = regress_coef(m2y, vary, cov);
  }
  float my_xp, m2y_xp, mxy_xp, my_xn, m2y_xn, mxy_xn;
  float mx_yp, m2x_yp, mxy_yp, mx_yn, m2x_yn, mxy_yn;
  cond_stream(sx.cpos, sx.m2pos, vbx, vby, m2y, bx, varx, my_xp, m2y_xp,
              mxy_xp);
  cond_stream(sx.cneg, sx.m2neg, vbx, vby, m2y, bx, varx, my_xn, m2y_xn,
              mxy_xn);
  cond_stream(sy.cpos, sy.m2pos, vby, vbx, m2x, by, vary, mx_yp, m2x_yp,
              mxy_yp);
  cond_stream(sy.cneg, sy.m2neg, vby, vbx, m2x, by, vary, mx_yn, m2x_yn,
              mxy_yn);

  // Per stream d: the step (dL, Var[dL]), friction weight and factors.
  float dLd[4], dvd[4], w1d[4], fac[4][R::NK];
  if constexpr (PERSTREAM) {
    // The step rule and the rules at each stream's own direction cosines
    // and RMS speed, with the arguments and order of the plain version's
    // stream_phys.
    const float m2a[4] = {sx.m2pos, sx.m2neg, m2x_yp, m2x_yn};
    const float m2b[4] = {m2y_xp, m2y_xn, sy.m2pos, sy.m2neg};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float inv_s, u_own, u_t;
      stream_geom(m2a[d], m2b[d], inv_s, u_own, u_t);
      float ux = d < 2 ? u_own : u_t;
      float uy = d < 2 ? u_t : u_own;
      dLd[d] = stepsize_expected(ux, uy) * Llen;
      dvd[d] = OFFSTEP == 0 ? p.Llen2 * stepsize_var(ux, uy) : 0.f;
      w1d[d] = rules_eval<KIND, ALBEDO>(p, dLd[d], inv_s, safe_w, stv[NSTATE],
                                        ux, uy, auxv[3], fac[d]);
    }
  } else {
    // Shared rules evaluation at the pooled direction and RMS speed.
    float ax = sx.Epos + sx.Eneg;
    float ay = sy.Epos + sy.Eneg;
    float inv_an = 1.f / sqrtf(fmaxf(ax * ax + ay * ay, EPS2));
    float ux = ax * inv_an;
    float uy = ay * inv_an;
    float dL = stepsize_expected(ux, uy) * Llen;
    float inv = 1.f / fmaxf(sbar, EPS);
    float facs[R::NK];
    float w1 = rules_eval<KIND, ALBEDO>(p, dL, inv, safe_w, stv[NSTATE], ux,
                                        uy, auxv[3], facs);
    float dvar = OFFSTEP == 0 ? p.Llen2 * stepsize_var(ux, uy) : 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      dLd[d] = dL;
      dvd[d] = dvar;
      w1d[d] = w1;
#pragma unroll
      for (int k = 0; k < R::NK; ++k) fac[d][k] = facs[k];
    }
  }

  if constexpr (OFFSTEP != 0) {
    // Offset-conditional step moments replace (dL, Var[dL]) in the
    // velocity advance.
    float mty = sy.Ppos * mgy_p + (1.f - sy.Ppos) * mgy_n;
    float mtx = sx.Ppos * mgx_p + (1.f - sx.Ppos) * mgx_n;
    if constexpr (OFFSTEP == 2) {
      // Per face stream: its own wall distances and direction cosines.
      const float m_own[4] = {mgx_p, mgx_n, mgy_p, mgy_n};
      const float m2own[4] = {sx.m2pos, sx.m2neg, sy.m2pos, sy.m2neg};
      const float m2t[4] = {m2y_xp, m2y_xn, m2x_yp, m2x_yn};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float u_own, u_t, et_o, vt_o, et_t, vt_t;
        stream_geom(m2own[d], m2t[d], u_own, u_t);
        trunc_step_moments(m_own[d], d < 2 ? hwx : hwy, u_own, et_o, vt_o);
        trunc_step_moments(d < 2 ? mty : mtx, d < 2 ? hwy : hwx, u_t, et_t,
                           vt_t);
        dLd[d] = 0.5f * (et_o + et_t) * Llen;
        dvd[d] = 0.25f * (vt_o + vt_t) * p.Llen2;
      }
    } else {
      // Pooled per cell.
      float ux_r, uy_r;
      stream_geom(m2x, m2y, ux_r, uy_r);
      float et_x, vt_x, et_y, vt_y;
      trunc_step_moments(mtx, hwx, ux_r, et_x, vt_x);
      trunc_step_moments(mty, hwy, uy_r, et_y, vt_y);
      float dL_o = 0.5f * (et_x + et_y) * Llen;
      float dvar_o = 0.25f * (vt_x + vt_y) * p.Llen2;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        dLd[d] = dL_o;
        dvd[d] = dvar_o;
      }
    }
  }

  float adv[4][5];
  stream_advance(w1d[0], dLd[0], dvd[0], axl, ayl, sx.cpos, my_xp, sx.m2pos,
                 m2y_xp, mxy_xp, adv[0]);
  stream_advance(w1d[1], dLd[1], dvd[1], axl, ayl, sx.cneg, my_xn, sx.m2neg,
                 m2y_xn, mxy_xn, adv[1]);
  stream_advance(w1d[2], dLd[2], dvd[2], axl, ayl, mx_yp, sy.cpos, m2x_yp,
                 sy.m2pos, mxy_yp, adv[2]);
  stream_advance(w1d[3], dLd[3], dvd[3], axl, ayl, mx_yn, sy.cneg, m2x_yn,
                 sy.m2neg, mxy_yn, adv[3]);

  float wa = alive ? w : 0.f;
  float wd[4] = {wa * wxp, wa * wxn, wa * wyp, wa * wyn};
#pragma unroll
  for (int d = 0; d < 4; ++d) pay[0][d] = wd[d];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
#pragma unroll
    for (int d = 0; d < 4; ++d) pay[1 + q][d] = wd[d] * adv[d][q];
  }
#pragma unroll
  for (int c = 6; c < NSTATE; ++c) {
#pragma unroll
    for (int d = 0; d < 4; ++d)
      pay[c][d] = absent(c, d) ? 0.f : wa * pf[c - 6][d];
  }

  float wz[4] = {alive ? wxp : 0.f, alive ? wxn : 0.f, alive ? wyp : 0.f,
                 alive ? wyn : 0.f};
#pragma unroll
  for (int c = 0; c < R::C; ++c) {
    const int k = R::cls(c);
    float cv = stv[NSTATE + c];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      pay[NSTATE + c][d] =
          clampf(cv * (wz[d] * fac[d][k]), -F32(1e30), F32(1e30));
    }
  }
}

// Up to K1 rounds of a one-node state per launch (see the header). Dynamic
// shared memory: the double-buffered payload exchange
// xb[2][XG][4][RX1][RY1] (XG channels per barrier), the aux fields
// ax[4][RX1][RY1] and the owned cells' running deposits dp[C][RX1][RY1].
template <int KIND, bool ALBEDO>
__global__ void __launch_bounds__(NT1, 1)
cohort_rounds_kernel(CohortParams p, int rounds,
                     const float* __restrict__ st,
                     const float* __restrict__ aux, float* __restrict__ G,
                     float* __restrict__ out, const int* __restrict__ done) {
  // The adaptive exit on the device: once the flag is set, no block reads
  // or writes anything (see `cohort_rounds_launch`).
  if (done != nullptr && *done) return;
  using R = Rules<KIND, ALBEDO>;
  constexpr int S = NSTATE + R::C;
  extern __shared__ float smem[];
  float* xb = smem;                  // 2 x XG x 4 x NT1
  float* ax = xb + 8 * XG * NT1;     // 4 x NT1
  float* dp = ax + 4 * NT1;          // C x NT1

  const int tx = threadIdx.x;  // along y
  const int ty = threadIdx.y;  // along x
  const int t = ty * RY1 + tx;
  const int gx = (int)blockIdx.y * TX1 + ty - K1;
  const int gy = (int)blockIdx.x * TY1 + tx - K1;
  const int W = p.W, H = p.H;
  const bool inside = gx >= 0 && gx < W && gy >= 0 && gy < H;
  const size_t plane = (size_t)W * (size_t)H;
  const size_t cell = inside ? (size_t)gx * (size_t)H + (size_t)gy : 0;
  // Distance of this cell from the owned tile (0 inside it): round r
  // needs payloads up to distance rounds - r, arrivals up to one less.
  const int ring = max(max(max(K1 - ty, ty - (RX1 - 1 - K1)),
                           max(K1 - tx, tx - (RY1 - 1 - K1))), 0);
  const bool owner = inside && ring == 0;

  float stv[S];
  if (inside && ring <= rounds) {
#pragma unroll
    for (int c = 0; c < S; ++c) stv[c] = st[c * plane + cell];
#pragma unroll
    for (int c = 0; c < 4; ++c) ax[c * NT1 + t] = aux[c * plane + cell];
  } else {
#pragma unroll
    for (int c = 0; c < S; ++c) stv[c] = 0.f;
  }
  if (owner) {
#pragma unroll
    for (int c = 0; c < R::C; ++c) dp[c * NT1 + t] = G[c * plane + cell];
  }

  int phase = 0;  // exchange buffer parity, carried across rounds
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int reach = rounds - r;
    float pay[S][4];
    if (inside && ring <= reach) {
      float auxv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) auxv[c] = ax[c * NT1 + t];
      round_payloads<KIND, ALBEDO>(p, stv, auxv, pay);
    } else {
      // Outside the domain: the zero boundary. Beyond the reach: unread.
#pragma unroll
      for (int c = 0; c < S; ++c) {
#pragma unroll
        for (int d = 0; d < 4; ++d) pay[c][d] = 0.f;
      }
    }
    const bool arrive = inside && ring < reach;
#pragma unroll
    for (int c0 = 0; c0 < S; c0 += XG) {
      float* b = xb + phase * (4 * XG * NT1);
      phase ^= 1;
#pragma unroll
      for (int c = c0; c < c0 + XG && c < S; ++c) {
#pragma unroll
        for (int d = 0; d < 4; ++d)
          b[((c - c0) * 4 + d) * NT1 + t] = pay[c][d];
      }
      __syncthreads();
      if (arrive) {
#pragma unroll
        for (int c = c0; c < c0 + XG && c < S; ++c) {
          const float* e = b + (c - c0) * 4 * NT1;
          float v = e[0 * NT1 + t - RY1];   // +x payload of (x-1, y)
          v = v + e[1 * NT1 + t + RY1];     // -x payload of (x+1, y)
          v = v + e[2 * NT1 + t - 1];       // +y payload of (x, y-1)
          v = v + e[3 * NT1 + t + 1];       // -y payload of (x, y+1)
          stv[c] = v;
          if (c >= NSTATE && owner) {
            float* g = dp + (c - NSTATE) * NT1 + t;
            *g = *g + v;
          }
        }
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int c = 0; c < S; ++c) out[c * plane + cell] = stv[c];
#pragma unroll
    for (int c = 0; c < R::C; ++c) G[c * plane + cell] = dp[c * NT1 + t];
  }
}

// The cluster and speed rules' routing masks at a receiving cell
// (ops/cohort.py `_cluster_masks`): am[d] = (w, w vx, w vy) of direction
// d's arrival, nm[j] = (w, w vx, w vy) of node j's round-entry state;
// mk[d][j] = 1 where direction d's arrival joins node j.
template <int NODES>
__device__ __forceinline__ void route_masks(const float (*am)[3],
                                            const float (*nm)[3],
                                            float (*mk)[NODES]) {
  const float PROTO = F32(0.7071067811865476);
  bool live[NODES];
  float vjx[NODES], vjy[NODES];
#pragma unroll
  for (int j = 0; j < NODES; ++j) {
    live[j] = nm[j][0] > EPS;
    float inv = 1.f / fmaxf(nm[j][0], EPS);
    vjx[j] = nm[j][1] * inv;
    vjy[j] = nm[j][2] * inv;
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    float inv_wa = 1.f / fmaxf(am[d][0], EPS);
    float vax = am[d][1] * inv_wa;
    float vay = am[d][2] * inv_wa;
    float sa = sqrtf(fmaxf(vax * vax + vay * vay, EPS2));
    float dist[NODES];
#pragma unroll
    for (int j = 0; j < NODES; ++j) {
      float dl, dd;
      if constexpr (RULE == SPEED) {
        // [fast, slow]; dead nodes seed at sa and sa / 4.
        float sj = sqrtf(fmaxf(vjx[j] * vjx[j] + vjy[j] * vjy[j], EPS2));
        float e = sa - sj;
        dl = e * e;
        float f = sa - (j == 0 ? sa : 0.25f * sa);
        dd = f * f;
      } else {
        // Dead nodes compete with their sign-quadrant prototype
        // ([++, +-, -+, --]) scaled to the arrival's speed.
        float px = j < 2 ? PROTO : -PROTO;
        float py = (j & 1) ? -PROTO : PROTO;
        float ex = vax - vjx[j], ey = vay - vjy[j];
        dl = ex * ex + ey * ey;
        float fx = vax - sa * px, fy = vay - sa * py;
        dd = fx * fx + fy * fy;
      }
      dist[j] = live[j] ? dl : dd;
    }
    float dmin = dist[0];
#pragma unroll
    for (int j = 1; j < NODES; ++j) dmin = fminf(dmin, dist[j]);
    bool taken = false;
#pragma unroll
    for (int j = 0; j < NODES; ++j) {
      bool hit = dist[j] <= dmin && !taken;
      mk[d][j] = hit ? 1.f : 0.f;
      taken = taken || hit;
    }
  }
}

// One round of an N-node state (see the header). A cluster of CLN blocks
// stacked along x; each block's dynamic shared memory holds
// face[c][s][BXN][BYN], channel c's payload in face slot s summed over the
// cell's source nodes (s = the face d, or for the sign rule 2 d + h, the
// part of face d bound for the face's h-th quadrant), and owners read
// their x-neighbours' sums across a block edge from the neighbouring
// block of the cluster.
template <int KIND, bool ALBEDO, int NODES>
__global__ void __cluster_dims__(1, CLN, 1)
__launch_bounds__(NTN, NODES_MIN_BLOCKS)
cohort_round_nodes_kernel(CohortParams p, const float* __restrict__ st,
                          const float* __restrict__ aux,
                          float* __restrict__ G, float* __restrict__ out,
                          const int* __restrict__ done) {
  // Every block of the cluster reads the same flag, so all of them return
  // before the first cluster barrier, or none does.
  if (done != nullptr && *done) return;
  using R = Rules<KIND, ALBEDO>;
  constexpr int P = NSTATE + R::C;
  constexpr int FS = BXN * BYN;  // floats of one (channel, slot) plane
  constexpr int SPF = FACES / 4;  // slots per face
  extern __shared__ float face[];
  float* stage = face + FACES * P * FS;  // 2 x P x FS: node states, in turn
  float* gold = stage + 2 * P * FS;      // C x FS: the owners' deposits
  cg::cluster_group cluster = cg::this_cluster();

  const int tx = threadIdx.x;  // along y
  const int ty = threadIdx.y;  // along x
  const int t = ty * BYN + tx;
  const int rank = (int)blockIdx.y % CLN;  // block rank = position along x
  // The cluster's rows start one ring row above its owned rows.
  const int gx = ((int)blockIdx.y / CLN) * TXN + rank * BXN + ty - 1;
  const int gy = (int)blockIdx.x * TYN + tx - 1;
  const int W = p.W, H = p.H;
  const bool inside = gx >= 0 && gx < W && gy >= 0 && gy < H;
  const size_t plane = (size_t)W * (size_t)H;
  const size_t cell = inside ? (size_t)gx * (size_t)H + (size_t)gy : 0;
  // The cluster's first and last rows are its ring; so are each block's
  // first and last columns.
  const bool owner = inside && tx >= 1 && tx < BYN - 1 &&
                     !(rank == 0 && ty == 0) &&
                     !(rank == CLN - 1 && ty == BXN - 1);
#define F(c, s) face[((c) * FACES + (s)) * FS + t]
  // The round-entry (w, w vx, w vy) of each node here (cluster, speed).
  [[maybe_unused]] float nm[NODES][3];

  if (inside) {
    // Asynchronous copies (cp.async) into this thread's own shared-memory
    // slots: node 0's state and the deposits now, node j + 1's state
    // while node j's physics runs.
#pragma unroll
    for (int c = 0; c < P; ++c)
      __pipeline_memcpy_async(stage + c * FS + t, st + c * plane + cell, 4);
    if (owner) {
#pragma unroll
      for (int c = 0; c < R::C; ++c)
        __pipeline_memcpy_async(gold + c * FS + t, G + c * plane + cell, 4);
    }
    __pipeline_commit();
    float auxv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) auxv[c] = aux[c * plane + cell];
#pragma unroll 1
    for (int j = 0; j < NODES; ++j) {
      if (j + 1 < NODES) {
        float* nxt = stage + ((j + 1) & 1) * P * FS;
#pragma unroll
        for (int c = 0; c < P; ++c)
          __pipeline_memcpy_async(nxt + c * FS + t,
                                  st + ((j + 1) * P + c) * plane + cell, 4);
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      const float* cur = stage + (j & 1) * P * FS;
      float stv[P];
#pragma unroll
      for (int c = 0; c < P; ++c) stv[c] = cur[c * FS + t];
      if constexpr (RULE == CLUSTER || RULE == SPEED) {
#pragma unroll
        for (int k = 0; k < 3; ++k) nm[j][k] = stv[k];
      }
      float pay[P][4];
      float sh[8];
      round_payloads<KIND, ALBEDO>(p, stv, auxv, pay, sh);
#pragma unroll
      for (int c = 0; c < P; ++c) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (absent(c, d)) continue;
          if constexpr (RULE == SIGN) {
            // Each source node's payload times its quadrant share.
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = pay[c][d] * sh[2 * d + h];
              F(c, 2 * d + h) = j == 0 ? v : F(c, 2 * d + h) + v;
            }
          } else {
            F(c, d) = j == 0 ? pay[c][d] : F(c, d) + pay[c][d];
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < P; ++c) {
#pragma unroll
    for (int s = 0; s < FACES; ++s) {
      // Cells outside the domain emit nothing (the zero boundary); an
      // absent payload reads as the zero it stands for in the plain pz().
      if (!inside || absent(c, s / SPF)) F(c, s) = 0.f;
    }
  }
  // Every block of the cluster has written its face sums.
  cluster.sync();

  if (owner) {
    // Face 0 of row x - 1 and face 1 of row x + 1, in this block or across
    // its edge in the neighbouring block (same column, the edge row).
    const float* up = ty > 0 ? face + (t - BYN)
                             : cluster.map_shared_rank(face + (BXN - 1) * BYN + tx,
                                                       (unsigned)(rank - 1));
    const float* dn = ty < BXN - 1 ? face + (t + BYN)
                                   : cluster.map_shared_rank(face + tx,
                                                             (unsigned)(rank + 1));
    // The arrival here of channel c's slot s: face d's comes from the
    // donor on the opposite side.
    auto arrival = [&](int c, int s) -> float {
      const int d = s / SPF;
      const int i = (c * FACES + s) * FS;
      return d == 0 ? up[i]                      // +x payload of (x-1, y)
           : d == 1 ? dn[i]                      // -x payload of (x+1, y)
           : d == 2 ? face[i + t - 1]            // +y payload of (x, y-1)
                    : face[i + t + 1];           // -y payload of (x, y+1)
    };
    [[maybe_unused]] float mk[4][NODES];
    if constexpr (RULE == CLUSTER || RULE == SPEED) {
      float am[4][3];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
#pragma unroll
        for (int k = 0; k < 3; ++k) am[d][k] = arrival(k, d);
      }
      route_masks<NODES>(am, nm, mk);
    }
#pragma unroll
    for (int c = 0; c < P; ++c) {
      float o[NODES];
      float dep;
      if constexpr (RULE == SIGN) {
        // Target k's arrival sums its two faces in push order: ++ from +x
        // and +y, +- from +x and -y, -+ from -x and +y, -- from -x and -y.
        float b[8];
#pragma unroll
        for (int s = 0; s < 8; ++s) b[s] = arrival(c, s);
        o[0] = absent(c, 0) ? b[4] : (absent(c, 2) ? b[0] : b[0] + b[4]);
        o[1] = absent(c, 0) ? b[6] : (absent(c, 3) ? b[1] : b[1] + b[6]);
        o[2] = absent(c, 1) ? b[5] : (absent(c, 2) ? b[2] : b[2] + b[5]);
        o[3] = absent(c, 1) ? b[7] : (absent(c, 3) ? b[3] : b[3] + b[7]);
      } else {
        float a[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) a[d] = arrival(c, d);
        if constexpr (RULE == CLUSTER || RULE == SPEED) {
          // Each node sums its masked directions in direction order
          // (multiplied, as the plain version does); deposits are the
          // direction sum.
#pragma unroll
          for (int k = 0; k < NODES; ++k) {
            bool first = true;
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              if (absent(c, d)) continue;
              const float v = mk[d][k] * a[d];
              o[k] = first ? v : o[k] + v;
              first = false;
            }
          }
          dep = a[0] + a[1];
          dep = dep + a[2];
          dep = dep + a[3];
        } else if constexpr (NODES == 4) {
          // Node k receives face k from its donor only.
          o[0] = a[0];
          o[1] = a[1];
          o[2] = a[2];
          o[3] = a[3];
        } else {
          o[0] = absent(c, 0) ? a[1] : (absent(c, 1) ? a[0] : a[0] + a[1]);
          o[1] = absent(c, 2) ? a[3] : (absent(c, 3) ? a[2] : a[2] + a[3]);
        }
      }
#pragma unroll
      for (int k = 0; k < NODES; ++k) out[(k * P + c) * plane + cell] = o[k];
      if (c >= NSTATE) {
        if constexpr (RULE != CLUSTER && RULE != SPEED) {
          dep = o[0];
#pragma unroll
          for (int k = 1; k < NODES; ++k) dep = dep + o[k];
        }
        G[(size_t)(c - NSTATE) * plane + cell] =
            gold[(c - NSTATE) * FS + t] + dep;
      }
    }
  }
  // No block leaves while a neighbour may still read its face sums.
  cluster.sync();
#undef F
}

}  // namespace

// The launch geometry the wrapper computed (ops/cohort.py
// `kernel_geometry`): checked against this file's constants, so the two
// cannot drift apart. Outside the unnamed namespace, as CohortParams is:
// the C entry point that takes it must keep external linkage.
struct CohortGeom {
  int block_x, block_y, grid_x, grid_y, ring, cluster, rounds, smem;
};

namespace {

template <int KIND, bool ALBEDO, int NODES>
constexpr int smem_bytes() {
  constexpr int C = Rules<KIND, ALBEDO>::C;
  return NODES == 1
      ? (int)sizeof(float) * (8 * XG + 4 + Rules<KIND, ALBEDO>::C) * NT1
      : (int)sizeof(float) * ((NSTATE + C) * (FACES + 2) + C) * NTN;
}

template <int KIND, bool ALBEDO, int NODES>
bool geometry_ok(const CohortParams& p, const CohortGeom& g) {
  const bool one = NODES == 1;
  const int tx = one ? TX1 : TXN;  // owned rows per block / cluster
  const int ty = one ? TY1 : TYN;
  const int cl = one ? 1 : CLN;
  return g.block_x == (one ? RY1 : BYN) && g.block_y == (one ? RX1 : BXN) &&
         g.ring == (one ? K1 : 1) && g.cluster == cl &&
         g.smem == smem_bytes<KIND, ALBEDO, NODES>() &&
         g.rounds >= 1 && g.rounds <= (one ? K1 : 1) &&
         g.grid_x == (p.H + ty - 1) / ty &&
         g.grid_y == cl * ((p.W + tx - 1) / tx);
}

template <int KIND, bool ALBEDO, int NODES>
cudaError_t launch(const CohortParams& p, const CohortGeom& g,
                   const float* st, const float* aux, float* G, float* out,
                   const int* done, cudaStream_t stream) {
  if (!geometry_ok<KIND, ALBEDO, NODES>(p, g)) return cudaErrorInvalidValue;
  dim3 block(g.block_x, g.block_y);
  dim3 grid(g.grid_x, g.grid_y);
  // Above 48 KB a block's dynamic shared memory needs the opt-in (set on
  // every launch: it is per device, and cheap).
  if constexpr (NODES == 1) {
    cudaError_t e = cudaFuncSetAttribute(
        cohort_rounds_kernel<KIND, ALBEDO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
    cohort_rounds_kernel<KIND, ALBEDO><<<grid, block, g.smem, stream>>>(
        p, g.rounds, st, aux, G, out, done);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        cohort_round_nodes_kernel<KIND, ALBEDO, NODES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
    cohort_round_nodes_kernel<KIND, ALBEDO, NODES>
        <<<grid, block, g.smem, stream>>>(p, st, aux, G, out, done);
  }
  return cudaGetLastError();
}

template <int KIND, bool ALBEDO>
cudaError_t launch_nodes(int nodes, const CohortParams& p,
                         const CohortGeom& g, const float* st,
                         const float* aux, float* G, float* out,
                         const int* done, cudaStream_t stream) {
  // The node counts the node rule runs with: face 1, 2 and 4; sign and
  // cluster 4; speed 2 (the others are not built into this library).
  switch (nodes) {
    case 1:
      if constexpr (RULE == FACE)
        return launch<KIND, ALBEDO, 1>(p, g, st, aux, G, out, done,
                                         stream);
      break;
    case 2:
      if constexpr (RULE == FACE || RULE == SPEED)
        return launch<KIND, ALBEDO, 2>(p, g, st, aux, G, out, done,
                                         stream);
      break;
    case 4:
      if constexpr (RULE == FACE || RULE == SIGN || RULE == CLUSTER)
        return launch<KIND, ALBEDO, 4>(p, g, st, aux, G, out, done,
                                         stream);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The closure variant this library was built for, packed as ops/cohort.py
// `KernelVariant.code` packs it: offsets | offstep << 1 | uniform << 3 |
// xmom << 4 | perstream << 5 | rule << 6.
extern "C" int cohort_variant() {
  return (int)OFFSETS | OFFSTEP << 1 | (int)UNIFORM << 3 | (int)XMOM << 4 |
         (int)PERSTREAM << 5 | RULE << 6;
}

// C entry point (bound with ctypes by ops/cohort.py). kind: 0 fluvial,
// 1 debris; albedo: 0/1; nodes: 1, 2 or 4; g: the launch geometry,
// g->rounds rounds (at most K1 for nodes = 1, else 1). done: null, or a
// device int that the adaptive exit sets (ops/cohort.py `_advance_cuda`
// under CUDA-graph capture, where the host cannot read the criterion):
// while it is nonzero the launch does nothing, so the deposits stop at
// the round where a host read of the criterion would have stopped them.
// Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for a geometry that does not match this file).
extern "C" int cohort_rounds_launch(int kind, int albedo, int nodes,
                                    const CohortParams* p,
                                    const CohortGeom* g, const float* st,
                                    const float* aux, float* G, float* out,
                                    const int* done, cudaStream_t stream) {
  if (p->W <= 0 || p->H <= 0) return (int)cudaErrorInvalidValue;
  if (kind == FLUVIAL) {
    return (int)(albedo
        ? launch_nodes<FLUVIAL, true>(nodes, *p, *g, st, aux, G, out, done,
                                      stream)
        : launch_nodes<FLUVIAL, false>(nodes, *p, *g, st, aux, G, out, done,
                                       stream));
  }
  if (kind == DEBRIS) {
    return (int)(albedo
        ? launch_nodes<DEBRIS, true>(nodes, *p, *g, st, aux, G, out, done,
                                     stream)
        : launch_nodes<DEBRIS, false>(nodes, *p, *g, st, aux, G, out, done,
                                      stream));
  }
  return (int)cudaErrorInvalidValue;
}
