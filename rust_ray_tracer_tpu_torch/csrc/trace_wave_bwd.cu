// Backward of the whole-wave path trace, on Hopper (sm_90a): the adjoint
// of every bounce of every ray of a sample wave in one launch, then a
// fixed-order reduction of the scene-table cotangents.
//
// Replaces the TPU kernel rust_ray_tracer_tpu/ops/pallas_uber.py
// _make_trace_bwd_kernel (:926, launched by _trace_bwd, :1089), which
// replays the bounces in reverse from the forward's residuals (hist, kind,
// idx), rebuilds each ray's winner row, takes jax.vjp of _tile_core and
// adds the row and light-table cotangents into revisited blocks in grid
// order (:979-1012). Its plain PyTorch version is
// ops/uber.py:trace_wave_bwd_plain. The same body, trace_rays_bwd, is
// kernel D' too: the adjoint of one uber bounce, replacing pallas_uber.py
// _make_fused_bwd_kernel (:619, launched by _fused_bwd, :802), from kernel
// D's input state and winners; its plain version is
// ops/uber.py:fused_bounce_bwd_plain. D' is launched with depth 1 as a
// launch argument and votes on B's 1024-ray tile; its row cotangents and
// light-table partials are summed by bwd_reduce, as B's are. The adjoint
// below runs the device functions of trace_bwd_common.cuh
// (update_found_vjp, update_miss_vjp,
// shade_fwd + shade_vjp, hit_attrs_vjp), the per-ray transliteration of
// ops/{hit,shade,bounce}_core.py's *_vjp functions, winner's kind and
// material only; the split route's backward kernels J' and H' (split.cu)
// run the same functions.
//
// What bounds it on the card: memory, not ALU. No triangle sweep happens
// in the backward; per ray and bounce it reads the bounce's input state
// (14 floats), its randoms (15), its winner (kind, idx) and one winner row,
// and writes one row cotangent (w floats) for the reduction; the carried
// cotangent stays in registers across the bounces. The recomputed forward
// plus its adjoint is a few hundred flops per ray and bounce.
//
// What the design does about it:
//   * one thread per ray and a 128-ray block, as the forward; the bounces
//     run in reverse inside the thread, the cotangent in registers;
//   * every residual plane is read with neighbouring threads on
//     neighbouring addresses (structure of arrays), once;
//   * the liveness skip is the TPU's (a 1024-ray tile with no live ray at
//     bounce b keeps its cotangent, pallas_uber.py:944-947), so the adjoint
//     of the alive plane is the TPU's too;
//   * no float atomics: blocks run in no order, so the row cotangents go to
//     a contributions buffer keyed by winner row, which the host sorts
//     stably and bwd_reduce sums run by run in an order fixed by the
//     positions alone;
//     the light-table cotangents are summed per block in thread order and
//     then across blocks in block order. Gradients are bitwise repeatable;
//   * a scene with Noise textures runs the HAS_NOISE instantiation: the
//     Perlin tables go to shared memory once per block, before the bounce
//     loop, and a noise hit recomputes its marble albedo and sends the
//     albedo's cotangent through marble_vjp (trace_common.cuh) into the hit
//     point and into its row's scale column; the albedo columns take none.
//     The other instantiation is the kernel without it.
//
// Numerics: no fast-math (IEEE division and sqrt, as the forward), and
// built with --fmad=false (kernels/__init__.py), so it rounds as its plain
// version does; the forward is recomputed with the forward kernel's
// formulas (trace_common.cuh), so its branches (tir, metal_ok, the checker
// parity) are the forward's up to the forward's FMA contraction. The
// kinks follow jax.vjp: max/min split the cotangent evenly on a tie, a where() sends nothing to
// the untaken branch, abs'(0) = 1, the clamped divisor of safe_div and the
// floor of the pdf take none.

#include "trace_bwd_common.cuh"

namespace {

using namespace trace;

constexpr int TILE = 1024;           // the TPU kernels' liveness grain
constexpr int MAX_LT = 128;          // (n_lights + 1) * LT_COLS <= 128
constexpr int RED = 256;             // threads of a reduction block
constexpr int W_MAX = 32;            // winner-row columns a block sums

struct BwdTables {
  const float* uni;   // [P, w] winner rows (a miss reads none)
  const float* lt;    // [n_lights + 1, LT_COLS]; last row = background
  const float* perlin_vec;   // [256, 3] (noise scenes)
  const int* perlin_perm;    // [3, 256]
  int w, n_lights, has_checker, p_rows;
};

// The adjoint of ``depth`` bounces of the block's 128 rays replayed from
// the residuals, the body of kernels B and D': dst, each (bounce, ray)'s
// winner-row cotangent and key, and the block's light-table partial.
template <bool HAS_NOISE>
__device__ __forceinline__ void
trace_rays_bwd(const float* __restrict__ hist, const float* __restrict__ rnd,
               const int* __restrict__ kind, const int* __restrict__ idx,
               const float* __restrict__ g_in, const BwdTables& tb,
               float* __restrict__ dst, float* __restrict__ contrib,
               int* __restrict__ keys, float* __restrict__ dlt_part, int n,
               int depth) {
  extern __shared__ float perlin_smem[];     // PERLIN_SMEM bytes if noise
  Perlin perlin{nullptr, nullptr};
  if constexpr (HAS_NOISE) {                 // before any vote or continue
    perlin = perlin_load(perlin_smem, tb.perlin_vec, tb.perlin_perm);
    __syncthreads();
  }
  const int i = blockIdx.x * ROW + threadIdx.x;   // n % TILE == 0
  const int tile0 = i / TILE * TILE;
  const int w = tb.w;
  const int ltn = (tb.n_lights + 1) * LT_COLS;
  float gs[14];
#pragma unroll
  for (int c = 0; c < 14; ++c) gs[c] = g_in[(size_t)c * n + i];
  float dlt[MAX_LT];                       // this ray's light-table share
  for (int k = 0; k < ltn; ++k) dlt[k] = 0.f;
  const float* __restrict__ bg = tb.lt + tb.n_lights * LT_COLS;

  for (int b = depth - 1; b >= 0; --b) {
    const float* __restrict__ H = hist + (size_t)b * 14 * n;
    bool any = false;
#pragma unroll
    for (int k = 0; k < TILE / ROW; ++k)
      any = any || H[(size_t)7 * n + tile0 + threadIdx.x + ROW * k] > 0.5f;
    const size_t bi = (size_t)b * n + i;
    if (!__syncthreads_or(any)) {           // a dead tile keeps dst
      keys[bi] = tb.p_rows;
      continue;
    }
    const int kd = kind[bi];
    const int row_id = idx[bi];
    keys[bi] = kd > 0 ? row_id : tb.p_rows;
    float s[14];
#pragma unroll
    for (int c = 0; c < 14; ++c) s[c] = H[(size_t)c * n + i];
    gs[7] = 0.f;                            // alive: a select of constants
    if (!(s[7] > 0.5f)) continue;           // a dead ray passes through
    const V3 beta = {s[11], s[12], s[13]};
    const V3 gL = {gs[8], gs[9], gs[10]};
    if (kd == KIND_NONE) {                  // miss: L += beta * background
      const V3 gb = update_miss_vjp(bg, beta, gL, {gs[11], gs[12], gs[13]},
                                    dlt + tb.n_lights * LT_COLS);
      gs[11] = gb.x;
      gs[12] = gb.y;
      gs[13] = gb.z;
      continue;
    }

    // ---- forward, recomputed (trace_wave.cu) --------------------------
    const V3 o = {s[0], s[1], s[2]};
    const V3 d = {s[3], s[4], s[5]};
    const float time = s[6];
    const float* __restrict__ row = tb.uni + (size_t)row_id * w;
    const float* pk = row;
    const bool flip = row[9] > 0.5f;
    const float* att = row + A_COL;
    const int mkind = (int)att[0];
    const float fuzz = att[1], ior = att[2];
    const bool is_chk = tb.has_checker && att[12] > 0.5f;

    float t;
    V3 nrm;
    if (kd == KIND_TRI) {
      const V3 v0 = {pk[0], pk[1], pk[2]};
      const V3 e1 = {pk[3], pk[4], pk[5]}, e2 = {pk[6], pk[7], pk[8]};
      const V3 tn = cross(e1, e2);
      const float det = -(d.x * tn.x + d.y * tn.y + d.z * tn.z);
      const float t_num = dot3(o, tn) - dot3(v0, tn);
      t = t_num * safe_div(1.f, det);
      const float sgn = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
      nrm = normalize(tn);
      nrm = {nrm.x * sgn, nrm.y * sgn, nrm.z * sgn};
    } else if (kd == KIND_SPH) {
      const V3 c0 = {pk[0], pk[1], pk[2]}, c1 = {pk[3], pk[4], pk[5]};
      const float st0_ = pk[6], st1_ = pk[7], sr = pk[8];
      const float frac = safe_div(time - st0_, st1_ - st0_);
      const V3 cen = {c0.x + frac * (c1.x - c0.x),
                      c0.y + frac * (c1.y - c0.y),
                      c0.z + frac * (c1.z - c0.z)};
      const V3 oc = {o.x - cen.x, o.y - cen.y, o.z - cen.z};
      const float a = d.x * d.x + d.y * d.y + d.z * d.z;
      const float bq = dot3(oc, d);
      const float cc = dot3(oc, oc) - sr * sr;
      const float disc = bq * bq - a * cc;
      const float sq = safe_sqrt(disc);
      const float root1 = safe_div(-bq - sq, a);
      const float root2 = safe_div(-bq + sq, a);
      const bool ok1 = disc > 0.f && root1 >= T_MIN && root1 <= INFINITY;
      t = ok1 ? root1 : root2;
      const float inv_r = 1.f / jmax(sr, 1e-12f);
      nrm = {(o.x + t * d.x - cen.x) * inv_r, (o.y + t * d.y - cen.y) * inv_r,
             (o.z + t * d.z - cen.z) * inv_r};
    } else {
      const V3 q = {pk[0], pk[1], pk[2]};
      const V3 qu = {pk[3], pk[4], pk[5]}, qv = {pk[6], pk[7], pk[8]};
      const V3 wn = cross(qu, qv);
      const float denom = dot3(d, wn);
      t = safe_div(dot3({q.x - o.x, q.y - o.y, q.z - o.z}, wn), denom);
      nrm = normalize(wn);
      const float dsign = dot3(d, nrm) > 0.f ? -1.f : 1.f;
      nrm = {nrm.x * dsign, nrm.y * dsign, nrm.z * dsign};
    }
    const V3 p = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
    const float ny_pre = nrm.y;
    if (flip) nrm.y = -fabsf(nrm.y);

    int leaf = 3;                           // albedo column in att
    if (is_chk) {
      const float sines = sinf(10.f * p.x) * sinf(10.f * p.y) *
                          sinf(10.f * p.z);
      leaf = sines < 0.f ? 9 : 6;
    }
    V3 alb = {att[leaf], att[leaf + 1], att[leaf + 2]};
    const int sc_col = tb.has_checker ? 13 : 6;   // noise scale, then flag
    const bool is_nz = HAS_NOISE && att[sc_col + 1] > 0.5f;
    if constexpr (HAS_NOISE) {
      if (is_nz) {
        const float m = marble(perlin, p, att[sc_col]);
        alb = {m, m, m};
      }
    }

    // ---- the shading recomputed, the adjoints of the estimator update
    // and of the shading (trace_bwd_common.cuh) --------------------------
    const float* __restrict__ r = rnd + (size_t)b * 15 * n + i;
    const ShadeFwd sf = shade_fwd(mkind, d, nrm, p, alb, fuzz, tb.lt,
                                  tb.n_lights, r, (size_t)n);
    const UpdateVjp u = update_found_vjp(
        beta, sf.em, sf.wt, sf.alive, {gs[0], gs[1], gs[2]},
        {gs[3], gs[4], gs[5]}, gL, {gs[11], gs[12], gs[13]});
    gs[11] = u.g_beta.x;
    gs[12] = u.g_beta.y;
    gs[13] = u.g_beta.z;
    V3 g_o = u.g_o, g_d = u.g_d, g_p = u.g_p, g_n, g_a;
    float g_fuzz, g_ior;
    shade_vjp(sf, mkind, d, nrm, p, alb, ior, tb.lt, tb.n_lights, r,
              (size_t)n, u.g_em, u.g_wt, u.g_sd, g_d, g_p, g_n, g_a, g_fuzz,
              g_ior, dlt);

    // ---- adjoint of the marble: the albedo's cotangent, summed over the
    // three channels, into the hit point and the texture's scale ----------
    float g_scale = 0.f;
    if constexpr (HAS_NOISE) {
      if (is_nz) {
        const MarbleGrad mg = marble_vjp(perlin, p, att[sc_col],
                                         g_a.x + g_a.y + g_a.z);
        g_p = add(g_p, mg.p);
        g_scale = mg.scale;
      }
    }

    // ---- adjoint of the hit attributes (trace_bwd_common.cuh) ----------
    float g_pk[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float g_time = 0.f, g_tmed = 0.f;
    hit_attrs_vjp<false>(kd, o, d, time, T_MIN, INFINITY, pk, flip, ny_pre,
                         t, p, {0.f, g_p, g_n, 0.f, 0.f, {0.f, 0.f, 0.f}},
                         g_o, g_d, g_time, g_pk, g_tmed);

    gs[0] = g_o.x;
    gs[1] = g_o.y;
    gs[2] = g_o.z;
    gs[3] = g_d.x;
    gs[4] = g_d.y;
    gs[5] = g_d.z;
    gs[6] += g_time;

    // this (bounce, ray)'s winner-row cotangent, for bwd_reduce
    float* __restrict__ out = contrib + bi * w;
    for (int c = 0; c < w; ++c) out[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = g_pk[k];
    out[A_COL + 1] = g_fuzz;
    out[A_COL + 2] = g_ior;
    if (is_nz) {
      out[A_COL + sc_col] = g_scale;
    } else {
      out[A_COL + leaf] = g_a.x;
      out[A_COL + leaf + 1] = g_a.y;
      out[A_COL + leaf + 2] = g_a.z;
    }
  }

#pragma unroll
  for (int c = 0; c < 14; ++c) dst[(size_t)c * n + i] = gs[c];

  // the block's light-table share, summed over its rays in thread order
  __shared__ float red[ROW];
  for (int k = 0; k < ltn; ++k) {
    red[threadIdx.x] = dlt[k];
    __syncthreads();
    for (int s = ROW / 2; s > 0; s >>= 1) {
      if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) dlt_part[(size_t)blockIdx.x * ltn + k] = red[0];
    __syncthreads();
  }
}

// Kernel B: the adjoint of every bounce of the wave.
template <bool HAS_NOISE>
__global__ void __launch_bounds__(ROW)
trace_wave_bwd_kernel(const float* __restrict__ hist,
                      const float* __restrict__ rnd,
                      const int* __restrict__ kind,
                      const int* __restrict__ idx,
                      const float* __restrict__ g_in, const BwdTables tb,
                      float* __restrict__ dst, float* __restrict__ contrib,
                      int* __restrict__ keys, float* __restrict__ dlt_part,
                      int n, int depth) {
  trace_rays_bwd<HAS_NOISE>(hist, rnd, kind, idx, g_in, tb, dst, contrib,
                            keys, dlt_part, n, depth);
}

// Kernel D': the adjoint of one bounce (the caller passes depth 1, a
// launch argument, so the body is B's instruction for instruction) from
// kernel D's input state ``st`` and winners, voting on B's 1024-ray tile.
template <bool HAS_NOISE>
__global__ void __launch_bounds__(ROW)
fused_bounce_bwd_kernel(const float* __restrict__ st,
                        const float* __restrict__ rnd,
                        const int* __restrict__ kind,
                        const int* __restrict__ idx,
                        const float* __restrict__ g_in, const BwdTables tb,
                        float* __restrict__ dst, float* __restrict__ contrib,
                        int* __restrict__ keys, float* __restrict__ dlt_part,
                        int n, int depth) {
  trace_rays_bwd<HAS_NOISE>(st, rnd, kind, idx, g_in, tb, dst, contrib,
                            keys, dlt_part, n, depth);
}

// Fixed-order sums of the row cotangents (B'). The terms come sorted by
// row: ``keys`` [m] is the stable sort of their rows and ``perm`` [m] the
// position of each term's cotangent row in ``contrib``; a key >= p_rows (a
// ray that found no row) is no row. The sorted terms are cut into pieces
// of PIECE, one block each, so the work follows the terms, not the table:
// the launch zeroes duni and a row no term names stays zero. Inside a piece
// thread t takes the PER consecutive terms from PER * t and adds each run
// of equal keys among them left to right; a run that ends inside the
// thread is written at once, and the thread's last run (its tail), which
// may go on into the next threads, is summed across the threads by a
// segmented inclusive scan: five shuffle steps in each warp (lane l adds
// lane l - s's value before its own unless a run starts between them),
// then the warps' totals carried in warp order. A run that goes on past its
// piece is written as one partial a piece (slot 1 of its first piece, slot
// 0 of the others), and the last block to finish (an integer counter of
// the piece where the run starts) adds them in piece order. Every order is
// fixed by the positions alone, so the sums repeat bit for bit;
// ops/uber.py bwd_reduce_replay replays them on the CPU. Blocks past the
// pieces add the k-th light-table entry of every partial, in block order.
// What bounds it: a call moves ~3 MB (147,456 terms of a wave), a
// microsecond of HBM, so its time is a chain of dependent accesses: the
// terms, their rows, the scan's barrier, and for a run that crosses
// pieces a fence, a counter and the partials. The loads of a thread's
// terms are issued together, warp 0 finds the crossing runs' pieces while
// they land, and the column loop stays rolled (its unrolled code missed
// the instruction cache on every block).
constexpr int PIECE = 1024;            // sorted terms one block sums
constexpr int PER = PIECE / RED;       // consecutive terms a thread adds
constexpr int COLS = 8;                // columns whose terms load together
constexpr unsigned FULL = 0xffffffffu;

__device__ float block_sum(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = RED / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// The first piece i in [lo, hi) whose key at i * PIECE + off is >= r (gt:
// > r), else hi; keys[i * PIECE + off] rises with i. Called by a whole
// warp: the first round probes the 32 pieces at the end of the range
// nearest the caller (near: lo or hi), where a run's end usually lies,
// then 32 probes a round over what is left.
__device__ int first_piece(const int* __restrict__ keys, int lo, int hi,
                           int off, int r, bool gt, bool near_lo) {
  const int lane = threadIdx.x & 31;
  auto pred = [&](int i) {
    const int key = keys[(size_t)i * PIECE + off];
    return gt ? key > r : key >= r;
  };
  if (lo < hi) {
    const int w0 = near_lo ? lo : max(lo, hi - 32);
    const int i = w0 + lane;
    const unsigned b = __ballot_sync(FULL, i < hi ? pred(i) : true);
    const int f = __ffs(b) - 1;
    if (near_lo) {
      if (b != 0) return min(w0 + f, hi);
      lo = w0 + 32;                         // all 32 below the answer
    } else {
      if (b == 0) return hi;                // the top 32 below it: all are
      if (f > 0 || w0 == lo) return min(w0 + f, hi);
      hi = w0;                              // at or below w0
    }
  }
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const bool p = i < hi ? pred(i) : true; // probes past hi vote yes
    const unsigned b = __ballot_sync(FULL, p);
    if (b == 0) {                           // past the last probe
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(b) - 1;
    if (f == 0) return lo;
    const int nlo = lo + (f - 1) * step + 1;
    hi = min(hi, lo + f * step);
    lo = nlo;
  }
  return hi;
}

struct Piece {
  int k, kfirst, klast, p_rows, w;
  bool lead, trail;     // the first run began before, the last goes on
};

// Row r's sum in this piece, column c: to duni when the run lies inside
// the piece, else to the piece's partial slot (0: the run began before the
// piece, 1: it begins here and goes on).
__device__ __forceinline__ bool put(const Piece& pc, int r, int c, float v,
                                    float* __restrict__ partial,
                                    float* __restrict__ duni) {
  if (r >= pc.p_rows) return false;
  if (pc.lead && r == pc.kfirst) {
    partial[((size_t)pc.k * 2) * pc.w + c] = v;
    return true;
  }
  if (pc.trail && r == pc.klast) {
    partial[((size_t)pc.k * 2 + 1) * pc.w + c] = v;
    return true;
  }
  duni[(size_t)r * pc.w + c] = v;
  return false;
}

// A run's sum over its pieces k0 .. k1, column ``lane``: the first
// piece's slot 1, then the others' slot 0, in piece order, 16 loads in
// flight.
__device__ __forceinline__ void add_partials(const float* __restrict__ partial,
                                             int k0, int k1, int w, int lane,
                                             float* __restrict__ out) {
  float sum = __ldcg(partial + ((size_t)k0 * 2 + 1) * w + lane);
  for (int q0 = k0 + 1; q0 <= k1; q0 += 16) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = q0 + j <= k1 ? __ldcg(partial + ((size_t)(q0 + j) * 2) * w + lane)
                          : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (q0 + j <= k1) sum += v[j];
  }
  *out = sum;
}

// Columns c0 .. c0 + COLS - 1 of the thread's terms (rows pp[0 .. cnt -
// 1] of contrib [*, w]), all loads issued together; zeros past either end.
__device__ __forceinline__ void load_terms(const float* __restrict__ contrib,
                                           const int (&pp)[PER], int cnt,
                                           int w, int c0,
                                           float (&v)[PER][COLS]) {
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      v[i][j] = i < cnt && c0 + j < w
                    ? __ldg(contrib + (size_t)pp[i] * w + c0 + j)
                    : 0.f;
}

__global__ void __launch_bounds__(RED)
bwd_reduce_kernel(const float* __restrict__ contrib,
                  const int* __restrict__ keys, const int* __restrict__ perm,
                  int m, int p_rows, int w, int n_pieces,
                  float* __restrict__ partial, int* __restrict__ done,
                  const float* __restrict__ dlt_part, int n_part, int ltn,
                  float* __restrict__ duni, float* __restrict__ dlt) {
  __shared__ float red[RED];
  __shared__ float wtot[RED / 32][W_MAX];   // each warp's scanned tail
  __shared__ float hsum[W_MAX][RED];        // each thread's head sums
  __shared__ bool wflag[RED / 32];          // a run starts in the warp
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int k = blockIdx.x;
  if (k >= n_pieces) {                      // a light-table entry
    float acc = 0.f;
    for (int j = t; j < n_part; j += RED)
      acc += dlt_part[(size_t)j * ltn + (k - n_pieces)];
    acc = block_sum(acc, red);
    if (t == 0) dlt[k - n_pieces] = acc;
    return;
  }
  const int base = k * PIECE, end = min(base + PIECE, m);
  Piece pc;
  pc.k = k;
  pc.p_rows = p_rows;
  pc.w = w;
  // the piece's ends and their neighbours, and this thread's terms p0 ..
  // p0 + cnt - 1, all loaded before anything waits on them
  pc.kfirst = keys[base];
  pc.klast = keys[end - 1];
  const int kbefore = base > 0 ? keys[base - 1] : -1;
  const int kafter = end < m ? keys[end] : -1;
  const int p0 = base + PER * t;
  const int cnt = max(0, min(PER, end - p0));
  int kk[PER], pp[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    kk[i] = i < cnt ? keys[p0 + i] : -1;
    pp[i] = i < cnt ? perm[p0 + i] : 0;
  }
  const int kprev = cnt > 0 && p0 > base ? keys[p0 - 1] : -1;
  const int knext = cnt > 0 && p0 + cnt < end ? keys[p0 + cnt] : -1;
  if (pc.kfirst >= p_rows) return;          // sorted: no row from here on
  pc.lead = kbefore == pc.kfirst;
  pc.trail = pc.klast < p_rows && kafter == pc.klast;
  // s[i]: a run starts at term i inside the piece
  bool s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    s[i] = i == 0 ? (cnt > 0 && (p0 == base || kprev != kk[0]))
                  : (i < cnt && kk[i] != kk[i - 1]);
  // the tail's run ends with this thread's last term; the thread's first
  // run came from the thread before and ends inside this one (head)
  const bool tail_ends = cnt > 0 && (p0 + cnt == end ||
                                     knext != kk[cnt - 1]);
  bool head = false, f = cnt == 0;
#pragma unroll
  for (int i = 1; i < PER; ++i) head = head || s[i];
  head = head && !s[0];
#pragma unroll
  for (int i = 0; i < PER; ++i) f = f || s[i];

  // the segmented scan's flags: a run starts in lanes (lane - st, lane]
  // before its step of distance st, and in [0, lane] after the last
  int ktail = kk[0];
#pragma unroll
  for (int i = 1; i < PER; ++i) ktail = i < cnt ? kk[i] : ktail;
  const unsigned fb = __ballot_sync(FULL, f);
  bool gs[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int lo = max(0, lane - (1 << q) + 1);
    gs[q] = ((fb >> lo) & ((2u << (lane - lo)) - 1u)) != 0u;
  }
  const bool g = (fb & ((2u << lane) - 1u)) != 0u;
  if (lane == 31) wflag[warp] = g;
  bool wrote = false;                       // a partial slot, to fence
  // COLS columns at a time: the thread's PER x COLS values loaded
  // together and added run by run in term order (a head's sum waits in
  // shared memory); the tails' segmented scan in each warp (lane l adds
  // lane l - st's value before its own unless a run starts between), the
  // warps' totals to shared memory; then the carry of the warps before and
  // each run's sum where its last term lies
  float v[PER][COLS];
  load_terms(contrib, pp, cnt, w, 0, v);
  // while they load, warp 0 finds the pieces of the runs that cross this
  // one's ends: the lead run began in the first piece whose last key is
  // its key; a run ends in the last piece whose first key is its key
  const bool both = pc.lead && pc.trail && pc.klast == pc.kfirst;
  const bool lead = pc.lead, trail = pc.trail && !both;
  int k0 = k, k1a = k, k1b = k;
  if (warp == 0) {
    if (lead)
      k0 = first_piece(keys, 0, k, PIECE - 1, pc.kfirst, false, false);
    if (both)
      k1a = first_piece(keys, k + 1, n_pieces, 0, pc.kfirst, true, true) - 1;
    if (trail)
      k1b = first_piece(keys, k + 1, n_pieces, 0, pc.klast, true, true) - 1;
  }
#pragma unroll 1
  for (int c0 = 0; c0 < w; c0 += COLS) {
    float tv[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = c0 + j;
      float acc = 0.f;
      bool first = true;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (i >= cnt || c >= w) break;
        if (i > 0 && s[i]) {                // the run before ends at i - 1
          if (first && !s[0]) hsum[c][t] = acc;
          else wrote |= put(pc, kk[i - 1], c, acc, partial, duni);
          first = false;
          acc = 0.f;
        }
        acc += v[i][j];
      }
      tv[j] = acc;
    }
    // the next columns' loads in flight across this chunk's scan and barrier
    if (c0 + COLS < w) load_terms(contrib, pp, cnt, w, c0 + COLS, v);
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const int st = 1 << q;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (c0 + j >= w) break;
        const float up = __shfl_up_sync(FULL, tv[j], st);
        if (lane >= st && !gs[q]) tv[j] = up + tv[j];
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) wtot[warp][c0 + j] = tv[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = c0 + j;
      if (c >= w) break;
      float carry = wtot[0][c];
      for (int q = 1; q < warp; ++q)
        carry = wflag[q] ? wtot[q][c] : carry + wtot[q][c];
      const float sum = (warp == 0 || g) ? tv[j] : carry + tv[j];
      const float up = __shfl_up_sync(FULL, sum, 1);
      const float prev = lane == 0 ? carry : up;   // thread t - 1's sum
      if (tail_ends) wrote |= put(pc, ktail, c, sum, partial, duni);
      if (head) wrote |= put(pc, kk[0], c, prev + hsum[c][t], partial, duni);
    }
  }
  // the runs that cross a piece boundary: count this piece in (both runs'
  // counters at once), and the last of a run's pieces adds its partials
  if (wrote) __threadfence();
  __syncthreads();
  if (warp != 0) return;
  int arrived = -1;
  if (lane == 0 && lead) arrived = atomicAdd(done + k0, 1);
  if (lane == 1 && trail) arrived = atomicAdd(done + k, 1);
  const bool last_a = lead && __shfl_sync(FULL, arrived, 0) == k1a - k0;
  const bool last_b = trail && __shfl_sync(FULL, arrived, 1) == k1b - k;
  if (!last_a && !last_b) return;
  __threadfence();
  if (lane >= w) return;
  if (last_a)
    add_partials(partial, k0, k1a, w, lane,
                 duni + (size_t)pc.kfirst * w + lane);
  if (last_b)
    add_partials(partial, k, k1b, w, lane,
                 duni + (size_t)pc.klast * w + lane);
}

}  // namespace

// Launch kernel B on ``stream``; returns cudaGetLastError() (0 =
// launched). hist [depth, 14, n], rnd [depth, 15, n], g and dst [14, n]
// float32; kind, idx and keys [depth, n] int32; contrib [depth, n, w];
// dlt_part [n / 128, (n_lights + 1) * 14]. n is a multiple of 1024.
// has_noise picks the variant with the marble's adjoint, which reads
// perlin_vec [256, 3] and perlin_perm [3, 256].
extern "C" int trace_wave_bwd_launch(
    const float* hist, const float* rnd, const int* kind, const int* idx,
    const float* g, const float* uni, const float* lt,
    float* dst, float* contrib, int* keys, float* dlt_part, int n,
    int depth, int w, int p_rows, int n_lights, int has_checker,
    const float* perlin_vec, const int* perlin_perm, int has_noise,
    void* stream) {
  if (n % TILE != 0 || (n_lights + 1) * LT_COLS > MAX_LT) return -1;
  BwdTables tb{uni, lt, perlin_vec, perlin_perm, w, n_lights, has_checker,
               p_rows};
  const int blocks = n / ROW;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && has_noise) {
    trace_wave_bwd_kernel<true><<<blocks, ROW, PERLIN_SMEM, s>>>(
        hist, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n,
        depth);
  } else if (blocks > 0) {
    trace_wave_bwd_kernel<false><<<blocks, ROW, 0, s>>>(
        hist, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n,
        depth);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch kernel D' on ``stream``; returns cudaGetLastError() (0 =
// launched). st (kernel D's input), g and dst [14, n], rnd [15, n]
// float32; kind, idx and keys [n] int32; contrib [n, w]; dlt_part
// [n / 128, (n_lights + 1) * 14]. n is a multiple of 1024; has_noise picks
// the variant, as in trace_wave_bwd_launch.
extern "C" int fused_bounce_bwd_launch(
    const float* st, const float* rnd, const int* kind, const int* idx,
    const float* g, const float* uni, const float* lt, float* dst,
    float* contrib, int* keys, float* dlt_part, int n, int w, int p_rows,
    int n_lights, int has_checker, const float* perlin_vec,
    const int* perlin_perm, int has_noise, void* stream) {
  if (n % TILE != 0 || (n_lights + 1) * LT_COLS > MAX_LT) return -1;
  BwdTables tb{uni, lt, perlin_vec, perlin_perm, w, n_lights, has_checker,
               p_rows};
  const int blocks = n / ROW;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && has_noise) {
    fused_bounce_bwd_kernel<true><<<blocks, ROW, PERLIN_SMEM, s>>>(
        st, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n, 1);
  } else if (blocks > 0) {
    fused_bounce_bwd_kernel<false><<<blocks, ROW, 0, s>>>(
        st, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch bwd_reduce on ``stream``: zero out (duni [p_rows, w], then done
// [pieces] int32: one memset), then one block per PIECE of the m sorted
// terms (keys, perm) and one per light-table entry, dlt [ltn] the sums of
// dlt_part [n_part, ltn]. partial [pieces, 2, w] is scratch.
extern "C" int bwd_reduce_launch(const float* contrib, const int* keys,
                                 const int* perm, int m, int p_rows, int w,
                                 float* partial, float* out,
                                 const float* dlt_part, int n_part, int ltn,
                                 float* dlt, void* stream) {
  if (w <= 0 || w > W_MAX || m < 0 || p_rows < 0) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pieces = (m + PIECE - 1) / PIECE;
  const size_t zeros = (size_t)p_rows * w + n_pieces;
  if (zeros > 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, zeros * sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int* done = reinterpret_cast<int*>(out + (size_t)p_rows * w);
  if (n_pieces + ltn > 0)
    bwd_reduce_kernel<<<n_pieces + ltn, RED, 0, s>>>(
        contrib, keys, perm, m, p_rows, w, n_pieces, partial, done, dlt_part,
        n_part, ltn, out, dlt);
  return static_cast<int>(cudaGetLastError());
}
