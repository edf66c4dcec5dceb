// The split route's kernels, on Hopper (sm_90a): what a bounce runs for a
// scene the whole-wave trace kernel cannot take (media, noise beside
// checker textures, tables past its 4,096 rows), one launch of each per
// bounce over the whole wave.
//
//   * quad_search_kernel (TPU kernel O) replaces
//     rust_ray_tracer_tpu/ops/pallas_quad.py _kernel (launched by
//     quad_search, pallas_quad.py:121): the closest parallelogram hit of
//     each ray, both sides, inclusive [0, 1]^2, the lowest index winning a
//     tie in t, with the per-cluster AABB cull. Plain version:
//     ops/intersect.py _quad_candidates.
//   * hit_attrs_kernel (TPU kernel J) replaces pallas_hit.py _kernel
//     (launched by _hit_planes_call, pallas_hit.py:218): phase-2 hit
//     attributes of the winner. Plain version: ops/hit_core.py
//     hit_plane_core.
//   * shade_update_kernel (TPU kernel H) replaces pallas_bounce.py
//     _make_su_kernel (launched by _su_planes_call, pallas_bounce.py:678):
//     shading of all five materials and the estimator update, the albedo
//     given. Plain version: ops/bounce.py su_plane_core.
//   * hit_attrs_bwd_kernel (TPU kernel J') replaces pallas_hit.py
//     _bwd_kernel (launched by _hp_bwd, pallas_hit.py:245): J's adjoint,
//     the cotangent of its 19 input planes. Plain version:
//     ops/hit_core.py hit_plane_core_vjp.
//   * shade_update_bwd_kernel (TPU kernel H') replaces pallas_bounce.py
//     _make_su_bwd_kernel (launched by _su_bwd, pallas_bounce.py:705, its
//     per-tile light-table partials summed at :731-733): H's adjoint, the
//     cotangents of its 40 input planes and of the light table. Plain
//     version: ops/bounce.py su_plane_core_vjp.
//   * bounce_planes_kernel (TPU kernel F) replaces pallas_bounce.py
//     _make_kernel (launched by _bounce_planes_call, pallas_bounce.py:337):
//     the whole bounce of a scene whose textures are solid or checkers of
//     solids — J's hit attributes, the checker select at the hit point,
//     H's shading and estimator update — in one kernel. Plain version:
//     ops/bounce_core.py bounce_plane_core.
//   * bounce_planes_bwd_kernel (TPU kernel F') replaces pallas_bounce.py
//     _make_bwd_kernel (launched by _bp_bwd, pallas_bounce.py:369, its
//     per-tile light-table partials summed at :399-401): F's adjoint.
//     Plain version: ops/bounce_core.py bounce_plane_core_vjp.
//   * G and G' are F and F' launched with tlive, one flag a 1024-lane tile
//     (bounce_planes_live_launch, bounce_planes_live_bwd_launch). G replaces
//     pallas_bounce.py _make_kernel_live (launched by bounce_planes_live,
//     :497) and G' _make_bwd_kernel_live (launched by _bpl_bwd, :532, its
//     partials summed at :566): the unfused uber bounce's shading
//     (RRT_NO_UBER_FUSED=1), after kernel E (trace_wave.cu). A block of a
//     tile with no live lane copies o, d, L, beta and alive through (G), or
//     writes that copy's cotangent, zeros and a zero light-table partial
//     (G'). Plain versions: ops/bounce.py bounce_planes_live_plain and
//     bounce_planes_live_bwd_plain. A null tlive is F and F'.
//
// What bounds them on the card. O: fp32 work, ~45 operations per ray and
// quad tested (1,408 quads on final_scene, 11 clusters of 128); a block of
// 128 rays votes the slab test of each cluster (__syncthreads_or, as A culls
// its triangle chunks), skips the clusters none of its live rays enters,
// and stages the others' quads in shared memory, with the normal and
// 1/|n|^2 computed once per quad. J and H: memory, 19 + 2 planes in and 12
// out (J), 40 + 1 in and 13 out (H), a few hundred operations per ray: one
// thread per ray, every plane read and written coalesced. H keeps the light
// table in shared memory.
//
// F and F' are bound by memory as J, H, J' and H' are: F reads 13 planes
// of a dead lane and ~50 of a found one and writes 13; F' reads 13 to ~50
// and writes every input plane's cotangent. One thread per ray, the planes
// read and written coalesced; F' recomputes F's forward from the saved
// planes and keeps the light table's cotangent as H' does. G and G' move
// F's and F''s bytes on a live tile; on a dead one G reads 13 planes and
// writes 13, G' reads 12 and writes every input plane's, so a dead tile
// costs a copy, not the shading.
//
// J and H call the device functions that kernel A runs inline
// (trace_common.cuh: hit_attrs, shade, update_found, update_miss), so the
// three compute a bounce alike, and F calls them in turn; J', H' and F'
// call the adjoints that kernel B runs (trace_bwd_common.cuh:
// hit_attrs_vjp, shade_fwd + shade_vjp, update_found_vjp,
// update_miss_vjp), so the split route's backward and the whole-wave
// route's are one copy. J' and H' are bound by memory, as J
// and H: 19 + 2 + 12 planes in and 19 out (J'); for H', by lane class, a
// dead lane reads 13 planes and a found one ~47, and every lane writes
// 40. One thread per ray recomputes its forward (J's attributes, H's
// shading) from the saved inputs instead of reading residuals. H''s
// light-table cotangent stays in each thread's local array and is summed
// in a fixed order, per block and then across the blocks by B'
// (bwd_reduce_kernel) in block order, as F''s: no float atomics, so the
// gradients repeat bit for bit.
//
// The library is built with --fmad=false: its plain versions are torch
// elementwise ops, which never contract a*b+c, and final_scene's noise
// sphere and free-flight distances amplify an FMA's last ulp. Ties and predicates are the plain versions' exactly: strict <,
// ascending quad ids, |denom| > 0, t in [tmin, tmax], 0 <= alpha, beta <= 1.

#include "trace_bwd_common.cuh"

namespace {

using namespace trace;

constexpr int QCL = 128;      // quads per cluster (models/scene.py CLUSTER)
constexpr int QCOLS = 13;     // staged quad: q, u, v, n, 1 / |n|^2
constexpr float CULL_EPS = 1e-3f;   // the cull box margin
constexpr int N_HIT_IN = 19, N_HIT_OUT = 12;
constexpr int N_SU = 40, N_SU_OUT = 13;
constexpr int MAX_LT = 128;   // (n_lights + 1) * LT_COLS <= 128

// Does the ray enter the box [lo - eps, hi + eps] within [tmin, tmax]?
// pallas_intersect._tile_cluster_mask for one ray: axes with |d| < 1e-12
// ask for the origin inside the slab; an inverted (empty) box never passes.
__device__ __forceinline__ bool enters_box(V3 o, V3 d, float tmin,
                                           float tmax,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi) {
  const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
  float enter = -INFINITY, exit_ = INFINITY;
  bool ok = tmax > tmin;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ok = ok && lo[a] <= hi[a];
    const float l = lo[a] - CULL_EPS, h = hi[a] + CULL_EPS;
    if (fabsf(dd[a]) < 1e-12f) {
      ok = ok && oo[a] >= l && oo[a] <= h;
    } else {
      const float inv = 1.f / dd[a];
      const float t0 = (l - oo[a]) * inv, t1 = (h - oo[a]) * inv;
      enter = jmax(enter, jmin(t0, t1));
      exit_ = jmin(exit_, jmax(t0, t1));
    }
  }
  return ok && enter <= exit_ && exit_ >= tmin && enter <= tmax;
}

// rays [n, 8] = o, d, tmin, tmax (a dead lane has tmax < tmin); quads
// [n_quads, 9] = q, u, v (zero-edge pads never hit); cluster boxes
// [n_clusters, 3] each. best_t [n] (inf: none), best_i [n] (0: none).
__global__ void __launch_bounds__(ROW)
quad_search_kernel(const float* __restrict__ rays,
                   const float* __restrict__ quads,
                   const float* __restrict__ cl_min,
                   const float* __restrict__ cl_max, int n, int n_quads,
                   int n_clusters, float* __restrict__ best_t,
                   int* __restrict__ best_i) {
  __shared__ float sq[QCL * QCOLS];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const bool in = i < n;
  const float* ray = rays + (size_t)(in ? i : 0) * 8;
  const V3 o = {ray[0], ray[1], ray[2]}, d = {ray[3], ray[4], ray[5]};
  const float tmin = ray[6];
  const float tmax = in ? ray[7] : -INFINITY;
  const bool live = in && tmax > tmin;
  float bt = INFINITY;
  int bi = 0;
  for (int c = 0; c < n_clusters; ++c) {
    const bool enter = live && enters_box(o, d, tmin, tmax, cl_min + 3 * c,
                                          cl_max + 3 * c);
    if (!__syncthreads_or(enter)) continue;
    const int base = c * QCL;
    const int cnt = min(QCL, n_quads - base);
    for (int k = threadIdx.x; k < cnt; k += ROW) {
      const float* qd = quads + (size_t)(base + k) * 9;
      float* s = sq + k * QCOLS;
#pragma unroll
      for (int j = 0; j < 9; ++j) s[j] = qd[j];
      const float nx = qd[4] * qd[8] - qd[5] * qd[7];
      const float ny = qd[5] * qd[6] - qd[3] * qd[8];
      const float nz = qd[3] * qd[7] - qd[4] * qd[6];
      s[9] = nx;
      s[10] = ny;
      s[11] = nz;
      s[12] = safe_div(1.f, nx * nx + ny * ny + nz * nz);
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < cnt; ++k) {
        const float* s = sq + k * QCOLS;
        const float qx = s[0], qy = s[1], qz = s[2];
        const float ux = s[3], uy = s[4], uz = s[5];
        const float vx = s[6], vy = s[7], vz = s[8];
        const float nx = s[9], ny = s[10], nz = s[11], inv_n2 = s[12];
        const float denom = d.x * nx + d.y * ny + d.z * nz;
        const float t = safe_div((qx - o.x) * nx + (qy - o.y) * ny +
                                     (qz - o.z) * nz, denom);
        const float wx = o.x + t * d.x - qx;
        const float wy = o.y + t * d.y - qy;
        const float wz = o.z + t * d.z - qz;
        const float al = ((wy * vz - wz * vy) * nx + (wz * vx - wx * vz) * ny +
                          (wx * vy - wy * vx) * nz) * inv_n2;
        const float be = ((uy * wz - uz * wy) * nx + (uz * wx - ux * wz) * ny +
                          (ux * wy - uy * wx) * nz) * inv_n2;
        const bool valid = fabsf(denom) > 0.f && t >= tmin && t <= tmax &&
                           al >= 0.f && al <= 1.f && be >= 0.f && be <= 1.f;
        if (valid && t < bt) {
          bt = t;
          bi = base + k;
        }
      }
    }
    __syncthreads();      // the next cluster overwrites sq
  }
  if (in) {
    best_t[i] = bt;
    best_i[i] = min(bi, n_quads - 1);
  }
}

// P [19, n] = o(3) d(3) time tmin tmax pack(9) tmed; kind, flip [n];
// out [12, n] = t p(3) n(3) u v, and the sphere reading's UV source (the
// unit normal at the near root, else the hit point) on every lane, as the
// plain version computes it; the caller's epilogue uses it on sphere lanes.
__global__ void __launch_bounds__(ROW)
hit_attrs_kernel(const float* __restrict__ P, const int* __restrict__ kind,
                 const int* __restrict__ flip, float* __restrict__ out,
                 int n) {
  const int i = blockIdx.x * ROW + threadIdx.x;
  if (i >= n) return;
  float x[N_HIT_IN];
#pragma unroll
  for (int c = 0; c < N_HIT_IN; ++c) x[c] = P[(size_t)c * n + i];
  const V3 o = {x[0], x[1], x[2]}, d = {x[3], x[4], x[5]};
  const float time = x[6], tmin = x[7], tmax = x[8];
  const float* pk = x + 9;
  const HitAttrs h = hit_attrs(kind[i], o, d, time, tmin, tmax, pk, x[18],
                               flip[i] > 0);
  const SphereView s = sphere_view(o, d, time, tmin, tmax, pk);
  const V3 ps = {o.x + s.t * d.x, o.y + s.t * d.y, o.z + s.t * d.z};
  const V3 uv = s.ok1 ? V3{(ps.x - s.cen.x) * s.inv_r,
                           (ps.y - s.cen.y) * s.inv_r,
                           (ps.z - s.cen.z) * s.inv_r}
                      : ps;
  const float y[N_HIT_OUT] = {h.t, h.p.x, h.p.y, h.p.z, h.n.x, h.n.y,
                              h.n.z, h.u, h.v, uv.x, uv.y, uv.z};
#pragma unroll
  for (int c = 0; c < N_HIT_OUT; ++c) out[(size_t)c * n + i] = y[c];
}

// P [40, n] = o(3) d(3) p(3) n(3) albedo(3) fuzz ior L(3) beta(3) ub(9)
// gb(6) alive hit; mkind [n]; lt [(n_lights + 1), LT_COLS], the last row
// the background. out [13, n] = o' d' L' beta' alive'.
__global__ void __launch_bounds__(ROW)
shade_update_kernel(const float* __restrict__ P,
                    const int* __restrict__ mkind,
                    const float* __restrict__ lt, int n_lights,
                    float* __restrict__ out, int n) {
  __shared__ float slt[MAX_LT];
  for (int k = threadIdx.x; k < (n_lights + 1) * LT_COLS; k += ROW)
    slt[k] = lt[k];
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
  if (i >= n) return;
  auto at = [&](int c) { return P[(size_t)c * n + i]; };
  V3 o = {at(0), at(1), at(2)}, d = {at(3), at(4), at(5)};
  V3 L = {at(17), at(18), at(19)}, beta = {at(20), at(21), at(22)};
  float alive = 0.f;
  if (at(38) > 0.5f) {                  // a live ray
    if (at(39) > 0.5f) {                // that found something
      const V3 p = {at(6), at(7), at(8)};
      const Scatter sc = shade(mkind[i], d, {at(9), at(10), at(11)}, p,
                               {at(12), at(13), at(14)}, at(15), at(16),
                               slt, n_lights, P + (size_t)23 * n + i,
                               (size_t)n);
      update_found(sc, p, o, d, L, beta, alive);
    } else {
      update_miss(slt + n_lights * LT_COLS, L, beta, alive);
    }
  }
  const float y[N_SU_OUT] = {o.x, o.y, o.z, d.x, d.y, d.z, L.x, L.y, L.z,
                             beta.x, beta.y, beta.z, alive};
#pragma unroll
  for (int c = 0; c < N_SU_OUT; ++c) out[(size_t)c * n + i] = y[c];
}

// ---- the backward kernels ------------------------------------------------

// J': P, kind, flip as J's; g [12, n] the cotangents of J's outputs. dP
// [19, n]: those of o, d, time, (tmin, tmax: none), the pack and tmed.
__global__ void __launch_bounds__(ROW)
hit_attrs_bwd_kernel(const float* __restrict__ P, const int* __restrict__ kind,
                     const int* __restrict__ flip, const float* __restrict__ g,
                     float* __restrict__ dP, int n) {
  const int i = blockIdx.x * ROW + threadIdx.x;
  if (i >= n) return;
  float x[N_HIT_IN];
#pragma unroll
  for (int c = 0; c < N_HIT_IN; ++c) x[c] = P[(size_t)c * n + i];
  float gc[N_HIT_OUT];
#pragma unroll
  for (int c = 0; c < N_HIT_OUT; ++c) gc[c] = g[(size_t)c * n + i];
  const V3 o = {x[0], x[1], x[2]}, d = {x[3], x[4], x[5]};
  const float time = x[6], tmin = x[7], tmax = x[8];
  const float* pk = x + 9;
  const int kd = kind[i];
  // the forward without the FlipFace fold: the raw t (0 on a miss), the
  // hit point, and the normal's y whose sign picks the branch of -|ny|
  const HitAttrs h = hit_attrs(kd, o, d, time, tmin, tmax, pk, x[18],
                               false);
  const float t = kd == KIND_NONE ? 0.f : h.t;
  V3 g_o = {0.f, 0.f, 0.f}, g_d = {0.f, 0.f, 0.f};
  float g_time = 0.f, g_tmed = 0.f;
  float g_pk[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  hit_attrs_vjp<true>(kd, o, d, time, tmin, tmax, pk, flip[i] > 0, h.n.y, t,
                      h.p, {gc[0], {gc[1], gc[2], gc[3]},
                            {gc[4], gc[5], gc[6]}, gc[7], gc[8],
                            {gc[9], gc[10], gc[11]}},
                      g_o, g_d, g_time, g_pk, g_tmed);
  const float y[N_HIT_IN] = {g_o.x, g_o.y, g_o.z, g_d.x, g_d.y, g_d.z,
                             g_time, 0.f, 0.f, g_pk[0], g_pk[1], g_pk[2],
                             g_pk[3], g_pk[4], g_pk[5], g_pk[6], g_pk[7],
                             g_pk[8], g_tmed};
#pragma unroll
  for (int c = 0; c < N_HIT_IN; ++c) dP[(size_t)c * n + i] = y[c];
}

// Sum of v over a warp (a fixed tree: the same bits in every run).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// H': P, mkind, lt as H's; g [13, n] the cotangents of H's outputs. dP
// [40, n]: those of o, d, p, n, albedo, fuzz, ior, L and beta (the randoms,
// alive and hit take none). The light table's, through the mixture pdf of
// Lambertian hits and the background of live misses, leaves as one partial
// a block: each ray keeps its share in a local array, and a block sums its
// rays' (each warp by a fixed tree, then the warps in order) into
// dlt_part [gridDim.x, (n_lights + 1) * LT_COLS], kernel B's layout, which
// bwd_reduce_kernel's light-table blocks sum in block order. No float
// atomics: the same bits in every run.
__global__ void __launch_bounds__(ROW)
shade_update_bwd_kernel(const float* __restrict__ P,
                        const int* __restrict__ mkind,
                        const float* __restrict__ lt, int n_lights,
                        const float* __restrict__ g, float* __restrict__ dP,
                        float* __restrict__ dlt_part, int n) {
  __shared__ float slt[MAX_LT];
  __shared__ float red[ROW / 32][MAX_LT];
  const int ltn = (n_lights + 1) * LT_COLS;
  for (int k = threadIdx.x; k < ltn; k += ROW) slt[k] = lt[k];
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
  float dl[MAX_LT];                        // this ray's light-table share
  for (int k = 0; k < ltn; ++k) dl[k] = 0.f;
  if (i < n) {
    auto at = [&](int c) { return P[(size_t)c * n + i]; };
    auto gat = [&](int c) { return g[(size_t)c * n + i]; };
    const V3 go = {gat(0), gat(1), gat(2)}, gd = {gat(3), gat(4), gat(5)};
    const V3 gL = {gat(6), gat(7), gat(8)}, gb = {gat(9), gat(10), gat(11)};
    V3 g_o = go, g_d = gd, g_beta = gb;    // a dead lane passes through
    V3 g_p = {0.f, 0.f, 0.f}, g_n = g_p, g_a = g_p;
    float g_fuzz = 0.f, g_ior = 0.f;
    if (at(38) > 0.5f) {                   // a live ray
      const V3 beta = {at(20), at(21), at(22)};
      if (at(39) > 0.5f) {                 // that found something
        const V3 d = {at(3), at(4), at(5)}, p = {at(6), at(7), at(8)};
        const V3 nrm = {at(9), at(10), at(11)};
        const V3 alb = {at(12), at(13), at(14)};
        const float* __restrict__ r = P + (size_t)23 * n + i;
        const int mk = mkind[i];
        const ShadeFwd sf = shade_fwd(mk, d, nrm, p, alb, at(15), slt,
                                      n_lights, r, (size_t)n);
        const UpdateVjp u = update_found_vjp(beta, sf.em, sf.wt, sf.alive,
                                             go, gd, gL, gb);
        g_beta = u.g_beta;
        g_o = u.g_o;
        g_d = u.g_d;
        g_p = u.g_p;
        shade_vjp(sf, mk, d, nrm, p, alb, at(16), slt, n_lights, r,
                  (size_t)n, u.g_em, u.g_wt, u.g_sd, g_d, g_p, g_n, g_a,
                  g_fuzz, g_ior, dl);
      } else {
        g_beta = update_miss_vjp(slt + n_lights * LT_COLS, beta, gL, gb,
                                 dl + n_lights * LT_COLS);
      }
    }
    const float y[23] = {g_o.x, g_o.y, g_o.z, g_d.x, g_d.y, g_d.z,
                         g_p.x, g_p.y, g_p.z, g_n.x, g_n.y, g_n.z,
                         g_a.x, g_a.y, g_a.z, g_fuzz, g_ior,
                         gL.x, gL.y, gL.z, g_beta.x, g_beta.y, g_beta.z};
#pragma unroll
    for (int c = 0; c < 23; ++c) dP[(size_t)c * n + i] = y[c];
#pragma unroll
    for (int c = 23; c < N_SU; ++c) dP[(size_t)c * n + i] = 0.f;
  }

  // the block's partial
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < ltn; ++k) {
    const float v = warp_sum(dl[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ltn; k += ROW) {
    float acc = red[0][k];
#pragma unroll
    for (int w = 1; w < ROW / 32; ++w) acc += red[w][k];
    dlt_part[(size_t)blockIdx.x * ltn + k] = acc;
  }
}

// ---- F and F': the fused bounce of solid and checker scenes ------------
// ---- G and G': F and F' that skip a 1024-lane tile with no live ray ----

constexpr int N_IN_B = 46, N_CHK = 6;
constexpr int TILE_ROWS = 8;       // blocks a liveness flag covers

// G's and G''s test: tlive holds one flag a 1024-lane tile (1: a live
// lane), the tile of pallas_bounce._LIVE_BR rows of 128; null for F, F'.
__device__ __forceinline__ bool tile_dead(const int* __restrict__ tlive) {
  return tlive != nullptr && tlive[blockIdx.x / TILE_ROWS] == 0;
}

// F: P [46 (+6), n] = o(3) d(3) time tmin tmax pack(9) tmed | albedo(3)
// fuzz ior | L(3) beta(3) | ub(9) gb(6) | alive (| even(3) odd(3) with
// has_checker); pkind, mkind, flags [n] (bit 0 FlipFace, bit 1 checker);
// lt [(n_lights + 1), LT_COLS], the last row the background. out [13, n]
// = o' d' L' beta' alive'. The winner's hit attributes (J's hit_attrs),
// the checker select at the hit point, the shading and the estimator
// update (H's shade, update_found, update_miss), one thread per ray. G:
// the same with tlive (tile_dead).
__global__ void __launch_bounds__(ROW)
bounce_planes_kernel(const float* __restrict__ P,
                     const int* __restrict__ pkind,
                     const int* __restrict__ mkind,
                     const int* __restrict__ flags,
                     const int* __restrict__ tlive,
                     const float* __restrict__ lt, int n_lights,
                     int has_checker, float* __restrict__ out, int n) {
  if (tile_dead(tlive)) {               // G's all-dead tile
    const int i = blockIdx.x * ROW + threadIdx.x;
    if (i < n) {
      // o, d, L, beta and alive (0) through (pallas_bounce.py:434-441)
      for (int c = 0; c < N_SU_OUT; ++c) {
        const int src = c < 6 ? c : (c < 12 ? c + 18 : 45);
        out[(size_t)c * n + i] = P[(size_t)src * n + i];
      }
    }
    return;
  }
  __shared__ float slt[MAX_LT];
  for (int k = threadIdx.x; k < (n_lights + 1) * LT_COLS; k += ROW)
    slt[k] = lt[k];
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
  if (i >= n) return;
  auto at = [&](int c) { return P[(size_t)c * n + i]; };
  V3 o = {at(0), at(1), at(2)}, d = {at(3), at(4), at(5)};
  V3 L = {at(24), at(25), at(26)}, beta = {at(27), at(28), at(29)};
  float alive = 0.f;
  if (at(45) > 0.5f) {                  // a live ray
    const int kd = pkind[i];
    if (kd != KIND_NONE) {              // that found something
      const int fl = flags[i];
      float pk[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) pk[c] = at(9 + c);
      const HitAttrs h = hit_attrs(kd, o, d, at(6), at(7), at(8), pk,
                                   at(18), (fl & 1) != 0);
      int leaf = 19;                    // the albedo planes
      if (has_checker && (fl & 2)) {
        // checker (texture.rs:50-57): the sin-product sign picks the leaf
        const float sines = sinf(10.f * h.p.x) * sinf(10.f * h.p.y) *
                            sinf(10.f * h.p.z);
        leaf = sines < 0.f ? N_IN_B + 3 : N_IN_B;
      }
      const Scatter sc = shade(mkind[i], d, h.n, h.p,
                               {at(leaf), at(leaf + 1), at(leaf + 2)},
                               at(22), at(23), slt, n_lights,
                               P + (size_t)30 * n + i, (size_t)n);
      update_found(sc, h.p, o, d, L, beta, alive);
    } else {
      update_miss(slt + n_lights * LT_COLS, L, beta, alive);
    }
  }
  const float y[N_SU_OUT] = {o.x, o.y, o.z, d.x, d.y, d.z, L.x, L.y, L.z,
                             beta.x, beta.y, beta.z, alive};
#pragma unroll
  for (int c = 0; c < N_SU_OUT; ++c) out[(size_t)c * n + i] = y[c];
}

// F': P, pkind, mkind, flags, lt as F's; g [13, n] the cotangents of F's
// outputs. dP [46 (+6), n]: those of o, d, time, the pack, tmed, the
// chosen albedo leaf (the base planes, or the checker's even or odd leaf;
// the select carries none), fuzz, ior, L and beta (tmin, tmax, the
// randoms and alive take none). The forward is recomputed from the saved
// planes; then the adjoints of the update, the shading and the hit
// attributes (trace_bwd_common.cuh, the functions B, J' and H' run). The
// light table's cotangent leaves as one partial a block in kernel B's
// layout, as H''s does, for bwd_reduce_kernel to sum in block order: no
// float atomics. G': the same with tlive (tile_dead).
__global__ void __launch_bounds__(ROW)
bounce_planes_bwd_kernel(const float* __restrict__ P,
                         const int* __restrict__ pkind,
                         const int* __restrict__ mkind,
                         const int* __restrict__ flags,
                         const int* __restrict__ tlive,
                         const float* __restrict__ lt, int n_lights,
                         int has_checker, const float* __restrict__ g,
                         float* __restrict__ dP, float* __restrict__ dlt_part,
                         int n) {
  const int ltn = (n_lights + 1) * LT_COLS;
  const int n_in = has_checker ? N_IN_B + N_CHK : N_IN_B;
  if (tile_dead(tlive)) {    // G''s all-dead tile: the pass-through's vjp
    const int i = blockIdx.x * ROW + threadIdx.x;
    if (i < n) {
      for (int c = 0; c < n_in; ++c) {
        const int src = c < 6 ? c : (c >= 24 && c < 30 ? c - 18 : -1);
        dP[(size_t)c * n + i] = src < 0 ? 0.f : g[(size_t)src * n + i];
      }
    }
    // a zero partial: B' sums every block's in block order
    for (int k = threadIdx.x; k < ltn; k += ROW)
      dlt_part[(size_t)blockIdx.x * ltn + k] = 0.f;
    return;
  }
  __shared__ float slt[MAX_LT];
  __shared__ float red[ROW / 32][MAX_LT];
  for (int k = threadIdx.x; k < ltn; k += ROW) slt[k] = lt[k];
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
  float dl[MAX_LT];                        // this ray's light-table share
  for (int k = 0; k < ltn; ++k) dl[k] = 0.f;
  if (i < n) {
    auto at = [&](int c) { return P[(size_t)c * n + i]; };
    auto gat = [&](int c) { return g[(size_t)c * n + i]; };
    const V3 go = {gat(0), gat(1), gat(2)}, gd = {gat(3), gat(4), gat(5)};
    const V3 gL = {gat(6), gat(7), gat(8)}, gb = {gat(9), gat(10), gat(11)};
    V3 g_o = go, g_d = gd, g_beta = gb;    // a dead lane passes through
    float g_time = 0.f, g_tmed = 0.f, g_fuzz = 0.f, g_ior = 0.f;
    float g_pk[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    V3 g_a = {0.f, 0.f, 0.f};
    int leaf = 19;
    if (at(45) > 0.5f) {                   // a live ray
      const V3 beta = {at(27), at(28), at(29)};
      const int kd = pkind[i];
      if (kd != KIND_NONE) {               // that found something
        const int fl = flags[i];
        const bool flip = (fl & 1) != 0;
        const V3 o = {at(0), at(1), at(2)}, d = {at(3), at(4), at(5)};
        const float time = at(6), tmin = at(7), tmax = at(8);
        float pk[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) pk[c] = at(9 + c);
        // the forward without the FlipFace fold (J''s): the raw t, the hit
        // point and the normal's y whose sign picks the branch of -|ny|
        const HitAttrs h = hit_attrs(kd, o, d, time, tmin, tmax, pk, at(18),
                                     false);
        V3 nrm = h.n;
        if (flip) nrm.y = -fabsf(nrm.y);
        if (has_checker && (fl & 2)) {
          const float sines = sinf(10.f * h.p.x) * sinf(10.f * h.p.y) *
                              sinf(10.f * h.p.z);
          leaf = sines < 0.f ? N_IN_B + 3 : N_IN_B;
        }
        const V3 alb = {at(leaf), at(leaf + 1), at(leaf + 2)};
        const float* __restrict__ r = P + (size_t)30 * n + i;
        const int mk = mkind[i];
        const ShadeFwd sf = shade_fwd(mk, d, nrm, h.p, alb, at(22), slt,
                                      n_lights, r, (size_t)n);
        const UpdateVjp u = update_found_vjp(beta, sf.em, sf.wt, sf.alive,
                                             go, gd, gL, gb);
        g_beta = u.g_beta;
        g_o = u.g_o;
        g_d = u.g_d;
        V3 g_p = u.g_p, g_n;
        shade_vjp(sf, mk, d, nrm, h.p, alb, at(23), slt, n_lights, r,
                  (size_t)n, u.g_em, u.g_wt, u.g_sd, g_d, g_p, g_n, g_a,
                  g_fuzz, g_ior, dl);
        hit_attrs_vjp<true>(kd, o, d, time, tmin, tmax, pk, flip, h.n.y,
                            h.t, h.p, {0.f, g_p, g_n, 0.f, 0.f,
                                       {0.f, 0.f, 0.f}},
                            g_o, g_d, g_time, g_pk, g_tmed);
      } else {
        g_beta = update_miss_vjp(slt + n_lights * LT_COLS, beta, gL, gb,
                                 dl + n_lights * LT_COLS);
      }
    }
    const float y[30] = {g_o.x, g_o.y, g_o.z, g_d.x, g_d.y, g_d.z, g_time,
                         0.f, 0.f, g_pk[0], g_pk[1], g_pk[2], g_pk[3],
                         g_pk[4], g_pk[5], g_pk[6], g_pk[7], g_pk[8], g_tmed,
                         0.f, 0.f, 0.f, g_fuzz, g_ior, gL.x, gL.y, gL.z,
                         g_beta.x, g_beta.y, g_beta.z};
#pragma unroll
    for (int c = 0; c < 30; ++c) dP[(size_t)c * n + i] = y[c];
    for (int c = 30; c < n_in; ++c) dP[(size_t)c * n + i] = 0.f;
    dP[(size_t)leaf * n + i] = g_a.x;
    dP[(size_t)(leaf + 1) * n + i] = g_a.y;
    dP[(size_t)(leaf + 2) * n + i] = g_a.z;
  }

  // the block's partial
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < ltn; ++k) {
    const float v = warp_sum(dl[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ltn; k += ROW) {
    float acc = red[0][k];
#pragma unroll
    for (int w = 1; w < ROW / 32; ++w) acc += red[w][k];
    dlt_part[(size_t)blockIdx.x * ltn + k] = acc;
  }
}

int launched(int n) {
  return n > 0 ? static_cast<int>(cudaGetLastError()) : 0;
}

}  // namespace

// Each entry launches on ``stream`` and returns cudaGetLastError() (0 =
// launched). Shapes as above; n is the ray count (any n >= 0).
extern "C" int quad_search_launch(const float* rays, const float* quads,
                                  const float* cl_min, const float* cl_max,
                                  int n, int n_quads, int n_clusters,
                                  float* best_t, int* best_i, void* stream) {
  if (n > 0)
    quad_search_kernel<<<(n + ROW - 1) / ROW, ROW, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rays, quads, cl_min, cl_max, n, n_quads, n_clusters, best_t, best_i);
  return launched(n);
}

extern "C" int hit_attrs_launch(const float* P, const int* kind,
                                const int* flip, float* out, int n,
                                void* stream) {
  if (n > 0)
    hit_attrs_kernel<<<(n + ROW - 1) / ROW, ROW, 0,
                       static_cast<cudaStream_t>(stream)>>>(P, kind, flip,
                                                            out, n);
  return launched(n);
}

extern "C" int shade_update_launch(const float* P, const int* mkind,
                                   const float* lt, int n_lights, float* out,
                                   int n, void* stream) {
  if ((n_lights + 1) * LT_COLS > MAX_LT) return -1;
  if (n > 0)
    shade_update_kernel<<<(n + ROW - 1) / ROW, ROW, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        P, mkind, lt, n_lights, out, n);
  return launched(n);
}

extern "C" int hit_attrs_bwd_launch(const float* P, const int* kind,
                                    const int* flip, const float* g,
                                    float* dP, int n, void* stream) {
  if (n > 0)
    hit_attrs_bwd_kernel<<<(n + ROW - 1) / ROW, ROW, 0,
                           static_cast<cudaStream_t>(stream)>>>(P, kind, flip,
                                                                g, dP, n);
  return launched(n);
}

// dlt_part [ceil(n / ROW), (n_lights + 1) * LT_COLS]: the blocks'
// light-table partials. With n == 0 nothing is launched.
extern "C" int shade_update_bwd_launch(const float* P, const int* mkind,
                                       const float* lt, int n_lights,
                                       const float* g, float* dP,
                                       float* dlt_part, int n, void* stream) {
  if ((n_lights + 1) * LT_COLS > MAX_LT) return -1;
  if (n > 0)
    shade_update_bwd_kernel<<<(n + ROW - 1) / ROW, ROW, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        P, mkind, lt, n_lights, g, dP, dlt_part, n);
  return launched(n);
}

extern "C" int bounce_planes_launch(const float* P, const int* pkind,
                                    const int* mkind, const int* flags,
                                    const float* lt, int n_lights,
                                    int has_checker, float* out, int n,
                                    void* stream) {
  if ((n_lights + 1) * LT_COLS > MAX_LT) return -1;
  if (n > 0)
    bounce_planes_kernel<<<(n + ROW - 1) / ROW, ROW, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        P, pkind, mkind, flags, nullptr, lt, n_lights, has_checker, out, n);
  return launched(n);
}

// G: F with tlive [n / 1024] int32, one flag a 1024-lane tile; n a
// multiple of 1024.
extern "C" int bounce_planes_live_launch(const float* P, const int* pkind,
                                         const int* mkind, const int* flags,
                                         const int* tlive, const float* lt,
                                         int n_lights, int has_checker,
                                         float* out, int n, void* stream) {
  if ((n_lights + 1) * LT_COLS > MAX_LT || n % (TILE_ROWS * ROW) ||
      tlive == nullptr)
    return -1;
  if (n > 0)
    bounce_planes_kernel<<<n / ROW, ROW, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        P, pkind, mkind, flags, tlive, lt, n_lights, has_checker, out, n);
  return launched(n);
}

// dlt_part [ceil(n / ROW), (n_lights + 1) * LT_COLS]: the blocks'
// light-table partials. With n == 0 nothing is launched.
extern "C" int bounce_planes_bwd_launch(const float* P, const int* pkind,
                                        const int* mkind, const int* flags,
                                        const float* lt, int n_lights,
                                        int has_checker, const float* g,
                                        float* dP, float* dlt_part, int n,
                                        void* stream) {
  if ((n_lights + 1) * LT_COLS > MAX_LT) return -1;
  if (n > 0)
    bounce_planes_bwd_kernel<<<(n + ROW - 1) / ROW, ROW, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        P, pkind, mkind, flags, nullptr, lt, n_lights, has_checker, g, dP,
        dlt_part, n);
  return launched(n);
}

// G': F' with G's tlive; dlt_part [n / 128, (n_lights + 1) * LT_COLS], a
// dead tile's blocks writing zeros.
extern "C" int bounce_planes_live_bwd_launch(
    const float* P, const int* pkind, const int* mkind, const int* flags,
    const int* tlive, const float* lt, int n_lights, int has_checker,
    const float* g, float* dP, float* dlt_part, int n, void* stream) {
  if ((n_lights + 1) * LT_COLS > MAX_LT || n % (TILE_ROWS * ROW) ||
      tlive == nullptr)
    return -1;
  if (n > 0)
    bounce_planes_bwd_kernel<<<n / ROW, ROW, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        P, pkind, mkind, flags, tlive, lt, n_lights, has_checker, g, dP,
        dlt_part, n);
  return launched(n);
}
