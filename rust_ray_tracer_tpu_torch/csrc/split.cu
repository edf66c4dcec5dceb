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
// What bounds them on the card. O: per test and warp, ~25 fp32
// operations for t (the denominator, the numerator and an IEEE division;
// the library is built --fmad=false, so no product and sum fuse), ~30
// more for alpha and beta where t can win (1,408 quads on final_scene, 11
// clusters of 128). Its design: a 128-ray block packs its live rays (a
// ballot and a prefix over its warps) so full warps sweep and a dead lane
// is written (inf, 0) at once, and sorts them by the set of clusters each
// enters, so a warp's rays agree; each warp votes the slab test of each
// cluster (__any_sync) and sweeps only the clusters one of its rays
// enters; the quads come as 16-float rows (q, u, v, n, 1 / |n|^2) that
// ops/quad.py quad_table builds once a scene, staged in shared memory per
// cluster (read from L1 they measured slower); a test computes t first, 4
// quads at a time, and goes on to alpha and beta only where t can win
// (strict <, so nothing else changes). After bounce 0 the rays scatter and
// a block walks most clusters behind two barriers each with few warps
// busy: latency, not issue, bounds it.
// J and H: memory, 19 + 2 planes in and 12
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
constexpr int QBLOCK = 128;   // rays per block of quad_search_kernel
constexpr int QMIN_BLOCKS = 9;   // its resident blocks an SM, at least
constexpr int QUNROLL = 4;    // quads whose t a sweep computes together
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float CULL_EPS = 1e-3f;   // the cull box margin
constexpr int N_HIT_IN = 19, N_HIT_OUT = 12;
constexpr int N_SU = 40, N_SU_OUT = 13;
constexpr int MAX_LT = 128;   // (n_lights + 1) * LT_COLS <= 128

// Does the ray enter the box [lo - eps, hi + eps] within [tmin, tmax]?
// pallas_intersect._tile_cluster_mask for one ray: axes with |d| < 1e-12
// ask for the origin inside the slab; an inverted (empty) box never passes.
// inv[a] = 1 / d[a], computed once a ray (the same IEEE quotient each time).
__device__ __forceinline__ bool enters_box(const float oo[3],
                                           const float dd[3],
                                           const float inv[3], float tmin,
                                           float tmax,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi) {
  float enter = -INFINITY, exit_ = INFINITY;
  bool ok = tmax > tmin;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float la = __ldg(lo + a), ha = __ldg(hi + a);
    ok = ok && la <= ha;
    const float l = la - CULL_EPS, h = ha + CULL_EPS;
    if (fabsf(dd[a]) < 1e-12f) {
      ok = ok && oo[a] >= l && oo[a] <= h;
    } else {
      const float t0 = (l - oo[a]) * inv[a], t1 = (h - oo[a]) * inv[a];
      enter = jmax(enter, jmin(t0, t1));
      exit_ = jmin(exit_, jmax(t0, t1));
    }
  }
  return ok && enter <= exit_ && exit_ >= tmin && enter <= tmax;
}

// One warp's sweep of a cluster's staged rows ``row`` [cnt, 4] (float4)
// for its ray, QUNROLL quads at a time: their t first, (q - o) . n /
// (d . n) in the plain version's order, then in ascending order only a t
// that can win (|denom| > 0, tmin <= t <= tmax, t < bt: strict <, so the
// lowest index keeps a tie) goes on to alpha and beta.
__device__ __forceinline__ void sweep_quads(const float4* row, int base,
                                            int cnt, const float oo[3],
                                            const float dd[3], float tmin,
                                            float tmax, float& bt, int& bi) {
  for (int k = 0; k < cnt; k += QUNROLL) {
    float den[QUNROLL], tq[QUNROLL];
#pragma unroll
    for (int j = 0; j < QUNROLL; ++j) {
      const int kk = min(k + j, cnt - 1);
      const float4 qa = row[4 * kk];        // qx qy qz ux
      const float4 qc = row[4 * kk + 2];    // vz nx ny nz
      den[j] = dd[0] * qc.y + dd[1] * qc.z + dd[2] * qc.w;
      tq[j] = safe_div((qa.x - oo[0]) * qc.y + (qa.y - oo[1]) * qc.z +
                           (qa.z - oo[2]) * qc.w, den[j]);
    }
#pragma unroll
    for (int j = 0; j < QUNROLL; ++j) {
      if (k + j >= cnt) break;
      if (!(fabsf(den[j]) > 0.f && tq[j] >= tmin && tq[j] <= tmax &&
            tq[j] < bt))
        continue;
      const float4 qa = row[4 * (k + j)];
      const float4 qb = row[4 * (k + j) + 1];   // uy uz vx vy
      const float4 qc = row[4 * (k + j) + 2];
      const float inv_n2 = row[4 * (k + j) + 3].x;   // 1 / |n|^2
      const float ux = qa.w, uy = qb.x, uz = qb.y;
      const float vx = qb.z, vy = qb.w, vz = qc.x;
      const float nx = qc.y, ny = qc.z, nz = qc.w;
      const float t = tq[j];
      const float wx = oo[0] + t * dd[0] - qa.x;
      const float wy = oo[1] + t * dd[1] - qa.y;
      const float wz = oo[2] + t * dd[2] - qa.z;
      const float al = ((wy * vz - wz * vy) * nx + (wz * vx - wx * vz) * ny +
                        (wx * vy - wy * vx) * nz) * inv_n2;
      const float be = ((uy * wz - uz * wy) * nx + (uz * wx - ux * wz) * ny +
                        (ux * wy - uy * wx) * nz) * inv_n2;
      if (al >= 0.f && al <= 1.f && be >= 0.f && be <= 1.f) {
        bt = t;
        bi = base + k + j;
      }
    }
  }
}

// The slab test's 1 / d once a ray (the same IEEE quotient each time).
__device__ __forceinline__ void inv_dir(const float dd[3], float inv[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    inv[a] = fabsf(dd[a]) < 1e-12f ? 0.f : 1.f / dd[a];
}

// rays [n, 8] = o, d, tmin, tmax (a dead lane has tmax <= tmin); quads
// [n_quads, 16] = q, u, v, n = u x v, 1 / |n|^2, 3 zeros (ops/quad.py
// quad_table; zero-edge pads never hit); cluster boxes [n_clusters, 3]
// each. best_t [n] (inf: none), best_i [n] (0: none). A block's live rays
// are packed (a ballot and a prefix) and sorted by the set of clusters
// each enters (bit c % 32 of a mask, then the packed order), so a warp's
// rays tend to enter the same clusters; the warps vote each cluster
// (__any_sync), the block stages a cluster some warp enters in shared
// memory and only those warps sweep it, in ascending order.
__global__ void __launch_bounds__(QBLOCK, QMIN_BLOCKS)
quad_search_kernel(const float* __restrict__ rays,
                   const float4* __restrict__ quads,
                   const float* __restrict__ cl_min,
                   const float* __restrict__ cl_max, int n, int n_quads,
                   int n_clusters, float* __restrict__ best_t,
                   int* __restrict__ best_i) {
  __shared__ float pray[8][QBLOCK];     // the live rays, packed
  __shared__ int pidx[QBLOCK];
  __shared__ unsigned long long skey[QBLOCK];   // (mask, packed slot)
  __shared__ int wlive[QBLOCK / 32];
  __shared__ float4 srow[QCL * 4];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i = blockIdx.x * QBLOCK + t;
  float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(rays) + 2 * i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(rays) + 2 * i + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  }
  const bool live = i < n && r[7] > r[6];
  if (i < n && !live) {                 // a dead lane finds nothing
    best_t[i] = INFINITY;
    best_i[i] = 0;
  }
  unsigned mask = 0u;                   // the clusters this ray enters
  if (live) {
    float inv[3];
    inv_dir(r + 3, inv);
    for (int c = 0; c < n_clusters; ++c)
      if (enters_box(r, r + 3, inv, r[6], r[7], cl_min + 3 * c,
                     cl_max + 3 * c))
        mask |= 1u << (c & 31);
  }
  // pack: a ballot in each warp, the warps' counts in order
  const unsigned bal = __ballot_sync(FULL_MASK, live);
  if (lane == 0) wlive[warp] = __popc(bal);
  __syncthreads();
  int off = 0, n_live = 0;
#pragma unroll
  for (int j = 0; j < QBLOCK / 32; ++j) {
    off += j < warp ? wlive[j] : 0;
    n_live += wlive[j];
  }
  if (n_live == 0) return;
  if (live) {
    const int slot = off + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
    for (int q = 0; q < 8; ++q) pray[q][slot] = r[q];
    pidx[slot] = i;
    skey[slot] = (static_cast<unsigned long long>(mask) << 8) | slot;
  }
  if (t >= n_live) skey[t] = ~0ull;
  __syncthreads();
  // bitonic sort of the keys, ascending
  for (int k = 2; k <= QBLOCK; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = t ^ j;
      if (o > t) {
        const unsigned long long x = skey[t], y = skey[o];
        if ((x > y) == ((t & k) == 0)) {
          skey[t] = y;
          skey[o] = x;
        }
      }
      __syncthreads();
    }
  }
  const int slot = warp * 32 + lane;
  const bool act = slot < n_live;
  const int k_ray = act ? static_cast<int>(skey[slot] & 0xffu) : 0;
  const float oo[3] = {pray[0][k_ray], pray[1][k_ray], pray[2][k_ray]};
  const float dd[3] = {pray[3][k_ray], pray[4][k_ray], pray[5][k_ray]};
  const float tmin = pray[6][k_ray], tmax = pray[7][k_ray];
  float inv[3];
  inv_dir(dd, inv);
  float bt = INFINITY;
  int bi = 0;
  for (int c = 0; c < n_clusters; ++c) {
    const bool enter = act && enters_box(oo, dd, inv, tmin, tmax,
                                         cl_min + 3 * c, cl_max + 3 * c);
    const bool wany = __any_sync(FULL_MASK, enter);
    const int base = c * QCL;
    const int cnt = min(QCL, n_quads - base);
    if (!__syncthreads_or(wany)) continue;
    for (int j = t; j < cnt * 4; j += QBLOCK)
      srow[j] = __ldg(quads + (size_t)base * 4 + j);
    __syncthreads();
    if (wany && act) sweep_quads(srow, base, cnt, oo, dd, tmin, tmax, bt, bi);
    __syncthreads();                    // the next cluster overwrites srow
  }
  if (act) {
    best_t[pidx[k_ray]] = bt;
    best_i[pidx[k_ray]] = min(bi, n_quads - 1);
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
    quad_search_kernel<<<(n + QBLOCK - 1) / QBLOCK, QBLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rays, reinterpret_cast<const float4*>(quads), cl_min, cl_max, n,
        n_quads, n_clusters, best_t, best_i);
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
