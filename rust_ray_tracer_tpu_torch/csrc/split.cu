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
// thread per ray, every plane read and written coalesced. Out of L2, J
// runs at about the time a torch copy of the same bytes takes; J''s ring
// of staged tiles, and a tile's rays sorted by winner kind, measured no
// faster for J, so it keeps one block a tile. H keeps the light
// table in shared memory and issues its loads in two rounds ahead of its
// branches, as H' does: a found lane's shading inputs and randoms depend
// only on its flags and material kind, so they go out in the second round,
// not after the branches.
//
// F and F' move what J, H, J' and H' move: F reads 13 planes of a dead
// lane and ~40 of a found one and writes 13; F' reads 13 to ~50 and writes
// every input plane's cotangent. One thread per ray, the planes read and
// written coalesced; F' recomputes F's forward from the saved planes. G
// and G' move F's and F''s bytes on a live tile; on a dead one G reads 13
// planes and writes 13, G' reads 12 and writes every input plane's, so a
// dead tile costs a copy, not the shading. F runs at ~3x its bytes,
// bound by latency: a found lane's loads depend on its alive flag and
// kind, and its checker leaf on the hit point. F issues them in two rounds
// ahead of its branches (both checker leaves in the second), the carried
// state (o, d, L, beta) by cp.async into shared memory, so that it holds
// 56 registers without spill and a wave's 1,152 blocks are resident at
// once (9 an SM); on a bounce where every lane shades, the state's trip
// through shared memory costs about what the ninth block gains.
//
// F''s and H''s light-table cotangent: each ray's share lives in dynamic
// shared memory laid out [entry][ray] (ray t in column t, entries ROW
// apart: the adjoints' template stride, so the adds are the ray's own, in
// its order), kernel B's layout. A thread zeroes only the (n_lights + 1) *
// LT_COLS entries the scene has; the light table itself is read from
// shared memory. After one barrier warp v takes the entries k = v mod 4,
// and each is the sum of the block's four 32-ray warps, each warp by
// warp_sum's shuffle tree, then added in warp order (lt_share_partial): a
// fixed association, so the partials repeat bit for bit. A block holds
// (n_lights + 1) * 14 * 512 bytes, 14,336 at 1 light and 64,512 at 8 (the
// split kernels' cap, MAX_LT), past the default 48 KB from 6 lights,
// where the launch raises the kernel's limit (lt_share_smem). B'
// (bwd_reduce_kernel) sums the block partials in block order: no float
// atomics.
//
// J and H call the device functions that kernel A runs inline
// (trace_common.cuh: hit_attrs, shade, update_found, update_miss), so the
// three compute a bounce alike, and F calls them in turn; J', H' and F'
// call the adjoints that kernel B runs (trace_bwd_common.cuh:
// hit_attrs_vjp, shade_fwd + shade_vjp, update_found_vjp,
// update_miss_vjp), so the split route's backward and the whole-wave
// route's are one copy. J' moves 19 + 2 + 12 planes in and 19 out, but
// its arithmetic bounds it: every lane recomputes J's attributes and runs
// the adjoint, the sphere reading's on every lane, so with its inputs in
// L2 it takes about twice its bytes' time. A block walks tiles of rays
// with the next tile's planes in flight (cp.async into a ring in shared
// memory) while it computes the current one, so its 90 registers need no
// second round of blocks for a wave. Sorting a tile's rays by winner kind
// cost more (barriers, the exchange) than the divergence it saved. H'
// is bound by memory: by lane class, a dead lane reads 13 planes and a
// found one ~47, and every lane writes 40. One thread per ray recomputes
// its forward (J's attributes, H's shading) from the saved inputs instead
// of reading residuals. What holds
// H' past its bytes is latency: a lane's state and randoms depend on its
// alive and hit flags and its material kind. H' issues its loads in two
// rounds ahead of its branches, the second the state and the randoms its
// class reads (load_randoms: one material's, at most 6 registers), and
// keeps its light-table share in shared memory as F' does, so it has no
// stack.
//
// The library is built with --fmad=false: its plain versions are torch
// elementwise ops, which never contract a*b+c, and final_scene's noise
// sphere and free-flight distances amplify an FMA's last ulp. Ties and predicates are the plain versions' exactly: strict <,
// ascending quad ids, |denom| > 0, t in [tmin, tmax], 0 <= alpha, beta <= 1.

#include <cuda_pipeline.h>

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
// the background. out [13, n] = o' d' L' beta' alive'. A lane issues its
// loads in two rounds ahead of its branches and of the block's barrier,
// as H' does: its flags, material kind and the state it carries (o, d, L,
// beta), then, if it found something, p, n, albedo, its fuzz (metal) or
// ior (dielectric) and its material's randoms (load_randoms).
__global__ void __launch_bounds__(ROW)
shade_update_kernel(const float* __restrict__ P,
                    const int* __restrict__ mkind,
                    const float* __restrict__ lt, int n_lights,
                    float* __restrict__ out, int n) {
  __shared__ float slt[MAX_LT];
  const int i = blockIdx.x * ROW + threadIdx.x;
  auto at = [&](int c) { return P[(size_t)c * n + i]; };
  // first round: the lane's class and its state
  float f_alive = 0.f, f_hit = 0.f;
  int mk = 0;
  V3 o = {0.f, 0.f, 0.f}, d = o, L = o, beta = o;
  if (i < n) {
    f_alive = at(38);
    f_hit = at(39);
    mk = mkind[i];
    o = {at(0), at(1), at(2)};
    d = {at(3), at(4), at(5)};
    L = {at(17), at(18), at(19)};
    beta = {at(20), at(21), at(22)};
  }
  const bool live = f_alive > 0.5f, found = live && f_hit > 0.5f;
  // second round: what a found lane shades with
  V3 p = {0.f, 0.f, 0.f}, nrm = p, alb = p;
  float fuzz = 0.f, ior = 0.f;
  float rv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (found) {
    p = {at(6), at(7), at(8)};
    nrm = {at(9), at(10), at(11)};
    alb = {at(12), at(13), at(14)};
    if (mk == MAT_METAL) fuzz = at(15);
    if (mk == MAT_DIELECTRIC) ior = at(16);
    load_randoms<false>(P + (size_t)23 * n + i, (size_t)n, mk, n_lights,
                        rv);
  }
  for (int k = threadIdx.x; k < (n_lights + 1) * LT_COLS; k += ROW)
    slt[k] = lt[k];
  __syncthreads();
  if (i >= n) return;
  float alive = 0.f;
  if (found) {
    float rr[15];
    expand_randoms(rv, rr);
    const Scatter sc = shade(mk, d, nrm, p, alb, fuzz, ior, slt, n_lights,
                             rr, 1);
    update_found(sc, p, o, d, L, beta, alive);
  } else if (live) {
    update_miss(slt + n_lights * LT_COLS, L, beta, alive);
  }
  const float y[N_SU_OUT] = {o.x, o.y, o.z, d.x, d.y, d.z, L.x, L.y, L.z,
                             beta.x, beta.y, beta.z, alive};
#pragma unroll
  for (int c = 0; c < N_SU_OUT; ++c) out[(size_t)c * n + i] = y[c];
}

// ---- the backward kernels ------------------------------------------------

// J' walks tiles of ROW consecutive rays: the grid holds at most
// HIT_BWD_BLOCKS blocks an SM (hit_bwd_grid: fewer where the runtime's
// occupancy calculator allows fewer) and block b walks tiles b, b + grid,
// ... Each thread copies its own ray's column of the tile's input planes
// (P's 19, g's 12), kind and flip into a ring of HIT_BWD_STAGES stages in
// shared memory, 4 bytes a cp.async, one commit group a tile, so the next
// tile's copies are in flight while it computes its ray of the current
// tile from shared memory and stores the 19 cotangents, coalesced, from
// registers. A thread reads only what it copied itself, so its own
// cp.async.wait_group orders the ring: no barrier, and any n (plane c
// starts at c * n * 4 bytes, so a 16-byte copy would need n % 4 == 0; a
// last tile's rays past n copy nothing and commit an empty group).
constexpr int N_HIT_BWD_IN = N_HIT_IN + N_HIT_OUT;   // P's planes, g's
constexpr int HIT_BWD_STAGES = 2, HIT_BWD_BLOCKS = 4;
constexpr int HIT_BWD_STAGE = (N_HIT_BWD_IN + 2) * ROW;   // floats a stage
static_assert(HIT_BWD_STAGES * HIT_BWD_STAGE * sizeof(float) <= 48 * 1024,
              "J''s ring is static shared memory");

// Thread t's copies of ray i's column into the stage st [33][ROW]: P's
// planes, g's, then kind and flip as their bits; one commit group, empty
// where i >= n.
__device__ __forceinline__ void hit_bwd_stage(float* st,
                                              const float* __restrict__ P,
                                              const float* __restrict__ g,
                                              const int* __restrict__ kind,
                                              const int* __restrict__ flip,
                                              int n, long long i, int t) {
  if (i < n) {
#pragma unroll
    for (int c = 0; c < N_HIT_BWD_IN; ++c)
      __pipeline_memcpy_async(st + c * ROW + t,
                              c < N_HIT_IN ? P + (size_t)c * n + i
                                           : g + (size_t)(c - N_HIT_IN) * n
                                                 + i,
                              sizeof(float));
    __pipeline_memcpy_async(st + N_HIT_BWD_IN * ROW + t, kind + i,
                            sizeof(int));
    __pipeline_memcpy_async(st + (N_HIT_BWD_IN + 1) * ROW + t, flip + i,
                            sizeof(int));
  }
  __pipeline_commit();
}

// J': P, kind, flip as J's; g [12, n] the cotangents of J's outputs. dP
// [19, n]: those of o, d, time, (tmin, tmax: none), the pack and tmed.
__global__ void __launch_bounds__(ROW, HIT_BWD_BLOCKS)
hit_attrs_bwd_kernel(const float* __restrict__ P, const int* __restrict__ kind,
                     const int* __restrict__ flip, const float* __restrict__ g,
                     float* __restrict__ dP, int n) {
  __shared__ float ring[HIT_BWD_STAGES][HIT_BWD_STAGE];
  const int t = threadIdx.x;
  const int tiles = (n + ROW - 1) / ROW;
  long long next = blockIdx.x;          // the next tile to copy
#pragma unroll
  for (int s = 0; s + 1 < HIT_BWD_STAGES; ++s, next += gridDim.x)
    hit_bwd_stage(ring[s], P, g, kind, flip, n, next * ROW + t, t);
  int s = 0;
  for (int tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, next += gridDim.x) {
    hit_bwd_stage(ring[(s + HIT_BWD_STAGES - 1) % HIT_BWD_STAGES], P, g, kind,
                  flip, n, next * ROW + t, t);
    __pipeline_wait_prior(HIT_BWD_STAGES - 1);   // this tile's copies
    const float* st = ring[s];
    s = (s + 1) % HIT_BWD_STAGES;
    const int i = tile * ROW + t;
    if (i >= n) continue;
    float x[N_HIT_IN];
#pragma unroll
    for (int c = 0; c < N_HIT_IN; ++c) x[c] = st[c * ROW + t];
    float gc[N_HIT_OUT];
#pragma unroll
    for (int c = 0; c < N_HIT_OUT; ++c) gc[c] = st[(N_HIT_IN + c) * ROW + t];
    const int* sk = reinterpret_cast<const int*>(st + N_HIT_BWD_IN * ROW);
    const V3 o = {x[0], x[1], x[2]}, d = {x[3], x[4], x[5]};
    const float time = x[6], tmin = x[7], tmax = x[8];
    const float* pk = x + 9;
    const int kd = sk[t];
    // the forward without the FlipFace fold: the raw t (0 on a miss), the
    // hit point, and the normal's y whose sign picks the branch of -|ny|
    const HitAttrs h = hit_attrs(kd, o, d, time, tmin, tmax, pk, x[18],
                                 false);
    const float tr = kd == KIND_NONE ? 0.f : h.t;
    V3 g_o = {0.f, 0.f, 0.f}, g_d = {0.f, 0.f, 0.f};
    float g_time = 0.f, g_tmed = 0.f;
    float g_pk[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    hit_attrs_vjp<true>(kd, o, d, time, tmin, tmax, pk, sk[ROW + t] > 0,
                        h.n.y, tr, h.p, {gc[0], {gc[1], gc[2], gc[3]},
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
}

// Sum of v over a warp (a fixed tree: the same bits in every run).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// A block's light-table partial from its rays' shares ``sdl`` [ltn][ROW]
// (after a barrier), into row blockIdx.x of dlt_part: warp v takes the
// entries k = v mod 4; each is the sum of its four 32-ray warps' warp_sum
// trees, added in warp order (F', G' and H').
__device__ __forceinline__ void lt_share_partial(const float* sdl, int ltn,
                                                 float* __restrict__ dlt_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < ltn; k += ROW / 32) {
    const float* x = sdl + k * ROW;
    float v[ROW / 32];
#pragma unroll
    for (int w = 0; w < ROW / 32; ++w) v[w] = warp_sum(x[w * 32 + lane]);
    if (lane == 0) {
      float acc = v[0];
#pragma unroll
      for (int w = 1; w < ROW / 32; ++w) acc += v[w];
      dlt_part[(size_t)blockIdx.x * ltn + k] = acc;
    }
  }
}

// H': P, mkind, lt as H's; g [13, n] the cotangents of H's outputs. dP
// [40, n]: those of o, d, p, n, albedo, fuzz, ior, L and beta (the randoms,
// alive and hit take none). A lane issues its loads in two rounds ahead of
// its branches: its flags, material kind and cotangents, then what its
// class reads (beta for a live lane; d, p, n, albedo, fuzz, ior and its
// material's randoms for a found one). The light table's cotangent,
// through the mixture pdf of Lambertian hits and the background of live
// misses, leaves as one partial a block in dlt_part [gridDim.x, ltn],
// kernel B's layout, each ray's share kept in the dynamic shared memory
// ``sdl`` [ltn][ROW] (the header's design) and summed by lt_share_partial,
// and bwd_reduce_kernel sums the partials in block order. No float
// atomics: the same bits in every run.
__global__ void __launch_bounds__(ROW)
shade_update_bwd_kernel(const float* __restrict__ P,
                        const int* __restrict__ mkind,
                        const float* __restrict__ lt, int n_lights,
                        const float* __restrict__ g, float* __restrict__ dP,
                        float* __restrict__ dlt_part, int n) {
  extern __shared__ float sdl[];           // the rays' shares [ltn][ROW]
  __shared__ float slt[MAX_LT];
  const int ltn = (n_lights + 1) * LT_COLS;
  const int i = blockIdx.x * ROW + threadIdx.x;
  auto at = [&](int c) { return P[(size_t)c * n + i]; };
  // first round: the lane's class and its cotangents
  float f_alive = 0.f, f_hit = 0.f;
  int mk = 0;
  float gc[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) gc[c] = 0.f;
  if (i < n) {
    f_alive = at(38);
    f_hit = at(39);
    mk = mkind[i];
#pragma unroll
    for (int c = 0; c < 12; ++c) gc[c] = g[(size_t)c * n + i];
  }
  const bool live = f_alive > 0.5f, found = live && f_hit > 0.5f;
  // second round: what the lane's class reads
  V3 beta = {0.f, 0.f, 0.f}, d = beta, p = beta, nrm = beta, alb = beta;
  float fuzz = 0.f, ior = 0.f;
  float rv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) beta = {at(20), at(21), at(22)};
  if (found) {
    d = {at(3), at(4), at(5)};
    p = {at(6), at(7), at(8)};
    nrm = {at(9), at(10), at(11)};
    alb = {at(12), at(13), at(14)};
    fuzz = at(15);
    ior = at(16);
    load_randoms<true>(P + (size_t)23 * n + i, (size_t)n, mk, n_lights, rv);
  }
  for (int k = threadIdx.x; k < ltn; k += ROW) slt[k] = lt[k];
  float* dl = sdl + threadIdx.x;           // this ray's share, ROW apart
  for (int k = 0; k < ltn; ++k) dl[k * ROW] = 0.f;
  __syncthreads();
  if (i < n) {
    const V3 go = {gc[0], gc[1], gc[2]}, gd = {gc[3], gc[4], gc[5]};
    const V3 gL = {gc[6], gc[7], gc[8]}, gb = {gc[9], gc[10], gc[11]};
    V3 g_o = go, g_d = gd, g_beta = gb;    // a dead lane passes through
    V3 g_p = {0.f, 0.f, 0.f}, g_n = g_p, g_a = g_p;
    float g_fuzz = 0.f, g_ior = 0.f;
    if (found) {
      float rr[15];
      expand_randoms(rv, rr);
      const ShadeFwd sf = shade_fwd(mk, d, nrm, p, alb, fuzz, slt, n_lights,
                                    rr, 1);
      const UpdateVjp u = update_found_vjp(beta, sf.em, sf.wt, sf.alive, go,
                                           gd, gL, gb);
      g_beta = u.g_beta;
      g_o = u.g_o;
      g_d = u.g_d;
      g_p = u.g_p;
      shade_vjp<ROW>(sf, mk, d, nrm, p, alb, ior, slt, n_lights, rr, 1,
                     u.g_em, u.g_wt, u.g_sd, g_d, g_p, g_n, g_a, g_fuzz,
                     g_ior, dl);
    } else if (live) {
      g_beta = update_miss_vjp<ROW>(slt + n_lights * LT_COLS, beta, gL, gb,
                                    dl + n_lights * LT_COLS * ROW);
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
  __syncthreads();                         // then the block's partial
  lt_share_partial(sdl, ltn, dlt_part);
}

// ---- F and F': the fused bounce of solid and checker scenes ------------
// ---- G and G': F and F' that skip a 1024-lane tile with no live ray ----

constexpr int N_IN_B = 46, N_CHK = 6;
constexpr int TILE_ROWS = 8;       // blocks a liveness flag covers
constexpr int BP_MIN_BLOCKS = 9;   // F's resident blocks an SM, at least

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
// update (H's shade, update_found, update_miss), one thread per ray. A
// lane's loads go out in two rounds ahead of its branches: the state it
// carries (o, d, L, beta) copied into shared memory by cp.async, which
// holds no register, beside its alive flag, kinds and flags; then, if it
// found something, the window, the pack, tmed, fuzz, ior, its albedo leaf
// (both leaves on a checker lane) and its material's randoms. The state
// is read back where the hit attributes, the shading and the update use
// it, so the kernel fits BP_MIN_BLOCKS blocks an SM. G: the same with
// tlive (tile_dead).
__global__ void __launch_bounds__(ROW, BP_MIN_BLOCKS)
bounce_planes_kernel(const float* __restrict__ P,
                     const int* __restrict__ pkind,
                     const int* __restrict__ mkind,
                     const int* __restrict__ flags,
                     const int* __restrict__ tlive,
                     const float* __restrict__ lt, int n_lights,
                     int has_checker, float* __restrict__ out, int n) {
  const int t = threadIdx.x, i = blockIdx.x * ROW + t;
  if (tile_dead(tlive)) {               // G's all-dead tile
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
  __shared__ float sst[12][ROW];        // the lanes' o, d, L, beta
  auto at = [&](int c) { return P[(size_t)c * n + i]; };
  auto st = [&](int c) {                // a V3 of the state from row c
    return V3{sst[c][t], sst[c + 1][t], sst[c + 2][t]};
  };
  // first round: the state into shared memory, the lane's class
  float f_alive = 0.f;
  int kd = KIND_NONE, mk = 0, fl = 0;
  if (i < n) {
#pragma unroll
    for (int c = 0; c < 12; ++c)        // planes 0-5 and 24-29
      __pipeline_memcpy_async(&sst[c][t], P + (size_t)(c < 6 ? c : c + 18) *
                                              n + i, sizeof(float));
    __pipeline_commit();
    f_alive = at(45);
    kd = pkind[i];
    mk = mkind[i];
    fl = flags[i];
  }
  const bool live = f_alive > 0.5f, found = live && kd != KIND_NONE;
  const bool chk = has_checker && (fl & 2);
  // second round: what a found lane reads
  float time = 0.f, tmin = 0.f, tmax = 0.f, tmed = 0.f, fuzz = 0.f;
  float ior = 0.f;
  float pk[9];
  V3 alb = {0.f, 0.f, 0.f}, alb_odd = alb;
  float rv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 9; ++c) pk[c] = 0.f;
  if (found) {
    time = at(6);
    tmin = at(7);
    tmax = at(8);
#pragma unroll
    for (int c = 0; c < 9; ++c) pk[c] = at(9 + c);
    tmed = at(18);
    fuzz = at(22);
    ior = at(23);
    if (!chk) {
      alb = {at(19), at(20), at(21)};
    } else {
      alb = {at(N_IN_B), at(N_IN_B + 1), at(N_IN_B + 2)};
      alb_odd = {at(N_IN_B + 3), at(N_IN_B + 4), at(N_IN_B + 5)};
    }
    load_randoms<false>(P + (size_t)30 * n + i, (size_t)n, mk, n_lights,
                        rv);
  }
  for (int k = t; k < (n_lights + 1) * LT_COLS; k += ROW) slt[k] = lt[k];
  __syncthreads();
  if (i >= n) return;
  __pipeline_wait_prior(0);             // the lane's own state has landed
  float alive = 0.f;
  V3 o, d, L, beta;
  if (found) {
    const HitAttrs h = hit_attrs(kd, st(0), st(3), time, tmin, tmax, pk,
                                 tmed, (fl & 1) != 0);
    if (chk) {
      // checker (texture.rs:50-57): the sin-product sign picks the leaf
      const float sines = sinf(10.f * h.p.x) * sinf(10.f * h.p.y) *
                          sinf(10.f * h.p.z);
      if (sines < 0.f) alb = alb_odd;
    }
    float rr[15];
    expand_randoms(rv, rr);
    const Scatter sc = shade(mk, st(3), h.n, h.p, alb, fuzz, ior, slt,
                             n_lights, rr, 1);
    asm volatile("" ::: "memory");      // the state read anew, not kept
    o = st(0);
    d = st(3);
    L = st(6);
    beta = st(9);
    update_found(sc, h.p, o, d, L, beta, alive);
  } else {
    o = st(0);
    d = st(3);
    L = st(6);
    beta = st(9);
    if (live) update_miss(slt + n_lights * LT_COLS, L, beta, alive);
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
// layout, each ray's share kept in the dynamic shared memory ``sdl``
// [(n_lights + 1) * LT_COLS][ROW] (the header's design), for
// bwd_reduce_kernel to sum in block order: no float atomics. G': the same
// with tlive (tile_dead).
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
  extern __shared__ float sdl[];           // the rays' shares [ltn][ROW]
  __shared__ float slt[MAX_LT];
  for (int k = threadIdx.x; k < ltn; k += ROW) slt[k] = lt[k];
  float* dl = sdl + threadIdx.x;           // this ray's share, ROW apart
  for (int k = 0; k < ltn; ++k) dl[k * ROW] = 0.f;
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
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
        shade_vjp<ROW>(sf, mk, d, nrm, h.p, alb, at(23), slt, n_lights, r,
                       (size_t)n, u.g_em, u.g_wt, u.g_sd, g_d, g_p, g_n,
                       g_a, g_fuzz, g_ior, dl);
        hit_attrs_vjp<true>(kd, o, d, time, tmin, tmax, pk, flip, h.n.y,
                            h.t, h.p, {0.f, g_p, g_n, 0.f, 0.f,
                                       {0.f, 0.f, 0.f}},
                            g_o, g_d, g_time, g_pk, g_tmed);
      } else {
        g_beta = update_miss_vjp<ROW>(slt + n_lights * LT_COLS, beta, gL,
                                      gb, dl + n_lights * LT_COLS * ROW);
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
  __syncthreads();                         // then the block's partial
  lt_share_partial(sdl, ltn, dlt_part);
}

int launched(int n) {
  return n > 0 ? static_cast<int>(cudaGetLastError()) : 0;
}

// Dynamic shared memory of a block of a kernel that keeps its rays'
// light-table shares [ltn][ROW] (F', G', H'). Past the default 48 KB (from
// 6 lights) the launch raises the kernel's limit first; 0 on success.
template <typename Kernel>
int lt_share_smem(Kernel* kernel, int n_lights, size_t& bytes) {
  bytes = (size_t)(n_lights + 1) * LT_COLS * ROW * sizeof(float);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

// Such a kernel's resident blocks per multiprocessor at n_lights, from the
// CUDA runtime's occupancy calculator at the launch's shared memory:
// out[0] the blocks, out[1] the dynamic shared memory a block (bytes).
template <typename Kernel>
int lt_share_occupancy(Kernel* kernel, int n_lights, int* out) {
  if ((n_lights + 1) * LT_COLS > MAX_LT) return -1;
  size_t smem;
  if (const int e = lt_share_smem(kernel, n_lights, smem)) return e;
  out[1] = (int)smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, ROW, smem));
}

// J''s launch over n > 0 rays: out[0] its resident blocks an SM by the
// runtime's occupancy calculator, out[1] its dynamic shared memory (none:
// the ring is static), out[2] the grid, a block for each tile up to
// min(out[0], HIT_BWD_BLOCKS) blocks an SM. 0 on success.
int hit_bwd_grid(int n, int* out) {
  int dev, sms;
  if (const cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (const cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return static_cast<int>(e);
  if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, hit_attrs_bwd_kernel, ROW, 0))
    return static_cast<int>(e);
  out[1] = 0;
  const int tiles = (n + ROW - 1) / ROW;
  const int blocks =
      (out[0] < HIT_BWD_BLOCKS ? out[0] : HIT_BWD_BLOCKS) * sms;
  out[2] = tiles < blocks ? tiles : blocks;
  return out[2] > 0 ? 0 : -1;
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
  if (n <= 0) return 0;
  int occ[3];
  if (const int e = hit_bwd_grid(n, occ)) return e;
  hit_attrs_bwd_kernel<<<occ[2], ROW, 0,
                         static_cast<cudaStream_t>(stream)>>>(P, kind, flip,
                                                              g, dP, n);
  return launched(n);
}

// J's and J''s launch over n > 0 rays: out[0] the resident blocks an SM
// by the runtime's occupancy calculator, out[1] the dynamic shared memory
// a block (none), out[2] the grid (J: a block a tile; J': hit_bwd_grid).
extern "C" int hit_attrs_occupancy(int n, int* out) {
  out[1] = 0;
  out[2] = (n + ROW - 1) / ROW;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, hit_attrs_kernel, ROW, 0));
}

extern "C" int hit_attrs_bwd_occupancy(int n, int* out) {
  return hit_bwd_grid(n, out);
}

// dlt_part [ceil(n / ROW), (n_lights + 1) * LT_COLS]: the blocks'
// light-table partials. With n == 0 nothing is launched.
extern "C" int shade_update_bwd_launch(const float* P, const int* mkind,
                                       const float* lt, int n_lights,
                                       const float* g, float* dP,
                                       float* dlt_part, int n, void* stream) {
  if ((n_lights + 1) * LT_COLS > MAX_LT) return -1;
  size_t smem;
  if (const int e = lt_share_smem(shade_update_bwd_kernel, n_lights, smem))
    return e;
  if (n > 0)
    shade_update_bwd_kernel<<<(n + ROW - 1) / ROW, ROW, smem,
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

// F''s (and G''s) resident blocks per multiprocessor, from the CUDA
// runtime's occupancy calculator: out[0] the blocks, out[1] 0 (no dynamic
// shared memory).
extern "C" int bounce_planes_occupancy(int* out) {
  out[1] = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, bounce_planes_kernel, ROW, 0));
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
  size_t smem;
  if (const int e = lt_share_smem(bounce_planes_bwd_kernel, n_lights, smem))
    return e;
  if (n > 0)
    bounce_planes_bwd_kernel<<<(n + ROW - 1) / ROW, ROW, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        P, pkind, mkind, flags, nullptr, lt, n_lights, has_checker, g, dP,
        dlt_part, n);
  return launched(n);
}

// F''s (and G''s) and H''s resident blocks per multiprocessor at
// n_lights (lt_share_occupancy): out[0] the blocks, out[1] the dynamic
// shared memory a block (bytes).
extern "C" int bounce_planes_bwd_occupancy(int n_lights, int* out) {
  return lt_share_occupancy(bounce_planes_bwd_kernel, n_lights, out);
}

extern "C" int shade_update_bwd_occupancy(int n_lights, int* out) {
  return lt_share_occupancy(shade_update_bwd_kernel, n_lights, out);
}

// H's resident blocks per multiprocessor (its light table is static
// shared memory): out[0] the blocks, out[1] the dynamic shared memory a
// block (0).
extern "C" int shade_update_occupancy(int* out) {
  out[1] = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, shade_update_kernel, ROW, 0));
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
  size_t smem;
  if (const int e = lt_share_smem(bounce_planes_bwd_kernel, n_lights, smem))
    return e;
  if (n > 0)
    bounce_planes_bwd_kernel<<<n / ROW, ROW, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        P, pkind, mkind, flags, tlive, lt, n_lights, has_checker, g, dP,
        dlt_part, n);
  return launched(n);
}
