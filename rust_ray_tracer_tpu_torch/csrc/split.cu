// The split route's kernels, on Hopper (sm_90a): what a bounce runs for a
// scene the whole-wave trace kernel cannot take (media, noise beside
// checker textures), one launch of each per bounce over the whole wave.
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
// J and H call the device functions that kernel A runs inline
// (trace_common.cuh: hit_attrs, shade, update_found, update_miss), so the
// three compute a bounce alike. The library is built with --fmad=false: its
// plain versions are torch elementwise ops, which never contract a*b+c, and
// final_scene's noise sphere and free-flight distances amplify an FMA's
// last ulp. Ties and predicates are the plain versions' exactly: strict <,
// ascending quad ids, |denom| > 0, t in [tmin, tmax], 0 <= alpha, beta <= 1.

#include "trace_common.cuh"

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
