// Device helpers shared by the trace kernels (trace_wave.cu,
// trace_wave_bwd.cu) and the split route's kernels (split.cu): the
// constants, the NaN-propagating max/min of jnp.maximum/minimum, and the
// per-ray forms of pallas_shade._normalize, _safe_sqrt, _onb, _ball and one
// light's sample and pdf; the phase-2 hit attributes of a winner
// (pallas_hit._hit_plane_core), its material's randoms in one round of
// loads, its shading (pallas_shade._plane_core) and
// the estimator update (pallas_bounce._bounce_plane_core), which kernel A
// runs inline and kernels J and H run on their own; and the marble texture
// of TPU kernel C with its adjoint. Every kernel takes the forward values
// from these same lines, so the backward's recomputed branches are the
// forward's, and J and H compute what A computes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace trace {

constexpr int ROW = 128;             // rays per block = one TPU ray row
constexpr int TCC = 512;             // triangles per culled sweep chunk
constexpr int A_COL = 11;            // uni column of the material attrs
constexpr int LT_COLS = 14;
constexpr float T_MIN = 1e-4f;
constexpr float TRI_DET_EPS = 1e-5f;
constexpr float EPS = 1e-12f;
constexpr float PI_F = 3.14159265358979f;
constexpr float TWO_PI_F = 6.28318530717958f;  // 2.0 * PI, rounded once
constexpr float PDF_FLOOR = 1e-5f;
constexpr int KIND_NONE = 0, KIND_TRI = 1, KIND_SPH = 2, KIND_QUAD = 3,
              KIND_MED = 4;
constexpr int MAT_LAMBERTIAN = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2,
              MAT_LIGHT = 3, MAT_ISOTROPIC = 4;
constexpr float LIGHT_SPHERE_F = 0.f, LIGHT_QUAD_F = 1.f;



struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(jmax(x, EPS)) * (x > 0.f ? 1.f : 0.f);
}
__device__ __forceinline__ float safe_div(float a, float b) {
  const float bs = fabsf(b) < EPS ? (b < 0.f ? -EPS : EPS) : b;
  return a / bs;
}
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n2 = v.x * v.x + v.y * v.y + v.z * v.z;
  float inv = 1.f / sqrtf(jmax(n2, EPS));
  inv = n2 > 0.f ? inv : 0.f;
  return {v.x * inv, v.y * inv, v.z * inv};
}

// Duff et al. branchless ONB about w (pallas_shade._onb)
__device__ __forceinline__ void onb(V3 w_in, V3& u, V3& v, V3& w) {
  w = normalize(w_in);
  const float sign = w.z >= 0.f ? 1.f : -1.f;
  const float den = sign + w.z;
  const float a = -1.f / (den + (fabsf(den) < 1e-8f ? 1e-8f : 0.f));
  const float b = w.x * w.y * a;
  u = {1.f + sign * w.x * w.x * a, sign * b, -sign * w.x};
  v = {b, sign + w.y * w.y * a, -w.y};
}

__device__ __forceinline__ V3 ball(float gx, float gy, float gz, float u) {
  const V3 d = normalize({gx, gy, gz});
  const float r = expf(logf(jmax(u, 1e-30f)) / 3.f);
  return {d.x * r, d.y * r, d.z * r};
}

__device__ __forceinline__ float dot10(const float* __restrict__ c,
                                       const float (&f)[10]) {
  float acc = c[0] * f[0];
#pragma unroll
  for (int k = 1; k < 10; ++k) acc = acc + c[k] * f[k];
  return acc;
}

// One light's sampled direction from p (pallas_shade._plane_core, the
// per-light candidate): sphere cone sample, quad uniform point, else the
// Hittable default (1, 0, 0).
__device__ V3 light_sample(const float* __restrict__ l, V3 p, float ul0,
                           float ul1) {
  const float kf = l[0];
  if (kf == LIGHT_SPHERE_F) {
    const V3 c = {l[1], l[2], l[3]};
    const float r = l[4];
    const V3 tc = {c.x - p.x, c.y - p.y, c.z - p.z};
    const float dist_sq = dot3(tc, tc);
    const float cos_max = safe_sqrt(1.f - r * r / jmax(dist_sq, EPS));
    const float zz = 1.f + ul1 * (cos_max - 1.f);
    const float ph = TWO_PI_F * ul0;
    const float ss = safe_sqrt(1.f - zz * zz);
    const float sx = cosf(ph) * ss, sy = sinf(ph) * ss;
    V3 cu, cv, cw;
    onb(tc, cu, cv, cw);
    return {sx * cu.x + sy * cv.x + zz * cw.x,
            sx * cu.y + sy * cv.y + zz * cw.y,
            sx * cu.z + sy * cv.z + zz * cw.z};
  }
  if (kf == LIGHT_QUAD_F) {
    return {l[5] + ul0 * l[8] + ul1 * l[11] - p.x,
            l[6] + ul0 * l[9] + ul1 * l[12] - p.y,
            l[7] + ul0 * l[10] + ul1 * l[13] - p.z};
  }
  return {1.f, 0.f, 0.f};
}

// One light's pdf for direction sd from p (sphere solid angle, quad area).
__device__ float light_pdf(const float* __restrict__ l, V3 p, V3 sd) {
  const float kf = l[0];
  if (kf == LIGHT_SPHERE_F) {
    const V3 c = {l[1], l[2], l[3]};
    const float r = l[4];
    const V3 oc = {p.x - c.x, p.y - c.y, p.z - c.z};
    const float aa = dot3(sd, sd);
    const float bb = dot3(oc, sd);
    const float cc = dot3(oc, oc) - r * r;
    const float disc = bb * bb - aa * cc;
    const float sq = safe_sqrt(disc);
    const float aas = jmax(aa, EPS);
    const float r1 = (-bb - sq) / aas;
    const float r2 = (-bb + sq) / aas;
    const bool hits = disc > 0.f && (r1 >= 1e-4f || r2 >= 1e-4f);
    const V3 cp = {c.x - p.x, c.y - p.y, c.z - p.z};
    const float dist_sq = dot3(cp, cp);
    const float cos_max = safe_sqrt(1.f - r * r / jmax(dist_sq, EPS));
    const float solid = TWO_PI_F * (1.f - cos_max);
    return hits ? 1.f / jmax(solid, EPS) : 0.f;
  }
  if (kf == LIGHT_QUAD_F) {
    const V3 q = {l[5], l[6], l[7]};
    const V3 lu = {l[8], l[9], l[10]};
    const V3 lv = {l[11], l[12], l[13]};
    const V3 wn = {lu.y * lv.z - lu.z * lv.y, lu.z * lv.x - lu.x * lv.z,
                   lu.x * lv.y - lu.y * lv.x};
    const float n2 = wn.x * wn.x + wn.y * wn.y + wn.z * wn.z;
    const float denom = dot3(sd, wn);
    const float dsafe = fabsf(denom) < EPS ? (denom < 0.f ? -EPS : EPS)
                                           : denom;
    const V3 qp = {q.x - p.x, q.y - p.y, q.z - p.z};
    const float tq = dot3(qp, wn) / dsafe;
    const float wx = p.x + tq * sd.x - q.x;
    const float wy = p.y + tq * sd.y - q.y;
    const float wz = p.z + tq * sd.z - q.z;
    const float inv_n2 = 1.f / jmax(n2, EPS);
    const float al = dot3({wy * lv.z - wz * lv.y, wz * lv.x - wx * lv.z,
                           wx * lv.y - wy * lv.x}, wn) * inv_n2;
    const float be = dot3({lu.y * wz - lu.z * wy, lu.z * wx - lu.x * wz,
                           lu.x * wy - lu.y * wx}, wn) * inv_n2;
    const bool hits = tq >= 1e-3f && isfinite(tq) && al >= 0.f &&
                      al <= 1.f && be >= 0.f && be <= 1.f;
    const float area = safe_sqrt(n2);
    const float dlen2 = jmax(dot3(sd, sd), EPS);
    const float distq = tq * tq * dlen2;
    const float cosq = fabsf(denom) / jmax(safe_sqrt(n2), EPS) /
                       jmax(safe_sqrt(dlen2), 1e-20f);
    return hits ? distq / jmax(cosq * area, EPS) : 0.f;
  }
  return 0.f;
}

// ---- phase-2 hit attributes (pallas_hit._hit_plane_core) ----------------
//
// Only the winner's reading of the unified 9-float pack pk is evaluated:
// (v0, e1, e2) for a triangle, (c0, c1, t0, t1, r) for a sphere, (q, u, v)
// for a quad; a medium's t is tmed. The plain version (ops/hit_core.py
// hit_plane_core) evaluates every reading and selects, with the same
// formulas.

struct HitAttrs {
  float t;     // inf on a miss
  V3 p, n;     // the hit point; the normal, FlipFace folded in
  float u, v;  // a triangle's or a quad's surface coordinates, else 0
};

// The sphere reading of the pack: the preferred root (the near one when it
// lies in [tmin, tmax]), the time-lerped centre, 1 / radius.
struct SphereView {
  float t;
  V3 cen;
  bool ok1;
  float inv_r;
};

__device__ __forceinline__ SphereView sphere_view(V3 o, V3 d, float time,
                                                  float tmin, float tmax,
                                                  const float* pk) {
  const V3 c0 = {pk[0], pk[1], pk[2]}, c1 = {pk[3], pk[4], pk[5]};
  const float st0_ = pk[6], st1_ = pk[7], sr = pk[8];
  const float frac = safe_div(time - st0_, st1_ - st0_);
  const V3 cen = {c0.x + frac * (c1.x - c0.x), c0.y + frac * (c1.y - c0.y),
                  c0.z + frac * (c1.z - c0.z)};
  const V3 oc = {o.x - cen.x, o.y - cen.y, o.z - cen.z};
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  const float bq = dot3(oc, d);
  const float cc = dot3(oc, oc) - sr * sr;
  const float disc = bq * bq - a * cc;
  const float sq = safe_sqrt(disc);
  const float root1 = safe_div(-bq - sq, a);
  const float root2 = safe_div(-bq + sq, a);
  const bool ok1 = disc > 0.f && root1 >= tmin && root1 <= tmax;
  // radius floor 1e-12: the adjoint computes -1/floor^2
  return {ok1 ? root1 : root2, cen, ok1, 1.f / jmax(sr, 1e-12f)};
}

__device__ __forceinline__ HitAttrs hit_attrs(int kind, V3 o, V3 d,
                                              float time, float tmin,
                                              float tmax, const float* pk,
                                              float tmed, bool flip) {
  float t = 0.f, u = 0.f, v = 0.f;
  V3 nrm = {1.f, 0.f, 0.f};            // a medium's (constant_medium.rs:72)
  if (kind == KIND_TRI) {
    const V3 v0 = {pk[0], pk[1], pk[2]};
    const V3 e1 = {pk[3], pk[4], pk[5]}, e2 = {pk[6], pk[7], pk[8]};
    const V3 tn = {e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
                   e1.x * e2.y - e1.y * e2.x};
    const float det = -(d.x * tn.x + d.y * tn.y + d.z * tn.z);
    const float t_num = dot3(o, tn) - dot3(v0, tn);
    const float inv_det = safe_div(1.f, det);
    t = t_num * inv_det;
    const V3 m = {o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z,
                  o.x * d.y - o.y * d.x};
    const V3 e2v0 = {e2.y * v0.z - e2.z * v0.y, e2.z * v0.x - e2.x * v0.z,
                     e2.x * v0.y - e2.y * v0.x};
    const V3 v0e1 = {v0.y * e1.z - v0.z * e1.y, v0.z * e1.x - v0.x * e1.z,
                     v0.x * e1.y - v0.y * e1.x};
    u = (dot3(m, e2) - dot3(d, e2v0)) * inv_det;
    v = (-dot3(m, e1) - dot3(d, v0e1)) * inv_det;
    const float sgn = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
    nrm = normalize(tn);
    nrm = {nrm.x * sgn, nrm.y * sgn, nrm.z * sgn};
  } else if (kind == KIND_SPH) {
    const SphereView s = sphere_view(o, d, time, tmin, tmax, pk);
    t = s.t;
    nrm = {(o.x + t * d.x - s.cen.x) * s.inv_r,
           (o.y + t * d.y - s.cen.y) * s.inv_r,
           (o.z + t * d.z - s.cen.z) * s.inv_r};
  } else if (kind == KIND_QUAD) {
    const V3 q = {pk[0], pk[1], pk[2]};
    const V3 qu = {pk[3], pk[4], pk[5]}, qv = {pk[6], pk[7], pk[8]};
    const V3 wn = {qu.y * qv.z - qu.z * qv.y, qu.z * qv.x - qu.x * qv.z,
                   qu.x * qv.y - qu.y * qv.x};
    const float denom = dot3(d, wn);
    t = safe_div(dot3({q.x - o.x, q.y - o.y, q.z - o.z}, wn), denom);
    const V3 w = {o.x + t * d.x - q.x, o.y + t * d.y - q.y,
                  o.z + t * d.z - q.z};
    const float inv_n2 = safe_div(1.f, dot3(wn, wn));
    u = dot3({w.y * qv.z - w.z * qv.y, w.z * qv.x - w.x * qv.z,
              w.x * qv.y - w.y * qv.x}, wn) * inv_n2;
    v = dot3({qu.y * w.z - qu.z * w.y, qu.z * w.x - qu.x * w.z,
              qu.x * w.y - qu.y * w.x}, wn) * inv_n2;
    nrm = normalize(wn);
    const float dsign = dot3(d, nrm) > 0.f ? -1.f : 1.f;
    nrm = {nrm.x * dsign, nrm.y * dsign, nrm.z * dsign};
  } else if (kind == KIND_MED) {
    t = tmed;
  }
  const V3 p = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  if (flip) nrm.y = -fabsf(nrm.y);   // geometry/mod.rs:226-230
  return {kind == KIND_NONE ? INFINITY : t, p, nrm, u, v};
}

// ---- shading (pallas_shade._plane_core, the lane's material) -------------

struct Scatter {
  V3 em;       // emitted radiance
  V3 wt;       // throughput weight
  V3 dr;       // the scattered direction
  bool alive;  // the path goes on
};

// A lane's material's randoms (r its first, the next rs apart), loaded
// together ahead of its shading into rv, in order: Lambertian 0, 1 and
// with lights 3-6; metal 7, 9-11; dielectric 2; isotropic 8, 12-14 (its
// adjoint reads none of them). Kernels I, F, H and H' issue these loads
// in one round once the lane's material kind is known.
template <bool ADJOINT>
__device__ __forceinline__ void load_randoms(const float* __restrict__ r,
                                             size_t rs, int mk, int n_lights,
                                             float rv[6]) {
  auto R = [&](int c) { return r[c * rs]; };
  if (mk == MAT_LAMBERTIAN) {
    rv[0] = R(0);
    rv[1] = R(1);
    if (n_lights > 0) {
      rv[2] = R(3);
      rv[3] = R(4);
      rv[4] = R(5);
      rv[5] = R(6);
    }
  } else if (mk == MAT_METAL) {
    rv[0] = R(7);
    rv[1] = R(9);
    rv[2] = R(10);
    rv[3] = R(11);
  } else if (mk == MAT_DIELECTRIC) {
    rv[0] = R(2);
  } else if (!ADJOINT && mk == MAT_ISOTROPIC) {
    rv[0] = R(8);
    rv[1] = R(12);
    rv[2] = R(13);
    rv[3] = R(14);
  }
}

// The 15 randoms as shade, shade_fwd and shade_vjp index them (stride 1)
// from load_randoms' rv: each material's branch reads only its own, so
// the materials' slots share rv's registers.
__device__ __forceinline__ void expand_randoms(const float rv[6],
                                               float rr[15]) {
  constexpr int slot[15] = {0, 1, 0, 2, 3, 4, 5, 0, 0, 1, 2, 3, 1, 2, 3};
#pragma unroll
  for (int c = 0; c < 15; ++c) rr[c] = rv[slot[c]];
}

// r points at the ray's first random, the next ones rs apart: 9 uniforms
// (u0..u4, ul0, ul1, ufr, uir), then 6 normals. lt holds n_lights light
// rows of LT_COLS. A Lambertian lane's mixture pdf adds every light's pdf
// in light order; kernel I passes LightPdfSum (csrc/shade.cu
// CandidateLights), whose sum(lt, n_lights, p, sd) adds the same terms in
// the same order but leaves out those that are exactly +0. The default
// keeps the loop here, so the other kernels compile as they did.
template <class LightPdfSum = void>
__device__ __forceinline__ Scatter shade(int mkind, V3 d, V3 nrm, V3 p,
                                         V3 alb, float fuzz, float ior,
                                         const float* __restrict__ lt,
                                         int n_lights,
                                         const float* __restrict__ r,
                                         size_t rs) {
  auto R = [&](int c) { return r[c * rs]; };
  const float d_dot_n = dot3(d, nrm);
  float emx = 0.f, emy = 0.f, emz = 0.f;
  float wtx = 0.f, wty = 0.f, wtz = 0.f;
  V3 dr = {1.f, 1.f, 1.f};
  bool alive_f = true;
  if (mkind == MAT_LAMBERTIAN) {
    V3 bu, bv, bw;
    onb(nrm, bu, bv, bw);
    const float u0 = R(0), u1 = R(1);
    const float z = safe_sqrt(1.f - u1);
    const float phi = TWO_PI_F * u0;
    const float sr = safe_sqrt(u1);
    const float lx = cosf(phi) * sr, ly = sinf(phi) * sr;
    const V3 cosd = {lx * bu.x + ly * bv.x + z * bw.x,
                     lx * bu.y + ly * bv.y + z * bw.y,
                     lx * bu.z + ly * bv.z + z * bw.z};
    V3 lam;
    float pdf;
    if (n_lights > 0) {
      const float u3 = R(3), u4 = R(4);
      const int li = min((int)(u4 * (float)n_lights), n_lights - 1);
      lam = cosd;
      if (!(u3 < 0.5f)) lam = light_sample(lt + li * LT_COLS, p, R(5), R(6));
      const V3 nd = normalize(lam);
      const float cos_pdf = jmax(dot3(nd, bw) / PI_F, 0.f);
      float pdf_sum = 0.f;
      if constexpr (std::is_void_v<LightPdfSum>) {
        for (int l = 0; l < n_lights; ++l)
          pdf_sum = pdf_sum + light_pdf(lt + l * LT_COLS, p, lam);
      } else {
        pdf_sum = LightPdfSum::sum(lt, n_lights, p, lam);
      }
      pdf = 0.5f * cos_pdf + 0.5f * pdf_sum / (float)n_lights;
    } else {
      lam = cosd;
      const V3 nd = normalize(lam);
      pdf = jmax(dot3(nd, bw) / PI_F, 0.f);
    }
    pdf = pdf > PDF_FLOOR ? pdf : PDF_FLOOR;
    const float spdf = jmax(dot3(nrm, normalize(lam)) / PI_F, 0.f);
    const float lam_w = spdf / pdf;
    wtx = alb.x * lam_w;
    wty = alb.y * lam_w;
    wtz = alb.z * lam_w;
    dr = lam;
  } else if (mkind == MAT_METAL || mkind == MAT_DIELECTRIC) {
    const V3 ud = normalize(d);
    const float dn2 = 2.f * dot3(ud, nrm);
    const V3 rf = {ud.x - dn2 * nrm.x, ud.y - dn2 * nrm.y,
                   ud.z - dn2 * nrm.z};
    if (mkind == MAT_METAL) {
      const V3 fb = ball(R(9), R(10), R(11), R(7));
      const V3 m = {rf.x + fuzz * fb.x, rf.y + fuzz * fb.y,
                    rf.z + fuzz * fb.z};
      alive_f = dot3(m, nrm) > 0.f;
      wtx = alb.x;
      wty = alb.y;
      wtz = alb.z;
      dr = m;
    } else {
      const bool exiting = d_dot_n > 0.f;
      const float ratio = exiting ? ior : 1.f / ior;
      const V3 no = exiting ? V3{-nrm.x, -nrm.y, -nrm.z} : nrm;
      const float cos_t = jmin(-dot3(ud, no), 1.f);
      const float sin_t = safe_sqrt(1.f - cos_t * cos_t);
      const bool tir = ratio * sin_t > 1.f;
      const V3 po = {ratio * (ud.x + cos_t * no.x),
                     ratio * (ud.y + cos_t * no.y),
                     ratio * (ud.z + cos_t * no.z)};
      const float kk = fabsf(1.f - (po.x * po.x + po.y * po.y +
                                    po.z * po.z));
      const float sk = safe_sqrt(kk);
      float r0 = (1.f - ior) / (1.f + ior);
      r0 = r0 * r0;
      const float one_m = 1.f - cos_t;
      const float om2 = one_m * one_m;
      const float schl = r0 + (1.f - r0) * om2 * om2 * one_m;
      const bool do_refl = tir || schl >= R(2);
      dr = do_refl ? rf
                   : V3{po.x - sk * no.x, po.y - sk * no.y,
                        po.z - sk * no.z};
      wtx = wty = wtz = 1.f;
    }
  } else if (mkind == MAT_ISOTROPIC) {
    dr = ball(R(12), R(13), R(14), R(8));
    wtx = alb.x;
    wty = alb.y;
    wtz = alb.z;
  } else if (mkind == MAT_LIGHT) {
    if (d_dot_n < 0.f) {
      emx = alb.x;
      emy = alb.y;
      emz = alb.z;
    }
    alive_f = false;
  }
  return {{emx, emy, emz}, {wtx, wty, wtz}, dr, alive_f};
}

// ---- estimator update (pallas_bounce._bounce_plane_core) -----------------

// A found ray: L += beta * emitted, beta *= weight; it moves to the hit
// point along the scattered direction, or its path ends.
__device__ __forceinline__ void update_found(const Scatter& s, V3 p, V3& o,
                                             V3& d, V3& L, V3& beta,
                                             float& alive) {
  L = {L.x + beta.x * s.em.x, L.y + beta.y * s.em.y, L.z + beta.z * s.em.z};
  beta = {beta.x * s.wt.x, beta.y * s.wt.y, beta.z * s.wt.z};
  if (s.alive) {
    o = p;
    d = s.dr;
    alive = 1.f;
  } else {
    alive = 0.f;
  }
}

// A live ray that found nothing: L += beta * background; its path ends.
__device__ __forceinline__ void update_miss(const float* __restrict__ bg,
                                            V3& L, V3 beta, float& alive) {
  L = {L.x + beta.x * bg[0], L.y + beta.y * bg[1], L.z + beta.z * bg[2]};
  alive = 0.f;
}

// ---- marble noise: TPU kernel C -----------------------------------------
//
// Replaces rust_ray_tracer_tpu/ops/pallas_bounce.py _noise_row (:125) and
// _marble_row (:166), which the TPU trace kernels A and B (and D) run at
// each hit whose winner has a Noise texture (texture.rs:74-82, turb:
// perlin.rs:58-71). Plain versions: ops/perlin.py marble, marble_vjp.
//
// Per noise hit: 7 octaves x (3 floors, 6 permutation reads, 8 corners of
// one gradient read and ~12 flops each). The TPU reads its 256-entry
// tables through one-hot [256, 128] MXU contractions, because Mosaic has
// no per-lane gather; here the tables are 3 KB of gradients and 768 bytes
// of permutations in shared memory, loaded once per block before the
// bounce loop, and every lookup is one indexed shared-memory load. The
// lookups are exact either way, so the values are the same. The adjoint
// recomputes the corners in a second pass instead of keeping 56 of them
// per ray in registers.

constexpr int PERLIN_N = 256;
constexpr int OCTAVES = 7;
// dynamic shared memory of a noise variant: gradients, then permutations
constexpr int PERLIN_SMEM = 3 * PERLIN_N * 4 + 3 * PERLIN_N;

struct Perlin {
  const float* g;              // [256 * 3] gradients (shared memory)
  const unsigned char* perm;   // [3 * 256] x, y, z permutations
};

// Every thread of the block calls this, then __syncthreads(). vec [256, 3]
// float32, perm [3, 256] int32 (ops/uber.py make_ctx: ctx.perlin).
__device__ __forceinline__ Perlin perlin_load(float* smem,
                                              const float* __restrict__ vec,
                                              const int* __restrict__ perm) {
  unsigned char* p = reinterpret_cast<unsigned char*>(smem + 3 * PERLIN_N);
  for (int k = threadIdx.x; k < 3 * PERLIN_N; k += blockDim.x) {
    smem[k] = vec[k];
    p[k] = static_cast<unsigned char>(perm[k]);
  }
  return {smem, p};
}

// One axis of a cell: the offset u in it, its Hermite weight s
// (perlin.rs:87-89) and the permutation entries of its two corners. The
// index wraps on two's complement, as JAX's bitwise_and of an int32.
__device__ __forceinline__ void perlin_axis(const unsigned char* perm,
                                            float x, float& u, float& s,
                                            int& h0, int& h1) {
  const float f = floorf(x);
  u = x - f;
  const int i = static_cast<int>(f);
  s = u * u * (3.f - 2.f * u);
  h0 = perm[i & (PERLIN_N - 1)];
  h1 = perm[(i + 1) & (PERLIN_N - 1)];
}

// One octave of gradient noise (_noise_row), corners in its (di, dj, dk)
// order.
__device__ __forceinline__ float noise_row(const Perlin& P, float x, float y,
                                           float z) {
  float ux, sx, uy, sy, uz, sz;
  int hx[2], hy[2], hz[2];
  perlin_axis(P.perm, x, ux, sx, hx[0], hx[1]);
  perlin_axis(P.perm + PERLIN_N, y, uy, sy, hy[0], hy[1]);
  perlin_axis(P.perm + 2 * PERLIN_N, z, uz, sz, hz[0], hz[1]);
  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const float wi = di ? sx : 1.f - sx;
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const float wj = dj ? sy : 1.f - sy;
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float wk = dk ? sz : 1.f - sz;
        const float* g = P.g + 3 * (hx[di] ^ hy[dj] ^ hz[dk]);
        const float dot = g[0] * (ux - (float)di) + g[1] * (uy - (float)dj) +
                          g[2] * (uz - (float)dk);
        acc = acc + (wi * wj * wk) * dot;
      }
    }
  }
  return acc;
}

// The signed octave sum of _marble_row (before its abs).
__device__ __forceinline__ float turb_acc(const Perlin& P, V3 p) {
  float acc = 0.f, w = 1.f, s = 1.f;
#pragma unroll 1
  for (int o = 0; o < OCTAVES; ++o) {
    acc = acc + w * noise_row(P, p.x * s, p.y * s, p.z * s);
    w *= 0.5f;
    s *= 2.f;
  }
  return acc;
}

// 0.5 * (1 + sin(scale * z + 10 * turb(p))): the albedo, all channels.
__device__ __forceinline__ float marble(const Perlin& P, V3 p, float scale) {
  return 0.5f * (1.f + sinf(scale * p.z + 10.f * fabsf(turb_acc(P, p))));
}

struct MarbleGrad {
  V3 p;          // d/dp
  float scale;   // d/dscale
};

// Adjoint of marble for the cotangent g of its value. A first pass gives acc (its sign, and cos(arg)); a
// second re-evaluates each octave's corners and differentiates the
// Hermite weights (s' = 6u(1-u)) and the (u - d) terms of the dots. floor
// has no derivative and abs'(0) = +1, as jax.vjp takes them.
__device__ __forceinline__ MarbleGrad marble_vjp(const Perlin& P, V3 p,
                                                float scale, float g) {
  const float acc = turb_acc(P, p);
  const float arg = scale * p.z + 10.f * fabsf(acc);
  const float g_arg = g * (0.5f * cosf(arg));
  const float g_acc = g_arg * 10.f * (acc >= 0.f ? 1.f : -1.f);
  float dx = 0.f, dy = 0.f, dz = 0.f, w = 1.f, s = 1.f;
#pragma unroll 1
  for (int o = 0; o < OCTAVES; ++o) {
    float ux, sx, uy, sy, uz, sz;
    int hx[2], hy[2], hz[2];
    perlin_axis(P.perm, p.x * s, ux, sx, hx[0], hx[1]);
    perlin_axis(P.perm + PERLIN_N, p.y * s, uy, sy, hy[0], hy[1]);
    perlin_axis(P.perm + 2 * PERLIN_N, p.z * s, uz, sz, hz[0], hz[1]);
    const float dsx = 6.f * ux * (1.f - ux);
    const float dsy = 6.f * uy * (1.f - uy);
    const float dsz = 6.f * uz * (1.f - uz);
    float nx = 0.f, ny = 0.f, nz = 0.f;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      const float wi = di ? sx : 1.f - sx;
      const float si = di ? 1.f : -1.f;
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const float wj = dj ? sy : 1.f - sy;
        const float sj = dj ? 1.f : -1.f;
#pragma unroll
        for (int dk = 0; dk < 2; ++dk) {
          const float wk = dk ? sz : 1.f - sz;
          const float sk = dk ? 1.f : -1.f;
          const float* gr = P.g + 3 * (hx[di] ^ hy[dj] ^ hz[dk]);
          const float dot = gr[0] * (ux - (float)di) +
                            gr[1] * (uy - (float)dj) +
                            gr[2] * (uz - (float)dk);
          const float wijk = wi * wj * wk;
          nx = nx + si * dsx * (wj * wk) * dot + wijk * gr[0];
          ny = ny + sj * dsy * (wi * wk) * dot + wijk * gr[1];
          nz = nz + sk * dsz * (wi * wj) * dot + wijk * gr[2];
        }
      }
    }
    // d noise(p * s) / dp = s * d noise / dx, weighted by the octave's w
    dx = dx + (w * s) * nx;
    dy = dy + (w * s) * ny;
    dz = dz + (w * s) * nz;
    w *= 0.5f;
    s *= 2.f;
  }
  return {{g_acc * dx, g_acc * dy, g_acc * dz + g_arg * scale},
          g_arg * p.z};
}

}  // namespace trace
