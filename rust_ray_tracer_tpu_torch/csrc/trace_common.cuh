// Device helpers shared by the forward and backward trace kernels
// (trace_wave.cu, trace_wave_bwd.cu): the constants, the NaN-propagating
// max/min of jnp.maximum/minimum, and the per-ray forms of
// pallas_shade._normalize, _safe_sqrt, _onb, _ball and one light's sample
// and pdf. Both kernels take the forward values from these same lines, so
// the backward's recomputed branches are the forward's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

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
constexpr int KIND_NONE = 0, KIND_TRI = 1, KIND_SPH = 2, KIND_QUAD = 3;
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

}  // namespace trace
