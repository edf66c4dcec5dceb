// Adjoint device code shared by the backward kernels: kernel B
// (trace_wave_bwd.cu, the whole-wave adjoint) and kernels J' and H'
// (split.cu, the split route's hit-attribute and shade+update adjoints).
// Each function is the per-ray transliteration of one of the plain
// adjoints in ops/: update_found_vjp / update_miss_vjp of the estimator
// update (ops/bounce_core.py update_vjp), shade_fwd + shade_vjp of the
// shading (ops/shade_core.py plane_core_vjp, the ray's material only) and
// hit_attrs_vjp of the hit attributes (ops/hit_core.py hit_plane_core_vjp,
// the winner's kind only; in its SPLIT form also the cotangents of u, v,
// t and the sphere-UV source, which kernel B's path never produces). The
// marble's adjoint is marble_vjp in trace_common.cuh.
//
// The kinks follow jax.vjp: max/min split the cotangent evenly on a tie,
// a where() sends nothing to the untaken branch, abs'(0) = 1, the clamped
// divisor of safe_div and the floor of the pdf take none. The sampled
// directions are constants (JAX detaches them). Every library that
// includes this header is built with --fmad=false, so the adjoints round
// as their plain versions do.

#pragma once

#include "trace_common.cuh"

namespace trace {

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scl(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// cotangent reaching x through m = max(x, c) (or min): JAX's balanced rule
__device__ __forceinline__ float pick_bwd(float x, float m, float c,
                                          float g) {
  return x == m ? (m == c ? 0.5f * g : g) : 0.f;
}
__device__ __forceinline__ float safe_sqrt_bwd(float x, float g) {
  const float m = jmax(x, EPS);
  const float gm = (x > 0.f ? g : 0.f) * (0.5f / sqrtf(m));
  return pick_bwd(x, m, EPS, gm);
}
__device__ __forceinline__ float safe_div_den_bwd(float a, float b,
                                                  float g) {
  const float bs = fabsf(b) < EPS ? (b < 0.f ? -EPS : EPS) : b;
  return fabsf(b) < EPS ? 0.f : -g * a / (bs * bs);
}
__device__ __forceinline__ float safe_div_num_bwd(float b, float g) {
  const float bs = fabsf(b) < EPS ? (b < 0.f ? -EPS : EPS) : b;
  return g / bs;
}
__device__ __forceinline__ V3 normalize_bwd(V3 v, V3 g) {
  const float n2 = v.x * v.x + v.y * v.y + v.z * v.z;
  const float m = jmax(n2, EPS);
  const float r = 1.f / sqrtf(m);
  const bool live = n2 > 0.f;
  const float inv = live ? r : 0.f;
  const float gr = live ? g.x * v.x + g.y * v.y + g.z * v.z : 0.f;
  const float gn2 = pick_bwd(n2, m, EPS, gr * (-0.5f * (r / m)));
  return {g.x * inv + 2.f * v.x * gn2, g.y * inv + 2.f * v.y * gn2,
          g.z * inv + 2.f * v.z * gn2};
}
// c = a x b: (da, db) = (b x g, g x a)
__device__ __forceinline__ void cross_bwd(V3 a, V3 b, V3 g, V3& ga,
                                          V3& gb) {
  ga = add(ga, cross(b, g));
  gb = add(gb, cross(g, a));
}

// One sphere light's pdf adjoint: cotangents of its centre and radius
// (added into dl[1..4], entries S apart) and of p.
template <int S = 1>
__device__ void sphere_pdf_bwd(const float* __restrict__ l, V3 p, V3 sd,
                               float g, float* dl, V3& gp) {
  const V3 c = {l[1], l[2], l[3]};
  const float r = l[4];
  const V3 oc = sub(p, c);
  const float aa = dot3(sd, sd);
  const float bb = dot3(oc, sd);
  const float cc = dot3(oc, oc) - r * r;
  const float disc = bb * bb - aa * cc;
  const float sq = safe_sqrt(disc);
  const float aas = jmax(aa, EPS);
  const float r1 = (-bb - sq) / aas;
  const float r2 = (-bb + sq) / aas;
  const bool hits = disc > 0.f && (r1 >= 1e-4f || r2 >= 1e-4f);
  if (!hits) return;
  const V3 tc = sub(c, p);
  const float dist_sq = dot3(tc, tc);
  const float m_d = jmax(dist_sq, EPS);
  const float rr = r * r;
  const float x = 1.f - rr / m_d;
  const float cos_max = safe_sqrt(x);
  const float solid = TWO_PI_F * (1.f - cos_max);
  const float m_s = jmax(solid, EPS);
  const float g_solid = pick_bwd(solid, m_s, EPS, -g / (m_s * m_s));
  const float g_q = -safe_sqrt_bwd(x, -(g_solid * TWO_PI_F));
  const float g_rr = g_q / m_d;
  const float g_dsq = pick_bwd(dist_sq, m_d, EPS, -g_q * rr / (m_d * m_d));
  const V3 g_tc = scl(2.f * g_dsq, tc);
  dl[1 * S] += g_tc.x;
  dl[2 * S] += g_tc.y;
  dl[3 * S] += g_tc.z;
  dl[4 * S] += 2.f * r * g_rr;
  gp = sub(gp, g_tc);
}

// One quad light's pdf adjoint: cotangents of q, u, v (dl[5..13], entries
// S apart) and p.
template <int S = 1>
__device__ void quad_pdf_bwd(const float* __restrict__ l, V3 p, V3 sd,
                             float g, float* dl, V3& gp) {
  const V3 q = {l[5], l[6], l[7]};
  const V3 lu = {l[8], l[9], l[10]};
  const V3 lv = {l[11], l[12], l[13]};
  const V3 wn = cross(lu, lv);
  const float n2 = wn.x * wn.x + wn.y * wn.y + wn.z * wn.z;
  const float denom = dot3(sd, wn);
  const float dsafe = fabsf(denom) < EPS ? (denom < 0.f ? -EPS : EPS)
                                         : denom;
  const V3 qp = sub(q, p);
  const float num = dot3(qp, wn);
  const float tq = num / dsafe;
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
  if (!hits) return;
  const float area = safe_sqrt(n2);
  const float dlen2 = jmax(dot3(sd, sd), EPS);
  const float distq = tq * tq * dlen2;
  const float s1 = safe_sqrt(n2);
  const float m1 = jmax(s1, EPS);
  const float m2 = jmax(safe_sqrt(dlen2), 1e-20f);
  const float absd = fabsf(denom);
  const float cosq = absd / m1 / m2;
  const float ca = cosq * area;
  const float m_c = jmax(ca, EPS);
  const float g_distq = g / m_c;
  const float g_ca = pick_bwd(ca, m_c, EPS, -g * distq / (m_c * m_c));
  const float g_cosq = g_ca * area;
  const float g_area = g_ca * cosq;
  const float g_t1 = g_cosq / m2;
  const float g_abs = g_t1 / m1;
  const float g_s1 = pick_bwd(s1, m1, EPS, -g_t1 * absd / (m1 * m1));
  const float g_n2 = safe_sqrt_bwd(n2, g_s1) + safe_sqrt_bwd(n2, g_area);
  float g_den = denom >= 0.f ? g_abs : -g_abs;
  const float g_tq = 2.f * (g_distq * dlen2) * tq;
  const float g_num = g_tq / dsafe;
  if (!(fabsf(denom) < EPS)) g_den += -g_tq * num / (dsafe * dsafe);
  const V3 g_wn = add(add(scl(g_num, qp), scl(g_den, sd)),
                      scl(2.f * g_n2, wn));
  V3 g_lu = {0.f, 0.f, 0.f}, g_lv = {0.f, 0.f, 0.f};
  cross_bwd(lu, lv, g_wn, g_lu, g_lv);
  const V3 g_q = scl(g_num, wn);
  dl[5 * S] += g_q.x;
  dl[6 * S] += g_q.y;
  dl[7 * S] += g_q.z;
  dl[8 * S] += g_lu.x;
  dl[9 * S] += g_lu.y;
  dl[10 * S] += g_lu.z;
  dl[11 * S] += g_lv.x;
  dl[12 * S] += g_lv.y;
  dl[13 * S] += g_lv.z;
  gp = sub(gp, g_q);
}

// Reflection r = ud - 2 (ud . n) n: adds the cotangents of ud and n.
__device__ __forceinline__ void reflect_bwd(V3 ud, V3 n, V3 g_r, V3& g_ud,
                                            V3& g_n) {
  const float dn2 = 2.f * dot3(ud, n);
  const float g_dot = 2.f * -dot3(g_r, n);
  g_ud = add(g_ud, g_r);
  g_n = add(g_n, scl(-dn2, g_r));
  g_ud = add(g_ud, scl(g_dot, n));
  g_n = add(g_n, scl(g_dot, ud));
}

// ---- the shading's forward values that its adjoint reads ----------------

struct ShadeFwd {
  V3 em, wt;          // emitted radiance, throughput weight
  bool alive;         // the path goes on
  float d_dot_n;
  // Lambertian: the sampled direction, the ONB's w, the mixture pdf (raw
  // and floored), the cosine terms and the weight's ratio spdf / pdf
  V3 lam, bw;
  float pdf_raw, pdf, spdf, lam_w, cos_in, s_in;
};

// shade() (trace_common.cuh) recomputed with the intermediates its adjoint
// reads. r points at the ray's first random, the next ones rs apart; lt
// holds n_lights light rows.
__device__ __forceinline__ ShadeFwd shade_fwd(int mkind, V3 d, V3 nrm, V3 p,
                                              V3 alb, float fuzz,
                                              const float* __restrict__ lt,
                                              int n_lights,
                                              const float* __restrict__ r,
                                              size_t rs) {
  auto R = [&](int c) { return r[c * rs]; };
  const float d_dot_n = dot3(d, nrm);
  V3 em = {0.f, 0.f, 0.f}, wt = {0.f, 0.f, 0.f};
  bool alive_f = true;
  V3 lam = {0.f, 0.f, 0.f}, bw = {0.f, 0.f, 0.f};
  float pdf_raw = 0.f, pdf = 1.f, spdf = 0.f, lam_w = 0.f, cos_in = 0.f;
  float s_in = 0.f;
  if (mkind == MAT_LAMBERTIAN) {
    V3 bu, bv;
    onb(nrm, bu, bv, bw);
    const float u0 = R(0), u1 = R(1);
    const float z = safe_sqrt(1.f - u1);
    const float phi = TWO_PI_F * u0;
    const float sr = safe_sqrt(u1);
    const float lx = cosf(phi) * sr, ly = sinf(phi) * sr;
    const V3 cosd = {lx * bu.x + ly * bv.x + z * bw.x,
                     lx * bu.y + ly * bv.y + z * bw.y,
                     lx * bu.z + ly * bv.z + z * bw.z};
    if (n_lights > 0) {
      const float u3 = R(3), u4 = R(4);
      const int li = min((int)(u4 * (float)n_lights), n_lights - 1);
      lam = cosd;
      if (!(u3 < 0.5f)) lam = light_sample(lt + li * LT_COLS, p, R(5),
                                           R(6));
      const V3 nd = normalize(lam);
      cos_in = dot3(nd, bw) / PI_F;
      const float cos_pdf = jmax(cos_in, 0.f);
      float pdf_sum = 0.f;
      for (int l = 0; l < n_lights; ++l)
        pdf_sum = pdf_sum + light_pdf(lt + l * LT_COLS, p, lam);
      pdf_raw = 0.5f * cos_pdf + 0.5f * pdf_sum / (float)n_lights;
    } else {
      lam = cosd;
      const V3 nd = normalize(lam);
      cos_in = dot3(nd, bw) / PI_F;
      pdf_raw = jmax(cos_in, 0.f);
    }
    pdf = pdf_raw > PDF_FLOOR ? pdf_raw : PDF_FLOOR;
    s_in = dot3(nrm, normalize(lam)) / PI_F;
    spdf = jmax(s_in, 0.f);
    lam_w = spdf / pdf;
    wt = scl(lam_w, alb);
  } else if (mkind == MAT_METAL) {
    const V3 ud = normalize(d);
    const float dn2 = 2.f * dot3(ud, nrm);
    const V3 rf = {ud.x - dn2 * nrm.x, ud.y - dn2 * nrm.y,
                   ud.z - dn2 * nrm.z};
    const V3 fb = ball(R(9), R(10), R(11), R(7));
    const V3 m = {rf.x + fuzz * fb.x, rf.y + fuzz * fb.y,
                  rf.z + fuzz * fb.z};
    alive_f = dot3(m, nrm) > 0.f;
    wt = alb;
  } else if (mkind == MAT_DIELECTRIC) {
    wt = {1.f, 1.f, 1.f};
  } else if (mkind == MAT_ISOTROPIC) {
    wt = alb;
  } else if (mkind == MAT_LIGHT) {
    if (d_dot_n < 0.f) em = alb;
    alive_f = false;
  }
  return {em, wt, alive_f, d_dot_n, lam, bw, pdf_raw, pdf, spdf, lam_w,
          cos_in, s_in};
}

// ---- adjoint of the estimator update -------------------------------------

// The cotangents of a found ray's update (update_found): beta's, the
// emitted radiance's and the weight's, and those of o, d, the hit point and
// the scattered direction. go, gd, gL, gb: the cotangents of o', d', L',
// beta'. L's own cotangent passes through unchanged (L' = L + ...).
struct UpdateVjp {
  V3 g_beta, g_em, g_wt, g_o, g_d, g_p, g_sd;
};

__device__ __forceinline__ UpdateVjp update_found_vjp(V3 beta, V3 em, V3 wt,
                                                      bool alive_f, V3 go,
                                                      V3 gd, V3 gL, V3 gb) {
  UpdateVjp u;
  u.g_beta = {gL.x * em.x + gb.x * wt.x, gL.y * em.y + gb.y * wt.y,
              gL.z * em.z + gb.z * wt.z};
  u.g_em = {gL.x * beta.x, gL.y * beta.y, gL.z * beta.z};
  u.g_wt = {gb.x * beta.x, gb.y * beta.y, gb.z * beta.z};
  u.g_o = alive_f ? V3{0.f, 0.f, 0.f} : go;
  u.g_d = alive_f ? V3{0.f, 0.f, 0.f} : gd;
  u.g_p = alive_f ? go : V3{0.f, 0.f, 0.f};
  u.g_sd = alive_f ? gd : V3{0.f, 0.f, 0.f};
  return u;
}

// A live ray that found nothing (update_miss: L += beta * bg): beta's
// cotangent; the background row's share goes into dbg[0..2], entries S
// apart.
template <int S = 1>
__device__ __forceinline__ V3 update_miss_vjp(const float* __restrict__ bg,
                                              V3 beta, V3 gL, V3 gb,
                                              float* dbg) {
  dbg[0] += gL.x * beta.x;
  dbg[S] += gL.y * beta.y;
  dbg[2 * S] += gL.z * beta.z;
  return {gb.x + gL.x * bg[0], gb.y + gL.y * bg[1], gb.z + gL.z * bg[2]};
}

// ---- adjoint of the shading (the ray's material) -------------------------

// For the cotangents of the emitted radiance, the weight and the scattered
// direction: adds d's and p's into g_d and g_p, the light rows' into dlt
// (n_lights rows of LT_COLS, entries S apart), and returns the normal's,
// the albedo's, the fuzz's and the ior's. Kernel I' (shade.cu) runs the
// Lambertian branch with lights light-major: lambertian_vjp_head there is
// this branch but its loop, which I' steps through with the block.
template <int S = 1>
__device__ __forceinline__ void shade_vjp(
    const ShadeFwd& f, int mkind, V3 d, V3 nrm, V3 p, V3 alb, float ior,
    const float* __restrict__ lt, int n_lights, const float* __restrict__ r,
    size_t rs, V3 g_em, V3 g_wt, V3 g_sd, V3& g_d, V3& g_p, V3& g_n,
    V3& g_a, float& g_fuzz, float& g_ior, float* dlt) {
  auto R = [&](int c) { return r[c * rs]; };
  g_n = {0.f, 0.f, 0.f};
  g_a = {0.f, 0.f, 0.f};
  g_fuzz = 0.f;
  g_ior = 0.f;
  if (mkind == MAT_LAMBERTIAN) {
    const V3 lam = f.lam;
    const float pdf = f.pdf, spdf = f.spdf, lam_w = f.lam_w;
    g_a = {g_wt.x * lam_w, g_wt.y * lam_w, g_wt.z * lam_w};
    const float g_lamw = g_wt.x * alb.x + g_wt.y * alb.y + g_wt.z * alb.z;
    const float g_spdf = g_lamw / pdf;
    const float g_pdf = f.pdf_raw > PDF_FLOOR ? -g_lamw * spdf / (pdf * pdf)
                                              : 0.f;
    const float g_s = pick_bwd(f.s_in, spdf, 0.f, g_spdf) / PI_F;
    g_n = add(g_n, scl(g_s, normalize(lam)));
    float g_cos = g_pdf;
    if (n_lights > 0) {
      g_cos = 0.5f * g_pdf;
      const float g_ps = (g_pdf / (float)n_lights) * 0.5f;
      for (int l = 0; l < n_lights; ++l) {
        const float* lr = lt + l * LT_COLS;
        if (lr[0] == LIGHT_SPHERE_F)
          sphere_pdf_bwd<S>(lr, p, lam, g_ps, dlt + l * LT_COLS * S, g_p);
        else if (lr[0] == LIGHT_QUAD_F)
          quad_pdf_bwd<S>(lr, p, lam, g_ps, dlt + l * LT_COLS * S, g_p);
      }
    }
    const float g_c = pick_bwd(f.cos_in, jmax(f.cos_in, 0.f), 0.f, g_cos) /
                      PI_F;
    g_n = add(g_n, normalize_bwd(nrm, scl(g_c, normalize(lam))));
  } else if (mkind == MAT_METAL) {
    g_a = g_wt;
    const V3 fb = ball(R(9), R(10), R(11), R(7));
    g_fuzz = dot3(g_sd, fb);
    const V3 ud = normalize(d);
    V3 g_ud = {0.f, 0.f, 0.f};
    reflect_bwd(ud, nrm, g_sd, g_ud, g_n);
    g_d = add(g_d, normalize_bwd(d, g_ud));
  } else if (mkind == MAT_DIELECTRIC) {
    const V3 ud = normalize(d);
    const bool exiting = f.d_dot_n > 0.f;
    const float ratio = exiting ? ior : 1.f / ior;
    const V3 no = exiting ? V3{-nrm.x, -nrm.y, -nrm.z} : nrm;
    const float cos_in_t = -dot3(ud, no);
    const float cos_t = jmin(cos_in_t, 1.f);
    const float sin_t = safe_sqrt(1.f - cos_t * cos_t);
    const bool tir = ratio * sin_t > 1.f;
    const V3 po = {ratio * (ud.x + cos_t * no.x),
                   ratio * (ud.y + cos_t * no.y),
                   ratio * (ud.z + cos_t * no.z)};
    const float k_in = 1.f - (po.x * po.x + po.y * po.y + po.z * po.z);
    const float kk = fabsf(k_in);
    const float sk = safe_sqrt(kk);
    float r0 = (1.f - ior) / (1.f + ior);
    r0 = r0 * r0;
    const float one_m = 1.f - cos_t;
    const float om2 = one_m * one_m;
    const float schl = r0 + (1.f - r0) * om2 * om2 * one_m;
    const bool do_refl = tir || schl >= R(2);
    V3 g_ud = {0.f, 0.f, 0.f};
    if (do_refl) {
      reflect_bwd(ud, nrm, g_sd, g_ud, g_n);
    } else {
      const V3 g_ref = g_sd;
      V3 g_po = g_ref;
      const float g_sk = -dot3(g_ref, no);
      V3 g_no = scl(-sk, g_ref);
      const float g_kk = safe_sqrt_bwd(kk, g_sk);
      const float g_kin = k_in >= 0.f ? g_kk : -g_kk;
      g_po = add(g_po, scl(-2.f * g_kin, po));
      const V3 e = add(ud, scl(cos_t, no));
      const float g_ratio = dot3(g_po, e);
      const V3 g_e = scl(ratio, g_po);
      g_ud = g_e;
      const float g_cost = dot3(g_e, no);
      g_no = add(g_no, scl(cos_t, g_e));
      const float g_ct = -pick_bwd(cos_in_t, cos_t, 1.f, g_cost);
      g_ud = add(g_ud, scl(g_ct, no));
      g_no = add(g_no, scl(g_ct, ud));
      g_n = add(g_n, exiting ? V3{-g_no.x, -g_no.y, -g_no.z} : g_no);
      g_ior = exiting ? g_ratio : -g_ratio / (ior * ior);
    }
    g_d = add(g_d, normalize_bwd(d, g_ud));
  } else if (mkind == MAT_ISOTROPIC) {
    g_a = g_wt;
  } else if (mkind == MAT_LIGHT) {
    if (f.d_dot_n < 0.f) g_a = g_em;
  }
}

// ---- adjoint of the hit attributes (the winner's kind) -------------------

// Cotangents of kernel J's outputs: t, p, n, u, v and the sphere-UV source.
struct HitCot {
  float t;
  V3 p, n;
  float u, v;
  V3 uv;
};

// Adds the cotangents of the ray (g_o, g_d), the shutter time (g_time), the
// winner's pack (g_pk) and the medium distance (g_tmed) for the hit
// attributes of winner kind kd at the raw distance t (0 on a miss) and hit
// point p = o + t d; ny_pre is the normal's y before the FlipFace fold.
// Kernel B's form (SPLIT false) takes the cotangents of p and n only, of a
// triangle, sphere or quad winner, and assigns g_pk. The SPLIT form is
// hit_plane_core_vjp whole: every kind, the cotangents of t, u and v too,
// and the sphere reading of the pack runs on every lane, since the
// sphere-UV source is computed (and takes its cotangent) on every lane.
template <bool SPLIT>
__device__ __forceinline__ void hit_attrs_vjp(
    int kd, V3 o, V3 d, float time, float tmin, float tmax,
    const float* __restrict__ pk, bool flip, float ny_pre, float t, V3 p,
    HitCot g, V3& g_o, V3& g_d, float& g_time, float (&g_pk)[9],
    float& g_tmed) {
  V3 g_n = g.n;
  const V3 g_p = g.p;
  if (flip) g_n.y = -(ny_pre >= 0.f ? g_n.y : -g_n.y);
  // p = o + t d
  float g_t;
  if constexpr (SPLIT)
    g_t = (kd != KIND_NONE ? g.t : 0.f) + dot3(g_p, d);
  else
    g_t = dot3(g_p, d);
  g_o = add(g_o, g_p);
  g_d = add(g_d, scl(t, g_p));
  if (kd == KIND_TRI) {
    const V3 v0 = {pk[0], pk[1], pk[2]};
    const V3 e1 = {pk[3], pk[4], pk[5]}, e2 = {pk[6], pk[7], pk[8]};
    const V3 tn = cross(e1, e2);
    const float det = -dot3(d, tn);
    const float t_num = dot3(o, tn) - dot3(v0, tn);
    const float inv_det = safe_div(1.f, det);
    float g_inv = g_t * t_num;
    V3 m = {0.f, 0.f, 0.f}, c_e2v0 = m, c_v0e1 = m;
    if constexpr (SPLIT) {
      m = cross(o, d);
      c_e2v0 = cross(e2, v0);
      c_v0e1 = cross(v0, e1);
      const float u_num = dot3(m, e2) - dot3(d, c_e2v0);
      const float v_num = -dot3(m, e1) - dot3(d, c_v0e1);
      g_inv = g_inv + g.u * u_num + g.v * v_num;
    }
    const float g_tn_ = g_t * inv_det;
    const float g_det = safe_div_den_bwd(1.f, det, g_inv);
    const float sgn = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
    V3 g_tn = normalize_bwd(tn, scl(sgn, g_n));
    g_d = add(g_d, scl(-g_det, tn));
    g_tn = add(g_tn, scl(-g_det, d));
    g_o = add(g_o, scl(g_tn_, tn));
    g_tn = add(g_tn, scl(g_tn_, sub(o, v0)));
    V3 g_v0 = scl(-g_tn_, tn);
    V3 g_e1 = {0.f, 0.f, 0.f}, g_e2 = {0.f, 0.f, 0.f};
    if constexpr (SPLIT) {
      const float g_un = g.u * inv_det, g_vn = g.v * inv_det;
      const V3 g_m = add(scl(g_un, e2), scl(-g_vn, e1));
      g_e2 = scl(g_un, m);
      g_e1 = scl(-g_vn, m);
      g_d = add(g_d, add(scl(-g_un, c_e2v0), scl(-g_vn, c_v0e1)));
      cross_bwd(e2, v0, scl(-g_un, d), g_e2, g_v0);
      cross_bwd(v0, e1, scl(-g_vn, d), g_v0, g_e1);
      cross_bwd(o, d, g_m, g_o, g_d);
    }
    cross_bwd(e1, e2, g_tn, g_e1, g_e2);
    const float gp9[9] = {g_v0.x, g_v0.y, g_v0.z, g_e1.x, g_e1.y,
                          g_e1.z, g_e2.x, g_e2.y, g_e2.z};
#pragma unroll
    for (int k = 0; k < 9; ++k) g_pk[k] = gp9[k];
  }
  if (SPLIT || kd == KIND_SPH) {
    const V3 c0 = {pk[0], pk[1], pk[2]}, c1 = {pk[3], pk[4], pk[5]};
    const float st0_ = pk[6], st1_ = pk[7], sr = pk[8];
    const float num = time - st0_, den = st1_ - st0_;
    const float frac = safe_div(num, den);
    const V3 dc = sub(c1, c0);
    const V3 cen = {c0.x + frac * dc.x, c0.y + frac * dc.y,
                    c0.z + frac * dc.z};
    const V3 oc = sub(o, cen);
    const float a = dot3(d, d);
    const float bq = dot3(oc, d);
    const float cc = dot3(oc, oc) - sr * sr;
    const float disc = bq * bq - a * cc;
    const float sq = safe_sqrt(disc);
    const float nb1 = -bq - sq, nb2 = -bq + sq;
    const float root1 = safe_div(nb1, a);
    const bool ok1 = disc > 0.f && root1 >= tmin && root1 <= tmax;
    const float m_r = jmax(sr, 1e-12f);
    const float inv_r = 1.f / m_r;
    // the sphere reading's hit point: the winner's on a sphere lane
    float ts = t;
    V3 ps = p;
    V3 g_ns = g_n;
    float gt = g_t;
    V3 g_ps = scl(inv_r, g_n);
    if constexpr (SPLIT) {
      ts = ok1 ? root1 : safe_div(nb2, a);
      ps = {o.x + ts * d.x, o.y + ts * d.y, o.z + ts * d.z};
      if (kd != KIND_SPH) {
        g_ns = {0.f, 0.f, 0.f};
        gt = 0.f;
      }
      V3 g_ps0 = {0.f, 0.f, 0.f};
      if (ok1)
        g_ns = add(g_ns, g.uv);
      else
        g_ps0 = g.uv;
      g_ps = add(g_ps0, scl(inv_r, g_ns));
    }
    const V3 rel = sub(ps, cen);
    V3 g_cen = scl(-inv_r, g_ns);
    const float g_invr = dot3(g_ns, rel);
    g_o = add(g_o, g_ps);
    gt = gt + dot3(g_ps, d);
    g_d = add(g_d, scl(ts, g_ps));
    float g_sr = pick_bwd(sr, m_r, 1e-12f, -g_invr / (m_r * m_r));
    const float g1 = ok1 ? gt : 0.f, g2 = ok1 ? 0.f : gt;
    const float g_nb1 = safe_div_num_bwd(a, g1);
    const float g_nb2 = safe_div_num_bwd(a, g2);
    const float g_a_ = safe_div_den_bwd(nb1, a, g1) +
                       safe_div_den_bwd(nb2, a, g2);
    float g_b = -g_nb1 - g_nb2;
    const float g_disc = safe_sqrt_bwd(disc, g_nb2 - g_nb1);
    g_b = g_b + 2.f * bq * g_disc;
    const float g_aa = g_a_ - cc * g_disc;
    const float g_cc = -a * g_disc;
    const V3 g_oc = add(scl(2.f * g_cc, oc), scl(g_b, d));
    g_sr = g_sr - 2.f * sr * g_cc;
    g_d = add(g_d, add(scl(g_b, oc), scl(2.f * g_aa, d)));
    g_o = add(g_o, g_oc);
    g_cen = sub(g_cen, g_oc);
    const float g_frac = dot3(g_cen, dc);
    const V3 g_c1 = scl(frac, g_cen);
    const V3 g_c0 = add(g_cen, scl(-frac, g_cen));
    const float g_num = safe_div_num_bwd(den, g_frac);
    const float g_den = safe_div_den_bwd(num, den, g_frac);
    const float gp9[9] = {g_c0.x, g_c0.y, g_c0.z, g_c1.x, g_c1.y,
                          g_c1.z, -g_num - g_den, g_den, g_sr};
#pragma unroll
    for (int k = 0; k < 9; ++k) g_pk[k] = SPLIT ? g_pk[k] + gp9[k] : gp9[k];
    g_time = SPLIT ? g_time + g_num : g_num;
  }
  if (kd == KIND_QUAD) {
    const V3 q = {pk[0], pk[1], pk[2]};
    const V3 qu = {pk[3], pk[4], pk[5]}, qv = {pk[6], pk[7], pk[8]};
    const V3 wn = cross(qu, qv);
    const float denom = dot3(d, wn);
    const V3 qo = sub(q, o);
    const float qnum = dot3(qo, wn);
    const V3 nq = normalize(wn);
    const float dsign = dot3(d, nq) > 0.f ? -1.f : 1.f;
    V3 g_wn = normalize_bwd(wn, scl(dsign, g_n));
    float gt = g_t;
    V3 g_q = {0.f, 0.f, 0.f}, g_qu = g_q, g_qv = g_q;
    if constexpr (SPLIT) {
      // u, v = ((w x qv) . wn, (qu x w) . wn) / |wn|^2, w = o + t d - q
      const float t_q = safe_div(qnum, denom);
      const V3 w = sub(add(o, scl(t_q, d)), q);
      const float n2 = dot3(wn, wn);
      const float inv_n2 = safe_div(1.f, n2);
      const V3 wxv = cross(w, qv), uxw = cross(qu, w);
      const float A = dot3(wxv, wn), B = dot3(uxw, wn);
      const float gA = g.u * inv_n2, gB = g.v * inv_n2;
      const float g_n2 = safe_div_den_bwd(1.f, n2, g.u * A + g.v * B);
      g_wn = add(g_wn, add(scl(gA, wxv), scl(gB, uxw)));
      V3 g_w = {0.f, 0.f, 0.f}, g_w2 = g_w;
      cross_bwd(w, qv, scl(gA, wn), g_w, g_qv);
      cross_bwd(qu, w, scl(gB, wn), g_qu, g_w2);
      g_w = add(g_w, g_w2);
      g_wn = add(g_wn, scl(2.f * g_n2, wn));
      g_o = add(g_o, g_w);
      gt = gt + dot3(g_w, d);
      g_d = add(g_d, scl(t_q, g_w));
      g_q = scl(-1.f, g_w);
    }
    const float g_qn = safe_div_num_bwd(denom, gt);
    const float g_dn = safe_div_den_bwd(qnum, denom, gt);
    g_q = SPLIT ? add(g_q, scl(g_qn, wn)) : scl(g_qn, wn);
    g_o = sub(g_o, scl(g_qn, wn));
    g_wn = add(g_wn, add(scl(g_qn, qo), scl(g_dn, d)));
    g_d = add(g_d, scl(g_dn, wn));
    cross_bwd(qu, qv, g_wn, g_qu, g_qv);
    const float gp9[9] = {g_q.x, g_q.y, g_q.z, g_qu.x, g_qu.y,
                          g_qu.z, g_qv.x, g_qv.y, g_qv.z};
#pragma unroll
    for (int k = 0; k < 9; ++k) g_pk[k] = SPLIT ? g_pk[k] + gp9[k] : gp9[k];
  }
  if constexpr (SPLIT) {
    if (kd == KIND_MED) g_tmed = g_tmed + g_t;
  }
}

}  // namespace trace
