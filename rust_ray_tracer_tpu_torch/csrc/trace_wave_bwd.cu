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
// ops/uber.py:trace_wave_bwd_plain, and the adjoint below is the per-ray
// transliteration of ops/{hit,shade,bounce}_core.py's *_vjp functions,
// winner's kind and material only.
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
//     stably and bwd_reduce sums segment by segment in that fixed order;
//     the light-table cotangents are summed per block in thread order and
//     then across blocks in block order. Gradients are bitwise repeatable.
//
// Numerics: no fast-math (IEEE division and sqrt, as the forward), and
// built with --fmad=false (kernels/__init__.py), so it rounds as its plain
// version does; the forward is recomputed with the forward kernel's
// formulas (trace_common.cuh), so its branches (tir, metal_ok, the checker
// parity) are the forward's up to the forward's FMA contraction. The
// kinks follow jax.vjp: max/min split the cotangent evenly on a tie, a where() sends nothing to
// the untaken branch, abs'(0) = 1, the clamped divisor of safe_div and the
// floor of the pdf take none.

#include "trace_common.cuh"

namespace {

using namespace trace;

constexpr int TILE = 1024;           // the TPU kernels' liveness grain
constexpr int MAX_LT = 128;          // (n_lights + 1) * LT_COLS <= 128
constexpr int RED = 256;             // threads of a reduction block
constexpr int W_MAX = 32;            // winner-row columns a block sums

struct BwdTables {
  const float* uni;   // [P, w] winner rows (a miss reads none)
  const float* lt;    // [n_lights + 1, LT_COLS]; last row = background
  int w, n_lights, has_checker, p_rows;
};

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
// (added into dl[1..4]) and of p.
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
  dl[1] += g_tc.x;
  dl[2] += g_tc.y;
  dl[3] += g_tc.z;
  dl[4] += 2.f * r * g_rr;
  gp = sub(gp, g_tc);
}

// One quad light's pdf adjoint: cotangents of q, u, v (dl[5..13]) and p.
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
  dl[5] += g_q.x;
  dl[6] += g_q.y;
  dl[7] += g_q.z;
  dl[8] += g_lu.x;
  dl[9] += g_lu.y;
  dl[10] += g_lu.z;
  dl[11] += g_lv.x;
  dl[12] += g_lv.y;
  dl[13] += g_lv.z;
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

__global__ void __launch_bounds__(ROW)
trace_wave_bwd_kernel(const float* __restrict__ hist,
                      const float* __restrict__ rnd,
                      const int* __restrict__ kind,
                      const int* __restrict__ idx,
                      const float* __restrict__ g_in, const BwdTables tb,
                      float* __restrict__ dst, float* __restrict__ contrib,
                      int* __restrict__ keys, float* __restrict__ dlt_part,
                      int n, int depth) {
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
      gs[11] += gL.x * bg[0];
      gs[12] += gL.y * bg[1];
      gs[13] += gL.z * bg[2];
      dlt[tb.n_lights * LT_COLS + 0] += gL.x * beta.x;
      dlt[tb.n_lights * LT_COLS + 1] += gL.y * beta.y;
      dlt[tb.n_lights * LT_COLS + 2] += gL.z * beta.z;
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
    const V3 alb = {att[leaf], att[leaf + 1], att[leaf + 2]};

    const int rb = b * 15;
    auto R = [&](int c) { return rnd[(size_t)(rb + c) * n + i]; };
    const float d_dot_n = dot3(d, nrm);
    V3 em = {0.f, 0.f, 0.f}, wt = {0.f, 0.f, 0.f};
    bool alive_f = true;
    // Lambertian intermediates
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
      if (tb.n_lights > 0) {
        const float u3 = R(3), u4 = R(4);
        const int li = min((int)(u4 * (float)tb.n_lights), tb.n_lights - 1);
        lam = cosd;
        if (!(u3 < 0.5f)) lam = light_sample(tb.lt + li * LT_COLS, p, R(5),
                                              R(6));
        const V3 nd = normalize(lam);
        cos_in = dot3(nd, bw) / PI_F;
        const float cos_pdf = jmax(cos_in, 0.f);
        float pdf_sum = 0.f;
        for (int l = 0; l < tb.n_lights; ++l)
          pdf_sum = pdf_sum + light_pdf(tb.lt + l * LT_COLS, p, lam);
        pdf_raw = 0.5f * cos_pdf + 0.5f * pdf_sum / (float)tb.n_lights;
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
      const V3 r = {ud.x - dn2 * nrm.x, ud.y - dn2 * nrm.y,
                    ud.z - dn2 * nrm.z};
      const V3 fb = ball(R(9), R(10), R(11), R(7));
      const V3 m = {r.x + fuzz * fb.x, r.y + fuzz * fb.y, r.z + fuzz * fb.z};
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

    // ---- adjoint of the estimator update (bounce_plane_core_vjp) -------
    const V3 gb = {gs[11], gs[12], gs[13]};
    const V3 go = {gs[0], gs[1], gs[2]};
    const V3 gd = {gs[3], gs[4], gs[5]};
    gs[11] = gL.x * em.x + gb.x * wt.x;
    gs[12] = gL.y * em.y + gb.y * wt.y;
    gs[13] = gL.z * em.z + gb.z * wt.z;
    const V3 g_em = {gL.x * beta.x, gL.y * beta.y, gL.z * beta.z};
    const V3 g_wt = {gb.x * beta.x, gb.y * beta.y, gb.z * beta.z};
    V3 g_o = alive_f ? V3{0.f, 0.f, 0.f} : go;
    V3 g_d = alive_f ? V3{0.f, 0.f, 0.f} : gd;
    V3 g_p = alive_f ? go : V3{0.f, 0.f, 0.f};
    const V3 g_sd = alive_f ? gd : V3{0.f, 0.f, 0.f};

    // ---- adjoint of the shading (plane_core_vjp, winner's material) ----
    V3 g_n = {0.f, 0.f, 0.f}, g_a = {0.f, 0.f, 0.f};
    float g_fuzz = 0.f, g_ior = 0.f;
    if (mkind == MAT_LAMBERTIAN) {
      g_a = {g_wt.x * lam_w, g_wt.y * lam_w, g_wt.z * lam_w};
      const float g_lamw = g_wt.x * alb.x + g_wt.y * alb.y + g_wt.z * alb.z;
      const float g_spdf = g_lamw / pdf;
      const float g_pdf = pdf_raw > PDF_FLOOR ? -g_lamw * spdf / (pdf * pdf)
                                              : 0.f;
      const float g_s = pick_bwd(s_in, spdf, 0.f, g_spdf) / PI_F;
      g_n = add(g_n, scl(g_s, normalize(lam)));
      float g_cos = g_pdf;
      if (tb.n_lights > 0) {
        g_cos = 0.5f * g_pdf;
        const float g_ps = (g_pdf / (float)tb.n_lights) * 0.5f;
        for (int l = 0; l < tb.n_lights; ++l) {
          const float* lr = tb.lt + l * LT_COLS;
          if (lr[0] == LIGHT_SPHERE_F)
            sphere_pdf_bwd(lr, p, lam, g_ps, dlt + l * LT_COLS, g_p);
          else if (lr[0] == LIGHT_QUAD_F)
            quad_pdf_bwd(lr, p, lam, g_ps, dlt + l * LT_COLS, g_p);
        }
      }
      const float g_c = pick_bwd(cos_in, jmax(cos_in, 0.f), 0.f, g_cos) /
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
      const bool exiting = d_dot_n > 0.f;
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
      if (d_dot_n < 0.f) g_a = g_em;
    }

    // ---- adjoint of the hit attributes (hit_plane_core_vjp, winner) ----
    if (flip) g_n.y = -(ny_pre >= 0.f ? g_n.y : -g_n.y);
    float g_pk[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float g_time = 0.f;
    // p = o + t d
    float g_t = dot3(g_p, d);
    g_o = add(g_o, g_p);
    g_d = add(g_d, scl(t, g_p));
    if (kd == KIND_TRI) {
      const V3 v0 = {pk[0], pk[1], pk[2]};
      const V3 e1 = {pk[3], pk[4], pk[5]}, e2 = {pk[6], pk[7], pk[8]};
      const V3 tn = cross(e1, e2);
      const float det = -dot3(d, tn);
      const float t_num = dot3(o, tn) - dot3(v0, tn);
      const float inv_det = safe_div(1.f, det);
      const float g_tn_ = g_t * inv_det;
      const float g_det = safe_div_den_bwd(1.f, det, g_t * t_num);
      const float sgn = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
      V3 g_tn = normalize_bwd(tn, scl(sgn, g_n));
      g_d = add(g_d, scl(-g_det, tn));
      g_tn = add(g_tn, scl(-g_det, d));
      g_o = add(g_o, scl(g_tn_, tn));
      g_tn = add(g_tn, scl(g_tn_, sub(o, v0)));
      const V3 g_v0 = scl(-g_tn_, tn);
      V3 g_e1 = {0.f, 0.f, 0.f}, g_e2 = {0.f, 0.f, 0.f};
      cross_bwd(e1, e2, g_tn, g_e1, g_e2);
      const float gp9[9] = {g_v0.x, g_v0.y, g_v0.z, g_e1.x, g_e1.y,
                            g_e1.z, g_e2.x, g_e2.y, g_e2.z};
#pragma unroll
      for (int k = 0; k < 9; ++k) g_pk[k] = gp9[k];
    } else if (kd == KIND_SPH) {
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
      const bool ok1 = disc > 0.f && root1 >= T_MIN && root1 <= INFINITY;
      const float m_r = jmax(sr, 1e-12f);
      const float inv_r = 1.f / m_r;
      const V3 ps = p;                       // t_sph is the winner's t
      const V3 rel = sub(ps, cen);
      const V3 g_ps = scl(inv_r, g_n);
      V3 g_cen = scl(-inv_r, g_n);
      const float g_invr = dot3(g_n, rel);
      g_o = add(g_o, g_ps);
      const float gt = g_t + dot3(g_ps, d);
      g_d = add(g_d, scl(t, g_ps));
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
      for (int k = 0; k < 9; ++k) g_pk[k] = gp9[k];
      g_time = g_num;
    } else {
      const V3 q = {pk[0], pk[1], pk[2]};
      const V3 qu = {pk[3], pk[4], pk[5]}, qv = {pk[6], pk[7], pk[8]};
      const V3 wn = cross(qu, qv);
      const float denom = dot3(d, wn);
      const V3 qo = sub(q, o);
      const float qnum = dot3(qo, wn);
      const V3 nq = normalize(wn);
      const float dsign = dot3(d, nq) > 0.f ? -1.f : 1.f;
      V3 g_wn = normalize_bwd(wn, scl(dsign, g_n));
      const float g_qn = safe_div_num_bwd(denom, g_t);
      const float g_dn = safe_div_den_bwd(qnum, denom, g_t);
      const V3 g_q = scl(g_qn, wn);
      g_o = sub(g_o, scl(g_qn, wn));
      g_wn = add(g_wn, add(scl(g_qn, qo), scl(g_dn, d)));
      g_d = add(g_d, scl(g_dn, wn));
      V3 g_qu = {0.f, 0.f, 0.f}, g_qv = {0.f, 0.f, 0.f};
      cross_bwd(qu, qv, g_wn, g_qu, g_qv);
      const float gp9[9] = {g_q.x, g_q.y, g_q.z, g_qu.x, g_qu.y,
                            g_qu.z, g_qv.x, g_qv.y, g_qv.z};
#pragma unroll
      for (int k = 0; k < 9; ++k) g_pk[k] = gp9[k];
    }

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
    out[A_COL + leaf] = g_a.x;
    out[A_COL + leaf + 1] = g_a.y;
    out[A_COL + leaf + 2] = g_a.z;
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

// Fixed-order sums of the winner-row cotangents. The contributions in the
// order of ``perm`` (the stable sort of the keys; row p's segment is
// offs[p]..offs[p+1]) are cut at the multiples of ``piece``, so row p
// spans floor(offs[p+1] / piece) - floor(offs[p] / piece) + 1 blocks (at
// least one) and its first block is floor(offs[p] / piece) + p, a closed
// form of offs that a block inverts by binary search. Each thread sums the
// elements t, t + RED, ... of its block's part of the row in order, and a
// fixed tree the threads' sums. A row of one block is written at once; for
// a longer row the block sums go to ``partial`` and the row's last block to
// finish (an integer counter, which orders nothing) adds them in block
// order. So a row hit by most rays (a lamp) spreads over many blocks and
// the result is the same bits in every run. Blocks past the rows' add the
// k-th light-table entry of every kernel-B block's partial, in block order.
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

__device__ __forceinline__ int first_block(const int* __restrict__ offs,
                                           int p, int piece) {
  return offs[p] / piece + p;
}

__global__ void __launch_bounds__(RED)
bwd_reduce_kernel(const float* __restrict__ contrib,
                  const int* __restrict__ perm, const int* __restrict__ offs,
                  int p_rows, int w, int piece, int max_blocks,
                  float* __restrict__ partial, int* __restrict__ done,
                  const float* __restrict__ dlt_part, int n_part, int ltn,
                  float* __restrict__ duni, float* __restrict__ dlt) {
  __shared__ float red[RED];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int k = blockIdx.x;
  if (k >= max_blocks) {                    // a light-table entry
    float acc = 0.f;
    for (int j = t; j < n_part; j += RED)
      acc += dlt_part[(size_t)j * ltn + (k - max_blocks)];
    acc = block_sum(acc, red);
    if (t == 0) dlt[k - max_blocks] = acc;
    return;
  }
  if (k >= first_block(offs, p_rows, piece)) return;   // past the rows
  int lo = 0, hi = p_rows;                  // the row: first_block <= k
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (first_block(offs, mid, piece) <= k) lo = mid; else hi = mid;
  }
  const int p = lo;
  const int b0 = first_block(offs, p, piece);
  const int n_blocks = first_block(offs, p + 1, piece) - b0;
  const int cut = (offs[p] / piece + (k - b0)) * piece;
  const int j0 = max(offs[p], cut);
  const int j1 = min(offs[p + 1], cut + piece);
  float acc[W_MAX];
#pragma unroll
  for (int c = 0; c < W_MAX; ++c) acc[c] = 0.f;
  for (int j = j0 + t; j < j1; j += RED) {
    const float* __restrict__ src = contrib + (size_t)perm[j] * w;
#pragma unroll
    for (int c = 0; c < W_MAX; ++c)
      if (c < w) acc[c] += src[c];
  }
  float* __restrict__ out = n_blocks == 1 ? duni + (size_t)p * w
                                          : partial + (size_t)k * w;
#pragma unroll
  for (int c = 0; c < W_MAX; ++c) {
    if (c >= w) break;
    const float v = block_sum(acc[c], red);
    if (t == 0) out[c] = v;
  }
  if (n_blocks == 1) return;
  __threadfence();                          // the block sums, then count
  if (t == 0) last = atomicAdd(done + p, 1) == n_blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t < w) {
    float sum = 0.f;
    for (int i = 0; i < n_blocks; ++i)
      sum += __ldcg(partial + (size_t)(b0 + i) * w + t);
    duni[(size_t)p * w + t] = sum;
  }
}

}  // namespace

// Launch kernel B on ``stream``; returns cudaGetLastError() (0 =
// launched). hist [depth, 14, n], rnd [depth, 15, n], g and dst [14, n]
// float32; kind, idx and keys [depth, n] int32; contrib [depth, n, w];
// dlt_part [n / 128, (n_lights + 1) * 14]. n is a multiple of 1024.
extern "C" int trace_wave_bwd_launch(
    const float* hist, const float* rnd, const int* kind, const int* idx,
    const float* g, const float* uni, const float* lt,
    float* dst, float* contrib, int* keys, float* dlt_part, int n,
    int depth, int w, int p_rows, int n_lights, int has_checker,
    void* stream) {
  if (n % TILE != 0 || (n_lights + 1) * LT_COLS > MAX_LT) return -1;
  BwdTables tb{uni, lt, w, n_lights, has_checker, p_rows};
  const int blocks = n / ROW;
  if (blocks > 0) {
    trace_wave_bwd_kernel<<<blocks, ROW, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        hist, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n,
        depth);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch bwd_reduce on ``stream``: duni [p_rows, w], dlt [ltn]. The
// sorted contributions are cut every ``piece``; max_blocks = p_rows +
// (number of contributions) / piece bounds the blocks without reading
// offs; partial [max_blocks, w] is scratch and done [p_rows] int32 zeros.
extern "C" int bwd_reduce_launch(const float* contrib, const int* perm,
                                 const int* offs, int p_rows, int w,
                                 int piece, int max_blocks, float* partial,
                                 int* done, const float* dlt_part,
                                 int n_part, int ltn, float* duni,
                                 float* dlt, void* stream) {
  if (w > W_MAX || w > RED || piece <= 0) return -1;
  bwd_reduce_kernel<<<max_blocks + ltn, RED, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      contrib, perm, offs, p_rows, w, piece, max_blocks, partial, done,
      dlt_part, n_part, ltn, duni, dlt);
  return static_cast<int>(cudaGetLastError());
}
