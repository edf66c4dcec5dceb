// Whole-wave path trace: every bounce of every ray of a sample wave in one
// kernel launch, on Hopper (sm_90a).
//
// Replaces the TPU kernel rust_ray_tracer_tpu/ops/pallas_uber.py
// _make_trace_kernel (launched by _trace_impl, pallas_uber.py:1017), whose
// device functions are _search_row (:121), _tile_core (:500) and, through
// pallas_bounce._bounce_plane_core, pallas_hit._hit_plane_core and
// pallas_shade._plane_core. Its plain PyTorch version is
// ops/uber.py:trace_wave_plain, which follows these formulas line for line.
//
// What bounds it on the card: fp32 ALU work of the triangle sweep (four
// 10-term Plücker dots and a division per ray x triangle in every culled
// chunk a ray's row enters), and warp divergence, because rays die at
// different bounces (about 93% of the flagship's primaries miss at bounce
// 0) and materials branch. Memory traffic is small: 14 state floats in,
// 15 random floats per bounce, 14 out; the scene tables (a few hundred KB)
// stay in L1/L2 and every lane of a warp reads the same table row at the
// same time, which is a broadcast. When a gradient is wanted it also
// writes the backward's residuals, 14 floats and two ints per ray and
// bounce (hist, kind, idx), as _make_trace_kernel does.
//
// What the design does about it:
//   * one thread per ray, the bounce loop in registers — the TPU's
//     [14, 8, 128] plane tiles, revisited VMEM blocks and one-hot MXU row
//     fetches become plain registers and indexed loads;
//   * a block of 128 threads is one TPU ray row, and the per-(row,
//     512-triangle chunk) AABB cull is a block-wide vote (__syncthreads_or)
//     on the same slab test, so each ray sweeps exactly the chunks its TPU
//     row swept: the closest hit is the TPU's, not a less conservative
//     per-ray cull that could drop a hit at the fp edge;
//   * the chunk loop stops at the real chunk count (an all-pad chunk's
//     inverted box would pass the slab test);
//   * a block leaves the bounce loop once all its rays are dead, and a
//     dead ray skips the sweep (its empty window rejects everything);
//   * only the winner's hit attributes and material are evaluated: the
//     same values the plain version selects out of all kinds.
//
// Numerics match the plain version except where nvcc contracts a*b+c into
// an FMA and where CUDA's sinf/cosf/expf/logf differ from the host's by an
// ulp. No fast-math: __sinf would flip checker parities and approximate
// division would move t. Comparisons are written out (jmax/jmin propagate
// NaN like jnp.maximum/minimum): fminf/fmaxf drop NaN, and the sphere
// table's far pad rows rely on a NaN discriminant to be rejected.
//
// Tie rules: triangles sweep ascending ids with strict < (the lowest id
// wins a tie in t), then spheres, then quads, each with strict <, so a tie
// goes triangle > sphere > quad. A miss has kind 0 and row 0.

#include "trace_common.cuh"

namespace {

using namespace trace;

struct Tables {
  const float* uni;   // [P, w] winner rows
  const float* det;   // [Tp, 10] Plücker coefficient rows
  const float* um;
  const float* vm;
  const float* tm;
  const float* dbl;   // [Tp] double-sided flag
  const float* sph;   // [S, 9] c0, c1-c0, t0, 1/(t1-t0), r
  const float* quad;  // [Q, 9] q, u, v
  const float* cab;   // [chunks, 8] lo3, hi3, 0, 0
  const float* lt;    // [n_lights + 1, LT_COLS]; last row = background
  int w, n_tri_chunks, n_sph, n_quad, t_off, s_off, q_off, n_lights,
      has_checker;
};

__global__ void __launch_bounds__(ROW)
trace_wave_kernel(const float* __restrict__ st0,
                  const float* __restrict__ rnd, const Tables tb,
                  float* __restrict__ stf, float* __restrict__ hist,
                  int* __restrict__ kind_out, int* __restrict__ idx_out,
                  int n, int depth) {
  const int i = blockIdx.x * ROW + threadIdx.x;
  const bool in = i < n;
  float s[14];
#pragma unroll
  for (int c = 0; c < 14; ++c) s[c] = in ? st0[(size_t)c * n + i] : 0.f;
  float ox = s[0], oy = s[1], oz = s[2], dx = s[3], dy = s[4], dz = s[5];
  const float time = s[6];
  float alive = s[7];
  float Lx = s[8], Ly = s[9], Lz = s[10], bx = s[11], by = s[12],
        bz = s[13];
  const float* __restrict__ bg = tb.lt + tb.n_lights * LT_COLS;

  // the backward's residuals (pallas_uber.py:887-916), when asked for:
  // bounce b's input state, and its winner (kind, row), 0 on a miss
  const bool res = hist != nullptr && in;
  auto save_state = [&](int b) {
    const float st[14] = {ox, oy, oz, dx, dy, dz, time, alive,
                          Lx, Ly, Lz, bx, by, bz};
#pragma unroll
    for (int c = 0; c < 14; ++c) hist[((size_t)b * 14 + c) * n + i] = st[c];
  };
  auto save_winner = [&](int b, int k, int row) {
    kind_out[(size_t)b * n + i] = k;
    idx_out[(size_t)b * n + i] = row;
  };

  for (int b = 0; b < depth; ++b) {
    if (res) save_state(b);
    const bool live_in = alive > 0.5f;
    if (!__syncthreads_or(live_in)) {        // the whole row is dead:
      if (res) {                             // the state stands still
        save_winner(b, KIND_NONE, 0);
        for (int bb = b + 1; bb < depth; ++bb) {
          save_state(bb);
          save_winner(bb, KIND_NONE, 0);
        }
      }
      break;
    }
    const float tmin = T_MIN;
    const float tmax = live_in ? INFINITY : -1.f;

    // ---- phase 1: closest hit (pallas_uber._search_row) ----------------
    float best_t = INFINITY;
    int best_k = KIND_NONE, best_i = 0;
    if (tb.n_tri_chunks > 0) {
      const float f[10] = {ox, oy, oz, dx, dy, dz, oy * dz - oz * dy,
                           oz * dx - ox * dz, ox * dy - oy * dx, 1.f};
      const float eps = TRI_DET_EPS * sqrtf(dx * dx + dy * dy + dz * dz);
      const float ivx = 1.f / (fabsf(dx) < 1e-30f ? 1e-30f : dx);
      const float ivy = 1.f / (fabsf(dy) < 1e-30f ? 1e-30f : dy);
      const float ivz = 1.f / (fabsf(dz) < 1e-30f ? 1e-30f : dz);
      for (int c = 0; c < tb.n_tri_chunks; ++c) {
        const float* box = tb.cab + c * 8;
        const float t0x = (box[0] - ox) * ivx, t1x = (box[3] - ox) * ivx;
        const float t0y = (box[1] - oy) * ivy, t1y = (box[4] - oy) * ivy;
        const float t0z = (box[2] - oz) * ivz, t1z = (box[5] - oz) * ivz;
        const float tn = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)),
                              jmax(jmin(t0z, t1z), tmin));
        const float tf = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)),
                              jmax(t0z, t1z));
        if (!__syncthreads_or(tf >= tn && live_in)) continue;
        if (!live_in) continue;
        for (int j = c * TCC; j < (c + 1) * TCC; ++j) {
          const float dm = dot10(tb.det + (size_t)j * 10, f);
          const bool side_ok =
              dm > eps || (dm < -eps && tb.dbl[j] > 0.5f);
          if (!side_ok) continue;
          const float inv = 1.f / (fabsf(dm) > eps ? dm : 1.f);
          const float u = dot10(tb.um + (size_t)j * 10, f) * inv;
          const float v = dot10(tb.vm + (size_t)j * 10, f) * inv;
          const float t = dot10(tb.tm + (size_t)j * 10, f) * inv;
          const bool valid = u >= 0.f && u <= 1.f && v >= 0.f &&
                             v < 1.f - u && t >= tmin && t <= tmax;
          if (valid && t < best_t) {
            best_t = t;
            best_k = KIND_TRI;
            best_i = tb.t_off + j;
          }
        }
      }
    }
    if (!live_in) {           // a dead ray passes its state through
      if (res) save_winner(b, KIND_NONE, 0);
      continue;
    }
    for (int k = 0; k < tb.n_sph; ++k) {
      const float* sp = tb.sph + k * 9;
      const float frac = (time - sp[6]) * sp[7];
      const float cx = sp[0] + frac * sp[3];
      const float cy = sp[1] + frac * sp[4];
      const float cz = sp[2] + frac * sp[5];
      const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
      const float a = dx * dx + dy * dy + dz * dz;
      const float bq = ocx * dx + ocy * dy + ocz * dz;
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - sp[8] * sp[8];
      const float disc = bq * bq - a * cc;
      const bool ok = disc > 0.f;
      const float sq = sqrtf(jmax(disc, 1e-12f)) * (ok ? 1.f : 0.f);
      const float inv_a = 1.f / jmax(a, 1e-12f);
      const float root1 = (-bq - sq) * inv_a;
      const float root2 = (-bq + sq) * inv_a;
      const bool ok1 = ok && root1 >= tmin && root1 <= tmax;
      const bool ok2 = ok && root2 >= tmin && root2 <= tmax;
      const float t = ok1 ? root1 : (ok2 ? root2 : INFINITY);
      if (t < best_t) {
        best_t = t;
        best_k = KIND_SPH;
        best_i = tb.s_off + k;
      }
    }
    for (int k = 0; k < tb.n_quad; ++k) {
      const float* qd = tb.quad + k * 9;
      const float qx = qd[0], qy = qd[1], qz = qd[2];
      const float ux = qd[3], uy = qd[4], uz = qd[5];
      const float vx = qd[6], vy = qd[7], vz = qd[8];
      const float wnx = uy * vz - uz * vy;
      const float wny = uz * vx - ux * vz;
      const float wnz = ux * vy - uy * vx;
      const float denom = dx * wnx + dy * wny + dz * wnz;
      const float dsafe = fabsf(denom) < 1e-12f
                              ? (denom < 0.f ? -1e-12f : 1e-12f) : denom;
      const float t = ((qx - ox) * wnx + (qy - oy) * wny +
                       (qz - oz) * wnz) / dsafe;
      const float wx = ox + t * dx - qx;
      const float wy = oy + t * dy - qy;
      const float wz = oz + t * dz - qz;
      const float n2 = wnx * wnx + wny * wny + wnz * wnz;
      const float inv_n2 = 1.f / jmax(n2, 1e-12f);
      const float alpha = ((wy * vz - wz * vy) * wnx +
                           (wz * vx - wx * vz) * wny +
                           (wx * vy - wy * vx) * wnz) * inv_n2;
      const float beta = ((uy * wz - uz * wy) * wnx +
                          (uz * wx - ux * wz) * wny +
                          (ux * wy - uy * wx) * wnz) * inv_n2;
      const bool valid = fabsf(denom) > 0.f && t >= tmin && t <= tmax &&
                         alpha >= 0.f && alpha <= 1.f && beta >= 0.f &&
                         beta <= 1.f;
      if (valid && t < best_t) {
        best_t = t;
        best_k = KIND_QUAD;
        best_i = tb.q_off + k;
      }
    }

    if (res) save_winner(b, best_k, best_k == KIND_NONE ? 0 : best_i);

    // ---- miss: background, the path ends -------------------------------
    if (best_k == KIND_NONE) {
      Lx = Lx + bx * bg[0];
      Ly = Ly + by * bg[1];
      Lz = Lz + bz * bg[2];
      alive = 0.f;
      continue;
    }

    // ---- winner row (pallas_uber._tile_core plane assembly) ------------
    const float* row = tb.uni + (size_t)best_i * tb.w;
    const float* pk = row;                  // unified 9-float pack
    const bool flip = row[9] > 0.5f;
    const float* att = row + A_COL;
    const int mkind = (int)att[0];
    const float fuzz = att[1], ior = att[2];
    float ax = att[3], ay = att[4], az = att[5];

    // ---- hit attributes (pallas_hit._hit_plane_core, winner's kind) ----
    float t;
    V3 nrm;
    if (best_k == KIND_TRI) {
      const V3 v0 = {pk[0], pk[1], pk[2]};
      const V3 e1 = {pk[3], pk[4], pk[5]}, e2 = {pk[6], pk[7], pk[8]};
      const V3 tn = {e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
                     e1.x * e2.y - e1.y * e2.x};
      const float det = -(dx * tn.x + dy * tn.y + dz * tn.z);
      const float t_num = dot3({ox, oy, oz}, tn) - dot3(v0, tn);
      t = t_num * safe_div(1.f, det);
      const float sgn = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
      nrm = normalize(tn);
      nrm = {nrm.x * sgn, nrm.y * sgn, nrm.z * sgn};
    } else if (best_k == KIND_SPH) {
      const V3 c0 = {pk[0], pk[1], pk[2]}, c1 = {pk[3], pk[4], pk[5]};
      const float st0_ = pk[6], st1_ = pk[7], sr = pk[8];
      const float frac = safe_div(time - st0_, st1_ - st0_);
      const V3 cen = {c0.x + frac * (c1.x - c0.x),
                      c0.y + frac * (c1.y - c0.y),
                      c0.z + frac * (c1.z - c0.z)};
      const V3 oc = {ox - cen.x, oy - cen.y, oz - cen.z};
      const V3 d = {dx, dy, dz};
      const float a = dx * dx + dy * dy + dz * dz;
      const float bq = dot3(oc, d);
      const float cc = dot3(oc, oc) - sr * sr;
      const float disc = bq * bq - a * cc;
      const float sq = safe_sqrt(disc);
      const float root1 = safe_div(-bq - sq, a);
      const float root2 = safe_div(-bq + sq, a);
      const bool ok1 = disc > 0.f && root1 >= tmin && root1 <= tmax;
      t = ok1 ? root1 : root2;
      const float inv_r = 1.f / jmax(sr, 1e-12f);
      nrm = {(ox + t * dx - cen.x) * inv_r, (oy + t * dy - cen.y) * inv_r,
             (oz + t * dz - cen.z) * inv_r};
    } else {
      const V3 q = {pk[0], pk[1], pk[2]};
      const V3 qu = {pk[3], pk[4], pk[5]}, qv = {pk[6], pk[7], pk[8]};
      const V3 wn = {qu.y * qv.z - qu.z * qv.y, qu.z * qv.x - qu.x * qv.z,
                     qu.x * qv.y - qu.y * qv.x};
      const V3 d = {dx, dy, dz};
      const float denom = dot3(d, wn);
      t = safe_div(dot3({q.x - ox, q.y - oy, q.z - oz}, wn), denom);
      nrm = normalize(wn);
      const float dsign = dot3(d, nrm) > 0.f ? -1.f : 1.f;
      nrm = {nrm.x * dsign, nrm.y * dsign, nrm.z * dsign};
    }
    const V3 p = {ox + t * dx, oy + t * dy, oz + t * dz};
    if (flip) nrm.y = -fabsf(nrm.y);   // geometry/mod.rs:226-230

    if (tb.has_checker && att[12] > 0.5f) {
      // checker (texture.rs:50-57): the sin-product sign picks the leaf
      const float sines = sinf(10.f * p.x) * sinf(10.f * p.y) *
                          sinf(10.f * p.z);
      const float* leaf = sines < 0.f ? att + 9 : att + 6;
      ax = leaf[0];
      ay = leaf[1];
      az = leaf[2];
    }

    // ---- shading (pallas_shade._plane_core, winner's material) ---------
    const int rb = b * 15;
    auto R = [&](int c) { return rnd[(size_t)(rb + c) * n + i]; };
    const V3 d = {dx, dy, dz};
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
      if (tb.n_lights > 0) {
        const float u3 = R(3), u4 = R(4);
        const int li = min((int)(u4 * (float)tb.n_lights), tb.n_lights - 1);
        lam = cosd;
        if (!(u3 < 0.5f)) lam = light_sample(tb.lt + li * LT_COLS, p, R(5),
                                              R(6));
        const V3 nd = normalize(lam);
        const float cos_pdf = jmax(dot3(nd, bw) / PI_F, 0.f);
        float pdf_sum = 0.f;
        for (int l = 0; l < tb.n_lights; ++l)
          pdf_sum = pdf_sum + light_pdf(tb.lt + l * LT_COLS, p, lam);
        pdf = 0.5f * cos_pdf + 0.5f * pdf_sum / (float)tb.n_lights;
      } else {
        lam = cosd;
        const V3 nd = normalize(lam);
        pdf = jmax(dot3(nd, bw) / PI_F, 0.f);
      }
      pdf = pdf > PDF_FLOOR ? pdf : PDF_FLOOR;
      const float spdf = jmax(dot3(nrm, normalize(lam)) / PI_F, 0.f);
      const float lam_w = spdf / pdf;
      wtx = ax * lam_w;
      wty = ay * lam_w;
      wtz = az * lam_w;
      dr = lam;
    } else if (mkind == MAT_METAL || mkind == MAT_DIELECTRIC) {
      const V3 ud = normalize(d);
      const float dn2 = 2.f * dot3(ud, nrm);
      const V3 r = {ud.x - dn2 * nrm.x, ud.y - dn2 * nrm.y,
                    ud.z - dn2 * nrm.z};
      if (mkind == MAT_METAL) {
        const V3 fb = ball(R(9), R(10), R(11), R(7));
        const V3 m = {r.x + fuzz * fb.x, r.y + fuzz * fb.y,
                      r.z + fuzz * fb.z};
        alive_f = dot3(m, nrm) > 0.f;
        wtx = ax;
        wty = ay;
        wtz = az;
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
        dr = do_refl ? r
                     : V3{po.x - sk * no.x, po.y - sk * no.y,
                          po.z - sk * no.z};
        wtx = wty = wtz = 1.f;
      }
    } else if (mkind == MAT_ISOTROPIC) {
      dr = ball(R(12), R(13), R(14), R(8));
      wtx = ax;
      wty = ay;
      wtz = az;
    } else if (mkind == MAT_LIGHT) {
      if (d_dot_n < 0.f) {
        emx = ax;
        emy = ay;
        emz = az;
      }
      alive_f = false;
    }

    // ---- estimator update (pallas_bounce._bounce_plane_core) -----------
    Lx = Lx + bx * emx;
    Ly = Ly + by * emy;
    Lz = Lz + bz * emz;
    bx = bx * wtx;
    by = by * wty;
    bz = bz * wtz;
    if (alive_f) {
      ox = p.x;
      oy = p.y;
      oz = p.z;
      dx = dr.x;
      dy = dr.y;
      dz = dr.z;
      alive = 1.f;
    } else {
      alive = 0.f;
    }
  }

  if (!in) return;
  const float out[14] = {ox, oy, oz, dx, dy, dz, time, alive,
                         Lx, Ly, Lz, bx, by, bz};
#pragma unroll
  for (int c = 0; c < 14; ++c) stf[(size_t)c * n + i] = out[c];
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// st0 [14, n] and stf [14, n] are structure-of-arrays float32 planes,
// rnd [depth, 15, n]; n is a multiple of 128 (each chunk is padded to 1024
// rays). The tables are those of ops/uber.py:make_ctx. hist [depth, 14, n]
// float32, kind and idx [depth, n] int32 are the backward's residuals,
// written only when hist is not null.
extern "C" int trace_wave_launch(
    const float* st0, const float* rnd, const float* uni,
    const float* det_t, const float* u_t, const float* v_t,
    const float* t_t, const float* dbl_t, const float* sph,
    const float* quad, const float* cab, const float* lt, float* stf,
    float* hist, int* kind, int* idx, int n,
    int depth, int w, int n_tri_chunks, int n_sph, int n_quad, int t_off,
    int s_off, int q_off, int n_lights, int has_checker, void* stream) {
  Tables tb{uni, det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, lt,
            w, n_tri_chunks, n_sph, n_quad, t_off, s_off, q_off, n_lights,
            has_checker};
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    trace_wave_kernel<<<blocks, ROW, 0, static_cast<cudaStream_t>(stream)>>>(
        st0, rnd, tb, stf, hist, kind, idx, n, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
