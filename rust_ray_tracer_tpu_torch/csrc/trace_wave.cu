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
// The same body, trace_rays, is kernel D too: one uber bounce, replacing
// pallas_uber.py _make_fused_kernel (:568, launched by _fused_impl, :724),
// which the per-chunk path (ops/integrator.trace_rays, the sharded
// renderer's body) runs once a bounce. Its plain version is
// ops/uber.py:fused_bounce_plain. D is launched with depth 1 as a launch
// argument, so its loop is A's, instruction for instruction, and a chain
// of D launches gives A's bits; it writes the winners (kind, idx) for its
// backward D' and no copy of its input state, which the caller holds. Per
// bounce it moves A's bytes: 14 state floats in and out and 15 randoms.
//
// Its phase 1, closest_hit, is kernel E too: the search alone with the
// winner's row of the table fetched, replacing pallas_uber.py
// _make_select_kernel (:346, launched by _select_impl, :392), which the
// unfused uber bounce (RRT_NO_UBER_FUSED=1) runs before kernel G
// (split.cu). Its plain version is ops/uber.py:select_plain. It shares A's
// library and flags, so its winners are D's bit for bit on the same state.
// The TPU fetched the row by a one-hot matrix product; here a found ray
// reads uni[row] and a miss the default row. It reads 8 state floats a ray
// and writes w + 2 words, and its time is A's sweep for one bounce.
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
//     same values the plain version selects out of all kinds. They are the
//     device functions of trace_common.cuh (hit_attrs, shade, update_found)
//     that the split route's kernels J and H (split.cu) run on their own;
//   * a scene with Noise textures runs the HAS_NOISE instantiation, which
//     loads the Perlin tables into shared memory once per block and
//     evaluates the marble (TPU kernel C, trace_common.cuh) only where a
//     found ray's winner has the noise flag. It is built into a library of
//     its own (-DTRACE_WAVE_NOISE=1) with --fmad=false, so it rounds as its
//     plain version: the marble moves ~50 per unit of the hit point, and an
//     FMA's last ulp of a far hit point would move the pixel. The library
//     without the define holds only the other instantiation, the kernel
//     without noise, instruction for instruction.
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
  const float* perlin_vec;   // [256, 3] (noise scenes)
  const int* perlin_perm;    // [3, 256]
  int w, n_tri_chunks, n_sph, n_quad, t_off, s_off, q_off, n_lights,
      has_checker;
};

// Phase 1 (pallas_uber._search_row): the closest hit of the ray (o, d) at
// ``time``, the body of kernel E and of A's and D's bounce. Every thread of
// the block calls it together: the per-(row, chunk) cull is a block-wide
// vote. A dead ray (live_in false) takes part in the votes with an empty
// window (tmax -1) and finds nothing. The winner's row is 0 on a miss.
struct Winner {
  float t;
  int k, i;
};

__device__ __forceinline__ Winner
closest_hit(const Tables& tb, V3 o, V3 d, float time, bool live_in) {
  const float tmin = T_MIN;
  const float tmax = live_in ? INFINITY : -1.f;
  const float ox = o.x, oy = o.y, oz = o.z, dx = d.x, dy = d.y, dz = d.z;
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
  if (!live_in) return {INFINITY, KIND_NONE, 0};
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
    const float qa = ((wy * vz - wz * vy) * wnx +
                      (wz * vx - wx * vz) * wny +
                      (wx * vy - wy * vx) * wnz) * inv_n2;
    const float qb = ((uy * wz - uz * wy) * wnx +
                      (uz * wx - ux * wz) * wny +
                      (ux * wy - uy * wx) * wnz) * inv_n2;
    const bool valid = fabsf(denom) > 0.f && t >= tmin && t <= tmax &&
                       qa >= 0.f && qa <= 1.f && qb >= 0.f && qb <= 1.f;
    if (valid && t < best_t) {
      best_t = t;
      best_k = KIND_QUAD;
      best_i = tb.q_off + k;
    }
  }
  return {best_t, best_k, best_k == KIND_NONE ? 0 : best_i};
}

// ``depth`` bounces of the block's 128 rays from st0 into stf, the body of
// kernels A and D. With hist, bounce b's input state goes to hist[b]; with
// kind_out / idx_out, its winner (kind, row; 0 on a miss) to [b].
template <bool HAS_NOISE>
__device__ __forceinline__ void
trace_rays(const float* __restrict__ st0, const float* __restrict__ rnd,
           const Tables& tb, float* __restrict__ stf,
           float* __restrict__ hist, int* __restrict__ kind_out,
           int* __restrict__ idx_out, int n, int depth) {
  extern __shared__ float perlin_smem[];     // PERLIN_SMEM bytes if noise
  Perlin perlin{nullptr, nullptr};
  if constexpr (HAS_NOISE) {                 // before any vote or break
    perlin = perlin_load(perlin_smem, tb.perlin_vec, tb.perlin_perm);
    __syncthreads();
  }
  const int i = blockIdx.x * ROW + threadIdx.x;
  const bool in = i < n;
  float s[14];
#pragma unroll
  for (int c = 0; c < 14; ++c) s[c] = in ? st0[(size_t)c * n + i] : 0.f;
  V3 o = {s[0], s[1], s[2]}, d = {s[3], s[4], s[5]};
  const float time = s[6];
  float alive = s[7];
  V3 L = {s[8], s[9], s[10]}, beta = {s[11], s[12], s[13]};
  const float* __restrict__ bg = tb.lt + tb.n_lights * LT_COLS;

  // the backward's residuals (pallas_uber.py:887-916), when asked for:
  // bounce b's input state, and its winner (kind, row), 0 on a miss
  const bool keep_st = hist != nullptr && in;
  const bool keep_win = kind_out != nullptr && in;
  auto save_state = [&](int b) {
    const float st[14] = {o.x, o.y, o.z, d.x, d.y, d.z, time, alive,
                          L.x, L.y, L.z, beta.x, beta.y, beta.z};
#pragma unroll
    for (int c = 0; c < 14; ++c) hist[((size_t)b * 14 + c) * n + i] = st[c];
  };
  auto save_winner = [&](int b, int k, int row) {
    kind_out[(size_t)b * n + i] = k;
    idx_out[(size_t)b * n + i] = row;
  };

  for (int b = 0; b < depth; ++b) {
    if (keep_st) save_state(b);
    const bool live_in = alive > 0.5f;
    if (!__syncthreads_or(live_in)) {        // the whole row is dead:
      for (int bb = b; bb < depth; ++bb) {   // the state stands still
        if (keep_st && bb > b) save_state(bb);
        if (keep_win) save_winner(bb, KIND_NONE, 0);
      }
      break;
    }
    const Winner win = closest_hit(tb, o, d, time, live_in);
    if (!live_in) {           // a dead ray passes its state through
      if (keep_win) save_winner(b, KIND_NONE, 0);
      continue;
    }
    const float tmin = T_MIN, tmax = INFINITY;
    const int best_k = win.k, best_i = win.i;
    if (keep_win) save_winner(b, best_k, best_i);

    // ---- miss: background, the path ends -------------------------------
    if (best_k == KIND_NONE) {
      update_miss(bg, L, beta, alive);
      continue;
    }

    // ---- winner row (pallas_uber._tile_core plane assembly) ------------
    const float* row = tb.uni + (size_t)best_i * tb.w;
    const bool flip = row[9] > 0.5f;
    const float* att = row + A_COL;
    const int mkind = (int)att[0];
    const float fuzz = att[1], ior = att[2];
    float ax = att[3], ay = att[4], az = att[5];

    // ---- hit attributes (pallas_hit._hit_plane_core, winner's kind) ----
    const HitAttrs h = hit_attrs(best_k, o, d, time, tmin, tmax, row, 0.f,
                                 flip);
    const V3 p = h.p;

    if (tb.has_checker && att[12] > 0.5f) {
      // checker (texture.rs:50-57): the sin-product sign picks the leaf
      const float sines = sinf(10.f * p.x) * sinf(10.f * p.y) *
                          sinf(10.f * p.z);
      const float* leaf = sines < 0.f ? att + 9 : att + 6;
      ax = leaf[0];
      ay = leaf[1];
      az = leaf[2];
    }
    if constexpr (HAS_NOISE) {
      // marble (texture.rs:74-82) at the hit point, in all three channels
      const float* nz = att + (tb.has_checker ? 13 : 6);   // scale, flag
      if (nz[1] > 0.5f) ax = ay = az = marble(perlin, p, nz[0]);
    }

    // ---- shading (pallas_shade._plane_core, winner's material) and the
    // estimator update (pallas_bounce._bounce_plane_core) ----------------
    const Scatter sc = shade(mkind, d, h.n, p, {ax, ay, az}, fuzz, ior,
                             tb.lt, tb.n_lights,
                             rnd + (size_t)b * 15 * n + i, (size_t)n);
    update_found(sc, p, o, d, L, beta, alive);
  }

  if (!in) return;
  const float out[14] = {o.x, o.y, o.z, d.x, d.y, d.z, time, alive,
                         L.x, L.y, L.z, beta.x, beta.y, beta.z};
#pragma unroll
  for (int c = 0; c < 14; ++c) stf[(size_t)c * n + i] = out[c];
}

// Kernel A: every bounce of the wave, the residuals when hist is not null.
template <bool HAS_NOISE>
__global__ void __launch_bounds__(ROW)
trace_wave_kernel(const float* __restrict__ st0,
                  const float* __restrict__ rnd, const Tables tb,
                  float* __restrict__ stf, float* __restrict__ hist,
                  int* __restrict__ kind_out, int* __restrict__ idx_out,
                  int n, int depth) {
  trace_rays<HAS_NOISE>(st0, rnd, tb, stf, hist, kind_out, idx_out, n,
                        depth);
}

// Kernel D: one bounce (the caller passes depth 1, a launch argument, so
// the loop is A's instruction for instruction) of the lanes of one or
// more whole chunks, with its winners, and no copy of the input state.
template <bool HAS_NOISE>
__global__ void __launch_bounds__(ROW)
fused_bounce_kernel(const float* __restrict__ st,
                    const float* __restrict__ rnd, const Tables tb,
                    float* __restrict__ st2, int* __restrict__ kind_out,
                    int* __restrict__ idx_out, int n, int depth) {
  trace_rays<HAS_NOISE>(st, rnd, tb, st2, nullptr, kind_out, idx_out, n,
                        depth);
}

// Kernel E: phase 1 alone, for the unfused bounce (RRT_NO_UBER_FUSED=1):
// each ray's winner (kind, row; 0 on a miss and for a dead ray) and the
// winner's row of uni, or dflt on a miss, as W planes. A block is one
// 128-ray row of A, with A's cull votes; a row with no live ray, so every
// row of a tile with none, writes kind 0, row 0 and dflt without a search
// (the dead tile of pallas_uber._make_select_kernel, :357-362). The
// variant without noise only: under that flag a noise scene takes the
// split route (pallas_uber.py:1261-1262).
__global__ void __launch_bounds__(ROW)
select_kernel(const float* __restrict__ st, const Tables tb,
              const float* __restrict__ dflt, float* __restrict__ selv,
              int* __restrict__ kind_out, int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * ROW + threadIdx.x;
  const bool in = i < n;
  float s[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s[c] = in ? st[(size_t)c * n + i] : 0.f;
  const bool live_in = s[7] > 0.5f;
  Winner win{INFINITY, KIND_NONE, 0};
  if (__syncthreads_or(live_in))
    win = closest_hit(tb, {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, s[6],
                      live_in);
  if (!in) return;
  kind_out[i] = win.k;
  idx_out[i] = win.i;
  const float* __restrict__ row =
      win.k == KIND_NONE ? dflt : tb.uni + (size_t)win.i * tb.w;
  for (int c = 0; c < tb.w; ++c) selv[(size_t)c * n + i] = row[c];
}

#ifdef TRACE_WAVE_NOISE
constexpr bool kNoise = true;    // the noise variant's library
#else
constexpr bool kNoise = false;
#endif

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// st0 [14, n] and stf [14, n] are structure-of-arrays float32 planes,
// rnd [depth, 15, n]; n is a multiple of 128 (each chunk is padded to 1024
// rays). The tables are those of ops/uber.py:make_ctx. hist [depth, 14, n]
// float32, kind and idx [depth, n] int32 are the backward's residuals,
// written only when hist is not null. has_noise must name this library's
// variant (-1 otherwise); the noise variant reads perlin_vec [256, 3] and
// perlin_perm [3, 256].
extern "C" int trace_wave_launch(
    const float* st0, const float* rnd, const float* uni,
    const float* det_t, const float* u_t, const float* v_t,
    const float* t_t, const float* dbl_t, const float* sph,
    const float* quad, const float* cab, const float* lt, float* stf,
    float* hist, int* kind, int* idx, int n,
    int depth, int w, int n_tri_chunks, int n_sph, int n_quad, int t_off,
    int s_off, int q_off, int n_lights, int has_checker,
    const float* perlin_vec, const int* perlin_perm, int has_noise,
    void* stream) {
  Tables tb{uni, det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, lt,
            perlin_vec, perlin_perm, w, n_tri_chunks, n_sph, n_quad, t_off,
            s_off, q_off, n_lights, has_checker};
  if ((has_noise != 0) != kNoise) return -1;   // the other library's
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    trace_wave_kernel<kNoise><<<blocks, ROW, kNoise ? PERLIN_SMEM : 0,
                                static_cast<cudaStream_t>(stream)>>>(
        st0, rnd, tb, stf, hist, kind, idx, n, depth);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch kernel D on ``stream``; returns cudaGetLastError() (0 =
// launched). st and st2 [14, n], rnd [15, n] float32 (this bounce's 9
// uniforms and 6 normals); kind and idx [n] int32, written for every lane
// (0 on a miss and for a dead ray). n is a multiple of 128; the tables and
// the noise arguments are trace_wave_launch's.
extern "C" int fused_bounce_launch(
    const float* st, const float* rnd, const float* uni, const float* det_t,
    const float* u_t, const float* v_t, const float* t_t,
    const float* dbl_t, const float* sph, const float* quad,
    const float* cab, const float* lt, float* st2, int* kind, int* idx,
    int n, int w, int n_tri_chunks, int n_sph, int n_quad, int t_off,
    int s_off, int q_off, int n_lights, int has_checker,
    const float* perlin_vec, const int* perlin_perm, int has_noise,
    void* stream) {
  Tables tb{uni, det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, lt,
            perlin_vec, perlin_perm, w, n_tri_chunks, n_sph, n_quad, t_off,
            s_off, q_off, n_lights, has_checker};
  if ((has_noise != 0) != kNoise || kind == nullptr || idx == nullptr)
    return -1;
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    fused_bounce_kernel<kNoise><<<blocks, ROW, kNoise ? PERLIN_SMEM : 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        st, rnd, tb, st2, kind, idx, n, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch kernel E on ``stream``; returns cudaGetLastError() (0 =
// launched), or -1 in the noise variant's library, which launches no E.
// st [8, n] float32 (o, d, time, alive), n a multiple of 128; dflt [w] the
// miss default; selv [w, n] float32, kind and idx [n] int32, written for
// every lane. The tables are trace_wave_launch's (no light table).
extern "C" int select_launch(
    const float* st, const float* uni, const float* dflt,
    const float* det_t, const float* u_t, const float* v_t,
    const float* t_t, const float* dbl_t, const float* sph,
    const float* quad, const float* cab, float* selv, int* kind, int* idx,
    int n, int w, int n_tri_chunks, int n_sph, int n_quad, int t_off,
    int s_off, int q_off, void* stream) {
  if (kNoise) return -1;
  Tables tb{uni, det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, nullptr,
            nullptr, nullptr, w, n_tri_chunks, n_sph, n_quad, t_off,
            s_off, q_off, 0, 0};
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    select_kernel<<<blocks, ROW, 0, static_cast<cudaStream_t>(stream)>>>(
        st, tb, dflt, selv, kind, idx, n);
  }
  return static_cast<int>(cudaGetLastError());
}
