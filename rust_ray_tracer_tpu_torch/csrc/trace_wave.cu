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
// What bounds A, D and E on the card: the triangle sweep of closest_hit,
// four 10-term Plücker dots and a division per ray x triangle of every
// chunk a ray's row enters (random's 1,024 sphere rows on the noise
// scenes). Memory traffic is small (14 state floats in, 15 randoms a
// bounce, 14 out; the scene tables, a few hundred KB, stay on chip), so
// the sweep is bound by the instructions a warp issues for each test.
// Measured, the port's first sweep was slower than that for three
// reasons: each test read its 41 floats as 41 scalar loads from a table
// the resident blocks thrashed out of L1; a row's warps each ran the
// whole sweep for as few as one live lane, so a bounce with 1% of its
// rays alive took as long as the first; and one warp walked a row's 1,024
// triangles alone, a chain of dependent loads and dots.
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
//   * live-ray compaction: a row that is not full packs its live rays,
//     by a ballot and a prefix over the block's four warps, into the
//     first n_live slots of shared memory (o, d, time); the first
//     ceil(n_live / 32) warps sweep them and write each winner back to its
//     slot, where the ray's own thread takes it. The vote is the OR of the
//     same live rays' slab tests, so the same chunks are swept. The rays
//     never leave their block: no global permutation, and the backward's
//     residual layout is unchanged. A full row sweeps in place;
//   * parts: a row of at most 64 live rays gives the warps past its packed
//     ones the same rays and a part of the triangles, spheres and quads
//     each (every 4th or 2nd row), so no warp idles and a sparse bounce's
//     chain is a quarter or half of the sweep. Each part keeps the least
//     (t, kind, row) of its rows, and the ray's part-0 thread merges them:
//     the sequential sweep (strict <, triangles, spheres, quads in row
//     order) takes exactly that least candidate, so the winner's bits and
//     ties are the sweep's;
//   * packed tables, 16-byte loads: tri [Tp, 44] = det | u | v | t | dbl |
//     3 pad, sph and quad [*, 12] (ops/uber._search_tables; the plain
//     versions read column views of the same tensors, the scene's only
//     search tables). Each 64-triangle tile of an entered chunk is staged
//     in dynamic shared memory by the whole block (cp.async, 11 KB), so
//     the sweep reads no row from L1 or L2; every lane of a warp reads the
//     same row, a broadcast. Spheres and quads are three float4 loads a
//     row. A scene without triangles stages nothing and keeps its L1;
//   * a test stops as soon as the ray cannot take the row: a triangle's
//     face it does not see (dbl read only for a back face), t out of the
//     window or not below its best (det and t computed together), then u
//     and v; a sphere it misses (no positive discriminant: no root); a
//     quad whose t cannot win. The same values, compared in another
//     order, so the same winner;
//   * no tensor cores: the tests are a [rays x 10] . [10 x 4T] product,
//     which the TPU ran on its matrix unit, but TF32 or bf16 would move t
//     by far more than the 0.2% that separates the Cornell lamp from the
//     ceiling (pallas_intersect.py:27-31), and no split-TF32 scheme gives
//     fp32's bits: the dots stay on the fp32 pipes;
//   * A and D are held to 64 registers (__launch_bounds__(128, 8)), eight
//     resident blocks an SM: a little spill in D's shading costs less than
//     the two blocks a 72-register build loses. The noise variant is held
//     to 56 (nine blocks, a wave's 1,152 rows in one round on 132 SMs):
//     its bounce is random's sphere sweep, which the second round of
//     eight blocks an SM held back;
//   * the chunk loop stops at the real chunk count (an all-pad chunk's
//     inverted box would pass the slab test);
//   * a block leaves the bounce loop once all its rays are dead (one
//     __syncthreads_count a bounce gives both that and a full row);
//   * only the winner's hit attributes and material are evaluated: the
//     same values the plain version selects out of all kinds. They are the
//     device functions of trace_common.cuh (hit_attrs, shade, update_found)
//     that the split route's kernels J and H (split.cu) run on their own;
//   * a scene with Noise textures runs the HAS_NOISE instantiation, which
//     loads the Perlin tables into shared memory once per block and
//     evaluates the marble (TPU kernel C, trace_common.cuh) only where a
//     found ray's winner has the noise flag. It is built into a library of
//     its own (-DTRACE_WAVE_NOISE=1); the library without the define holds
//     only the other instantiation, the kernel without noise, instruction
//     for instruction.
//
// Both libraries are built with --fmad=false, as every library of the
// port is, so each product and sum rounds as the plain version's does:
// the winners are the plain version's, and the shading rounds as kernel
// G's (split.cu), so the unfused bounce's image is the fused one's. The
// marble moves ~50 per unit of the hit point, so an FMA's last ulp of a
// far hit point would move a pixel. No fast-math: __sinf would flip
// checker parities and approximate division would move t; CUDA's
// sinf/cosf/expf/logf still differ from the host's by an ulp. Comparisons
// are written out (jmax/jmin propagate NaN like jnp.maximum/minimum):
// fminf/fmaxf drop NaN, and the sphere table's far pad rows rely on a NaN
// discriminant to be rejected. No float atomics.
//
// Tie rules: triangles sweep ascending ids with strict < (the lowest id
// wins a tie in t), then spheres, then quads, each with strict <, so a tie
// goes triangle > sphere > quad. A miss has kind 0 and row 0.

#include <cuda_pipeline.h>

#include "trace_common.cuh"

namespace {

using namespace trace;

constexpr int TRI_PACK = 44;         // floats a packed triangle row
constexpr int PRIM_PACK = 12;        // floats a packed sphere or quad row
constexpr int WARPS = ROW / 32;
constexpr int TT = 64;               // triangles a staged tile
constexpr int TILE_F4 = TT * TRI_PACK / 4;
static_assert(TCC % TT == 0, "a chunk is whole tiles");
// A's and D's resident blocks an SM (__launch_bounds__): 8 at 64
// registers; the noise variant, whose sweep is random's sphere rows, 9 at
// 56, so a 1,152-row wave runs in one round
#ifdef TRACE_WAVE_NOISE
constexpr int MIN_BLOCKS = 9;
#else
constexpr int MIN_BLOCKS = 8;
#endif

struct Tables {
  const float* uni;   // [P, w] winner rows
  const float* tri;   // [Tp, 44] det | u | v | t (10 each) | dbl | 3 pad
  const float* sph;   // [S, 12] c0, c1-c0, t0, 1/(t1-t0), r | 3 pad
  const float* quad;  // [Q, 12] q, u, v | 3 pad
  const float* cab;   // [chunks, 8] lo3, hi3, 0, 0
  const float* lt;    // [n_lights + 1, LT_COLS]; last row = background
  const float* perlin_vec;   // [256, 3] (noise scenes)
  const int* perlin_perm;    // [3, 256]
  int w, n_tri_chunks, n_sph, n_quad, t_off, s_off, q_off, n_lights,
      has_checker;
};

// A search's best candidate: t, kind (0: none) and global row.
struct Best {
  float t;
  int k, i;
};

// Is a before b in the sequential sweep's order? The sweep takes a
// candidate only with a strictly smaller t, in the order triangles by
// ascending row, spheres, quads, so its winner is the least (t, kind,
// row); a none (t = inf) is never before a candidate.
__device__ __forceinline__ bool before(const Best& a, const Best& b) {
  return a.t < b.t ||
         (a.t == b.t && a.k != KIND_NONE &&
          (b.k == KIND_NONE || a.k < b.k || (a.k == b.k && a.i < b.i)));
}

// The block's dynamic shared memory: a tile of the packed triangle table
// when the scene has triangles (tile_bytes), then the Perlin tables of
// the noise variant (PERLIN_SMEM bytes).
__device__ __forceinline__ float4* dyn_smem() {
  extern __shared__ float4 trace_dyn_smem[];
  return trace_dyn_smem;
}
__host__ __device__ __forceinline__ int tile_bytes(int n_tri_chunks) {
  return n_tri_chunks > 0 ? TILE_F4 * 16 : 0;
}

// The block's static shared memory of closest_hit: the live rays per
// warp, the packed rays, each thread's part of a winner and the merged
// winners.
struct SearchSmem {
  int warp_live[WARPS];
  float ray[7][ROW];                 // o, d, time of the packed rays
  Best part[ROW];
  int win_k[ROW], win_i[ROW];
};

// A ray of the sweep: origin, direction, time, the Plücker features
// o x d, the determinant's epsilon, the inverse direction of the slab
// test and the best candidate so far.
struct SweepRay {
  float ox, oy, oz, dx, dy, dz, time, cx, cy, cz, eps, ivx, ivy, ivz;
  Best best;
};

__device__ __forceinline__ SweepRay sweep_ray(V3 o, V3 d, float time) {
  SweepRay q;
  q.ox = o.x;
  q.oy = o.y;
  q.oz = o.z;
  q.dx = d.x;
  q.dy = d.y;
  q.dz = d.z;
  q.time = time;
  q.cx = q.oy * q.dz - q.oz * q.dy;
  q.cy = q.oz * q.dx - q.ox * q.dz;
  q.cz = q.ox * q.dy - q.oy * q.dx;
  q.eps = TRI_DET_EPS * sqrtf(q.dx * q.dx + q.dy * q.dy + q.dz * q.dz);
  q.ivx = 1.f / (fabsf(q.dx) < 1e-30f ? 1e-30f : q.dx);
  q.ivy = 1.f / (fabsf(q.dy) < 1e-30f ? 1e-30f : q.dy);
  q.ivz = 1.f / (fabsf(q.dz) < 1e-30f ? 1e-30f : q.dz);
  q.best = {INFINITY, KIND_NONE, 0};
  return q;
}

// A 10-term dot of a coefficient row with the ray's features [o, d,
// o x d, 1], summed left to right, as trace_common.cuh's dot10 and the
// plain version's tri_tests sum it.
__device__ __forceinline__ float dot10r(const float (&c)[10],
                                        const SweepRay& q) {
  const float f[10] = {q.ox, q.oy, q.oz, q.dx, q.dy, q.dz,
                       q.cx, q.cy, q.cz, 1.f};
  float acc = c[0] * f[0];
#pragma unroll
  for (int k = 1; k < 10; ++k) acc = acc + c[k] * f[k];
  return acc;
}

// Does the ray enter the cull box (lo3, hi3) of box[0..5] within
// [T_MIN, inf)? The slab test of the per-(row, chunk) vote.
__device__ __forceinline__ bool enters(const float* box, const SweepRay& q) {
  const float t0x = (box[0] - q.ox) * q.ivx, t1x = (box[3] - q.ox) * q.ivx;
  const float t0y = (box[1] - q.oy) * q.ivy, t1y = (box[4] - q.oy) * q.ivy;
  const float t0z = (box[2] - q.oz) * q.ivz, t1z = (box[5] - q.oz) * q.ivz;
  const float tn = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)),
                        jmax(jmin(t0z, t1z), T_MIN));
  const float tf = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)),
                        jmax(t0z, t1z));
  return tf >= tn;
}

// A sphere row (c0, c1 - c0, t0, 1 / (t1 - t0), r) as three float4: the
// nearer root in [T_MIN, inf), inf for none. A ray that misses (a far pad
// row's NaN discriminant too) stops before the root: its t would be inf.
__device__ __forceinline__ float sphere_t(float4 s0, float4 s1, float4 s2,
                                          const SweepRay& q) {
  const float tmin = T_MIN, tmax = INFINITY;
  const float frac = (q.time - s1.z) * s1.w;
  const float cx = s0.x + frac * s0.w;
  const float cy = s0.y + frac * s1.x;
  const float cz = s0.z + frac * s1.y;
  const float ocx = q.ox - cx, ocy = q.oy - cy, ocz = q.oz - cz;
  const float a = q.dx * q.dx + q.dy * q.dy + q.dz * q.dz;
  const float bq = ocx * q.dx + ocy * q.dy + ocz * q.dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - s2.x * s2.x;
  const float disc = bq * bq - a * cc;
  if (!(disc > 0.f)) return INFINITY;
  const float sq = sqrtf(jmax(disc, 1e-12f));   // x 1.f when disc > 0
  const float inv_a = 1.f / jmax(a, 1e-12f);
  const float root1 = (-bq - sq) * inv_a;
  const float root2 = (-bq + sq) * inv_a;
  const bool ok1 = root1 >= tmin && root1 <= tmax;
  const bool ok2 = root2 >= tmin && root2 <= tmax;
  return ok1 ? root1 : (ok2 ? root2 : INFINITY);
}

// A quad row (q, u, v) as three float4: t of the hit inside it in
// [T_MIN, inf) when it is below the ray's best, else inf. A t that cannot
// win stops the test before the point's coordinates.
__device__ __forceinline__ float quad_t(float4 q0, float4 q1, float4 q2,
                                        const SweepRay& q) {
  const float tmin = T_MIN, tmax = INFINITY;
  const float ox = q.ox, oy = q.oy, oz = q.oz;
  const float dx = q.dx, dy = q.dy, dz = q.dz;
  const float qx = q0.x, qy = q0.y, qz = q0.z;
  const float ux = q0.w, uy = q1.x, uz = q1.y;
  const float vx = q1.z, vy = q1.w, vz = q2.x;
  const float wnx = uy * vz - uz * vy;
  const float wny = uz * vx - ux * vz;
  const float wnz = ux * vy - uy * vx;
  const float denom = dx * wnx + dy * wny + dz * wnz;
  const float dsafe = fabsf(denom) < 1e-12f
                          ? (denom < 0.f ? -1e-12f : 1e-12f) : denom;
  const float t = ((qx - ox) * wnx + (qy - oy) * wny +
                   (qz - oz) * wnz) / dsafe;
  if (!(fabsf(denom) > 0.f && t >= tmin && t <= tmax && t < q.best.t))
    return INFINITY;
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
  const bool inside = qa >= 0.f && qa <= 1.f && qb >= 0.f && qb <= 1.f;
  return inside ? t : INFINITY;
}

// The sweep of the ray q (when ``mine``) over part g of ``parts`` of the
// triangles, spheres and quads (every parts-th from the g-th): its least
// (t, kind, row) there, in q.best (pallas_uber._search_row's tests).
// Every thread of the block calls it together: each tile of an entered
// chunk is staged in shared memory (cp.async, every thread a share), and
// the per-(row, chunk) cull is a block-wide vote in which the part-0
// thread of each ray votes. A triangle test stops as soon as the ray
// cannot take it (a face it does not see, t out of the window or not
// below its best, then u and v): the same values compared in another
// order.
__device__ __forceinline__ void
sweep(const Tables& tb, SweepRay& q, bool mine, int g, int parts) {
  const float4* __restrict__ tri = reinterpret_cast<const float4*>(tb.tri);
  float4* tile = dyn_smem();
  for (int c = 0; c < tb.n_tri_chunks; ++c) {
    if (!__syncthreads_or(mine && g == 0 && enters(tb.cab + c * 8, q)))
      continue;
    for (int j0 = c * TCC; j0 < (c + 1) * TCC; j0 += TT) {
      const float4* __restrict__ src = tri + (size_t)j0 * (TRI_PACK / 4);
      for (int k = threadIdx.x; k < TILE_F4; k += ROW)
        __pipeline_memcpy_async(tile + k, src + k, sizeof(float4));
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (mine) {
        for (int jj = g; jj < TT; jj += parts) {
          const float4* r = tile + jj * (TRI_PACK / 4);
          const float4 r0 = r[0], r1 = r[1], r2 = r[2];
          const float4 r7 = r[7], r8 = r[8], r9 = r[9];
          const float cd[10] = {r0.x, r0.y, r0.z, r0.w, r1.x,
                                r1.y, r1.z, r1.w, r2.x, r2.y};
          const float ct[10] = {r7.z, r7.w, r8.x, r8.y, r8.z,
                                r8.w, r9.x, r9.y, r9.z, r9.w};
          const float dm = dot10r(cd, q);
          const float tm = dot10r(ct, q);
          if (!(dm > q.eps || (dm < -q.eps && r[10].x > 0.5f))) continue;
          const float inv = 1.f / (fabsf(dm) > q.eps ? dm : 1.f);
          const float t = tm * inv;
          if (!(t >= T_MIN && t <= INFINITY && t < q.best.t)) continue;
          const float4 r3 = r[3], r4 = r[4], r5 = r[5], r6 = r[6];
          const float cu[10] = {r2.z, r2.w, r3.x, r3.y, r3.z,
                                r3.w, r4.x, r4.y, r4.z, r4.w};
          const float cv[10] = {r5.x, r5.y, r5.z, r5.w, r6.x,
                                r6.y, r6.z, r6.w, r7.x, r7.y};
          const float u = dot10r(cu, q) * inv;
          const float v = dot10r(cv, q) * inv;
          if (!(u >= 0.f && u <= 1.f && v >= 0.f && v < 1.f - u)) continue;
          q.best = {t, KIND_TRI, tb.t_off + j0 + jj};
        }
      }
      __syncthreads();                       // before the next tile
    }
  }
  if (!mine) return;
  // spheres, then quads, from the k0-th every step-th: a row without parts
  // runs the loops with a step the compiler knows
  const float4* __restrict__ sph = reinterpret_cast<const float4*>(tb.sph);
  const float4* __restrict__ quad = reinterpret_cast<const float4*>(tb.quad);
  auto prims = [&](int k0, int step) {
    for (int k = k0; k < tb.n_sph; k += step) {
      const float4* sp = sph + k * (PRIM_PACK / 4);
      const float t = sphere_t(sp[0], sp[1], sp[2], q);
      if (t < q.best.t) q.best = {t, KIND_SPH, tb.s_off + k};
    }
    for (int k = k0; k < tb.n_quad; k += step) {
      const float4* qd = quad + k * (PRIM_PACK / 4);
      const float t = quad_t(qd[0], qd[1], qd[2], q);
      if (t < q.best.t) q.best = {t, KIND_QUAD, tb.q_off + k};
    }
  };
  if (parts == 1)
    prims(0, 1);
  else
    prims(g, parts);
}

// Phase 1 (pallas_uber._search_row): the closest hit (kind, row; 0, 0 on a
// miss and for a dead ray) of the ray (o, d) at ``time``, the body of
// kernel E and of A's and D's bounce, for a row of n_live > 0 live rays
// (live_in; the caller's __syncthreads_count). Every thread of the block
// calls it together. A full row sweeps its rays where they are. Else the
// live rays are packed, in thread order, into the first n_live slots of
// shared memory, and the first groups = ceil(n_live / 32) warps sweep
// them; a row of at most 64 gives the warps past them the same rays and a
// part of the triangles, spheres and quads each (4 / groups parts), and a
// ray's part-0 thread merges the parts' least (t, kind, row), the
// sequential sweep's winner.
__device__ __forceinline__ void
closest_hit(const Tables& tb, int n_live, V3 o, V3 d, float time,
            bool live_in, int& win_k, int& win_i) {
  if (n_live == ROW) {
    SweepRay q = sweep_ray(o, d, time);
    sweep(tb, q, true, 0, 1);
    win_k = q.best.k;
    win_i = q.best.k == KIND_NONE ? 0 : q.best.i;
    return;
  }
  __shared__ SearchSmem sm;
  const int s = threadIdx.x, lane = s & 31, warp = s >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, live_in);
  if (lane == 0) sm.warp_live[warp] = __popc(m);
  __syncthreads();
  int slot = __popc(m & ((1u << lane) - 1u));
#pragma unroll
  for (int w = 0; w < WARPS; ++w) slot += w < warp ? sm.warp_live[w] : 0;
  if (live_in) {
    sm.ray[0][slot] = o.x;
    sm.ray[1][slot] = o.y;
    sm.ray[2][slot] = o.z;
    sm.ray[3][slot] = d.x;
    sm.ray[4][slot] = d.y;
    sm.ray[5][slot] = d.z;
    sm.ray[6][slot] = time;
  }
  __syncthreads();
  const int groups = (n_live + 31) >> 5;
  const int parts = groups > 2 ? 1 : WARPS / groups;
  const int g = warp / groups, r = s - g * groups * 32;
  const bool mine = g < parts && r < n_live;
  const int rr = mine ? r : 0;
  SweepRay q = sweep_ray({sm.ray[0][rr], sm.ray[1][rr], sm.ray[2][rr]},
                         {sm.ray[3][rr], sm.ray[4][rr], sm.ray[5][rr]},
                         sm.ray[6][rr]);
  sweep(tb, q, mine, g, parts);
  if (parts > 1) {
    if (mine) sm.part[s] = q.best;
    __syncthreads();
    if (mine && g == 0)
      for (int h = 1; h < parts; ++h) {
        const Best b = sm.part[s + h * groups * 32];
        if (before(b, q.best)) q.best = b;
      }
  }
  if (mine && g == 0) {
    sm.win_k[r] = q.best.k;
    sm.win_i[r] = q.best.k == KIND_NONE ? 0 : q.best.i;
  }
  __syncthreads();
  win_k = live_in ? sm.win_k[slot] : KIND_NONE;
  win_i = live_in ? sm.win_i[slot] : 0;
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
  Perlin perlin{nullptr, nullptr};
  if constexpr (HAS_NOISE) {                 // before any vote or break
    float* perlin_smem = reinterpret_cast<float*>(dyn_smem()) +
                         tile_bytes(tb.n_tri_chunks) / 4;
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
    const int n_live = __syncthreads_count(live_in);
    if (n_live == 0) {                       // the whole row is dead:
      for (int bb = b; bb < depth; ++bb) {   // the state stands still
        if (keep_st && bb > b) save_state(bb);
        if (keep_win) save_winner(bb, KIND_NONE, 0);
      }
      break;
    }
    int best_k, best_i;
    closest_hit(tb, n_live, o, d, time, live_in, best_k, best_i);
    if (!live_in) {           // a dead ray passes its state through
      if (keep_win) save_winner(b, KIND_NONE, 0);
      continue;
    }
    const float tmin = T_MIN, tmax = INFINITY;
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
__global__ void __launch_bounds__(ROW, MIN_BLOCKS)
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
__global__ void __launch_bounds__(ROW, MIN_BLOCKS)
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
  int win_k = KIND_NONE, win_i = 0;
  const int n_live = __syncthreads_count(live_in);
  if (n_live > 0)
    closest_hit(tb, n_live, {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, s[6],
                live_in, win_k, win_i);
  if (!in) return;
  kind_out[i] = win_k;
  idx_out[i] = win_i;
  const float* __restrict__ row =
      win_k == KIND_NONE ? dflt : tb.uni + (size_t)win_i * tb.w;
  for (int c = 0; c < tb.w; ++c) selv[(size_t)c * n + i] = row[c];
}

#ifdef TRACE_WAVE_NOISE
constexpr bool kNoise = true;    // the noise variant's library
#else
constexpr bool kNoise = false;
#endif

// Dynamic shared memory of a launch of A or D (E: no Perlin tables).
int dyn_bytes(int n_tri_chunks) {
  return tile_bytes(n_tri_chunks) + (kNoise ? PERLIN_SMEM : 0);
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// st0 [14, n] and stf [14, n] are structure-of-arrays float32 planes,
// rnd [depth, 15, n]; n is a multiple of 128 (each chunk is padded to 1024
// rays). The tables are those of ops/uber.py:make_ctx; tri [Tp, 44] is
// 16-byte aligned. hist [depth, 14, n]
// float32, kind and idx [depth, n] int32 are the backward's residuals,
// written only when hist is not null. has_noise must name this library's
// variant (-1 otherwise); the noise variant reads perlin_vec [256, 3] and
// perlin_perm [3, 256].
extern "C" int trace_wave_launch(
    const float* st0, const float* rnd, const float* uni, const float* tri,
    const float* sph, const float* quad, const float* cab, const float* lt,
    float* stf,
    float* hist, int* kind, int* idx, int n,
    int depth, int w, int n_tri_chunks, int n_sph, int n_quad, int t_off,
    int s_off, int q_off, int n_lights, int has_checker,
    const float* perlin_vec, const int* perlin_perm, int has_noise,
    void* stream) {
  Tables tb{uni, tri, sph, quad, cab, lt, perlin_vec, perlin_perm, w,
            n_tri_chunks, n_sph, n_quad, t_off, s_off, q_off, n_lights,
            has_checker};
  if ((has_noise != 0) != kNoise) return -1;   // the other library's
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    trace_wave_kernel<kNoise><<<blocks, ROW, dyn_bytes(n_tri_chunks),
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
    const float* st, const float* rnd, const float* uni, const float* tri,
    const float* sph, const float* quad, const float* cab, const float* lt,
    float* st2, int* kind, int* idx,
    int n, int w, int n_tri_chunks, int n_sph, int n_quad, int t_off,
    int s_off, int q_off, int n_lights, int has_checker,
    const float* perlin_vec, const int* perlin_perm, int has_noise,
    void* stream) {
  Tables tb{uni, tri, sph, quad, cab, lt, perlin_vec, perlin_perm, w,
            n_tri_chunks, n_sph, n_quad, t_off, s_off, q_off, n_lights,
            has_checker};
  if ((has_noise != 0) != kNoise || kind == nullptr || idx == nullptr)
    return -1;
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    fused_bounce_kernel<kNoise><<<blocks, ROW, dyn_bytes(n_tri_chunks),
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
    const float* st, const float* uni, const float* dflt, const float* tri,
    const float* sph, const float* quad, const float* cab, float* selv,
    int* kind, int* idx,
    int n, int w, int n_tri_chunks, int n_sph, int n_quad, int t_off,
    int s_off, int q_off, void* stream) {
  if (kNoise) return -1;
  Tables tb{uni, tri, sph, quad, cab, nullptr, nullptr, nullptr, w,
            n_tri_chunks, n_sph, n_quad, t_off, s_off, q_off, 0, 0};
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    select_kernel<<<blocks, ROW, tile_bytes(n_tri_chunks),
                    static_cast<cudaStream_t>(stream)>>>(
        st, tb, dflt, selv, kind, idx, n);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef TRACE_WAVE_NOISE
namespace {

// TPU kernel C alone: the signed octave sum (before its abs) and the
// marble at n points p [3, n] with scales scale [n], into acc [n] and
// value [n]. A probe that holds C against ops/perlin.py on the card's
// recorded hit points; no render launches it.
__global__ void __launch_bounds__(ROW) marble_probe_kernel(
    const float* __restrict__ p, const float* __restrict__ scale,
    const float* __restrict__ vec, const int* __restrict__ perm,
    float* __restrict__ acc, float* __restrict__ value, int n) {
  __shared__ float smem[PERLIN_SMEM / 4];
  const Perlin P = perlin_load(smem, vec, perm);
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
  if (i >= n) return;
  const V3 q{p[i], p[(size_t)n + i], p[2 * (size_t)n + i]};
  acc[i] = turb_acc(P, q);
  value[i] = marble(P, q, scale[i]);
}

}  // namespace

// Launch the marble probe on ``stream``; returns cudaGetLastError() (0 =
// launched). Only in the noise variant's library.
extern "C" int marble_probe_launch(const float* p, const float* scale,
                                   const float* perlin_vec,
                                   const int* perlin_perm, float* acc,
                                   float* value, int n, void* stream) {
  const int blocks = (n + ROW - 1) / ROW;
  if (blocks > 0) {
    marble_probe_kernel<<<blocks, ROW, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        p, scale, perlin_vec, perlin_perm, acc, value, n);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif

// Resident blocks a multiprocessor of the current device holds of this
// library's kernels A, D and E (0 for E in the noise variant's library),
// with the dynamic shared memory they are launched with for a scene of
// n_tri_chunks triangle chunks, into out[0..2]; returns
// cudaGetLastError() (0 = success).
extern "C" int trace_wave_occupancy(int* out, int n_tri_chunks) {
  const size_t smem = dyn_bytes(n_tri_chunks);
  out[2] = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], trace_wave_kernel<kNoise>, ROW, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], fused_bounce_kernel<kNoise>, ROW, smem);
  if (!kNoise)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], select_kernel, ROW, tile_bytes(n_tri_chunks));
  return static_cast<int>(cudaGetLastError());
}
