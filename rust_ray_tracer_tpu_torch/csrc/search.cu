// The split route's phase-1 search over triangles, on Hopper (sm_90a): one
// launch of each kernel per bounce over the whole wave.
//
//   * tile_enter_kernel (TPU kernel K) replaces
//     rust_ray_tracer_tpu/ops/pallas_intersect.py _mask_kernel (launched by
//     tile_cluster_enter_pallas, pallas_intersect.py:262): the smallest
//     entry distance of any ray of a 256-ray tile into each triangle
//     cluster's box (+inf where none enters). Plain version:
//     ops/search.py tile_enter_plain.
//   * fused_search_kernel (TPU kernel M) replaces fused_search's two grids,
//     _make_fused_kernel (the dense tile x cluster grid, launched at
//     pallas_intersect.py:959) and _make_pair_kernel (the pair list,
//     :1019): the closest (t, kind, index) over the triangles of the
//     clusters a ray's tile enters, then the small sphere and quad tables
//     (fewer than 128 rows each). Plain version: ops/search.py
//     fused_search_plain.
//
// Tiles are 256 rays and restart at each chunk's first ray, as JAX's
// per-chunk calls do; a chunk that is not a multiple of 256 ends in a
// short tile.
//
// What bounds them on the card. K: fp32 work, ~30 operations per (ray,
// box) over every ray and every cluster (147,456 rays x 512 clusters a
// bounce of the mesh workload); its inputs and its [tiles, clusters]
// output are a few MB. M: fp32 work, ~80 operations per ray-triangle test
// (four 10-term Plücker dots, a division, the compares) over every ray of
// a tile and every triangle of the clusters the tile enters; the
// coefficient rows are read once per (tile, surviving cluster).
//
// What the designs do about it:
//   * K: one block per tile. The tile's rays (o, d, t_min, t_max) go into
//     shared memory once; each thread takes the clusters tid, tid + 256,
//     ... and reduces the minimum over the 256 rays, reading each ray from
//     shared memory as a broadcast. Its output is the per-tile cull of M.
//   * M: one block of 256 threads per tile, one thread per ray. The block
//     scans its row of K's output in cluster order; for each finite entry
//     it stages the cluster's coefficient rows (128 at a time: det, u_num,
//     v_num, t_num x 10 plus the double-sided flag, 20,992 bytes) in
//     shared memory, and every live thread tests all of them in fp32, each
//     row a broadcast read. The sphere and quad tables are staged once. A
//     ray with an empty window skips the tests but still takes part in
//     the block's barriers. The cull is per tile, never per ray (a ray's
//     own slab test could miss a hit at the fp edge), so every ray tests
//     what its TPU tile tested and finds the TPU's winner.
//   * The TPU sorts each tile's survivors front to back (dense grid) or
//     lists them in id order (pair grid) and folds triangles
//     lexicographically in (t, index); sweeping in id order with strict <
//     gives the same winner, so no sort and no pair list are built here.
//
// Numerics: built with --fmad=false, so every product rounds before its
// sum, as the plain version's torch elementwise ops do; each Plücker dot
// sums its ten terms in feature order, as the plain version does. IEEE
// division, no fast-math. Max and min are written out (jmax/jmin propagate
// NaN like jnp.maximum/minimum): fminf/fmaxf drop NaN, and a far sphere pad
// row (c0 = 1e30) relies on a NaN discriminant to be rejected.
//
// Tie rules, the TPU kernel's: the lowest triangle index wins a tie in t;
// then spheres, then quads, each with strict <, so a tie goes triangle >
// sphere > quad. A triangle winner's index is clamped to the last row; a
// miss has kind 0, index 0 and t inf.

#include "trace_common.cuh"

namespace {

using namespace trace;

constexpr int BC = 256;          // rays per tile (pallas_intersect.py:62)
constexpr int STAGE = 128;       // triangle rows staged at a time
constexpr int TRI_COLS = 41;     // det, u, v, t (10 each), double-sided
constexpr int SMALL = 128;       // the sphere and quad tables' row bound
constexpr float CULL_EPS = 1e-3f;

// The rays of tile `tile`: [start, start + count) of the [9, n] planes.
__device__ __forceinline__ void tile_span(int tile, int chunk, int n,
                                          int& start, int& count) {
  const int tpc = (chunk + BC - 1) / BC;
  const int c = tile / tpc, j = tile % tpc;
  start = c * chunk + j * BC;
  count = min(BC, min(chunk - j * BC, n - start));
}

// K: rays [9, n] planes (o, d, time, t_min, t_max); cl_min / cl_max
// [k, 3]; ent [n_tiles, k].
__global__ void __launch_bounds__(BC)
tile_enter_kernel(const float* __restrict__ rays,
                  const float* __restrict__ cl_min,
                  const float* __restrict__ cl_max, int n, int chunk, int k,
                  float* __restrict__ ent) {
  __shared__ float sr[8][BC];      // ox oy oz dx dy dz tmin tmax
  const int tile = blockIdx.x;
  int start, count;
  tile_span(tile, chunk, n, start, count);
  const int r = threadIdx.x;
  const bool in = r < count;
  const int plane[8] = {0, 1, 2, 3, 4, 5, 7, 8};
#pragma unroll
  for (int c = 0; c < 8; ++c)
    sr[c][r] = in ? rays[(size_t)plane[c] * n + start + r]
                  : (c == 7 ? -1.f : 0.f);   // a pad ray: no window
  __syncthreads();
  for (int cl = threadIdx.x; cl < k; cl += BC) {
    float lo[3], hi[3];
    bool nonempty = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float mn = cl_min[cl * 3 + a], mx = cl_max[cl * 3 + a];
      nonempty = nonempty && mn <= mx;
      lo[a] = mn - CULL_EPS;
      hi[a] = mx + CULL_EPS;
    }
    float best = INFINITY;
    if (nonempty) {
      for (int q = 0; q < count; ++q) {
        const float tmin = sr[6][q], tmax = sr[7][q];
        if (!(tmax > tmin)) continue;          // an empty window
        float enter = 0.f, exit_ = 0.f;
        bool par_ok = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float o = sr[a][q], d = sr[3 + a][q];
          const bool small = fabsf(d) < 1e-12f;
          const float inv = 1.f / (small ? 1.f : d);
          const float t0 = (lo[a] - o) * inv, t1 = (hi[a] - o) * inv;
          const float tlo = small ? -INFINITY : jmin(t0, t1);
          const float thi = small ? INFINITY : jmax(t0, t1);
          enter = a == 0 ? tlo : jmax(enter, tlo);
          exit_ = a == 0 ? thi : jmin(exit_, thi);
          par_ok = par_ok && (!small || (o >= lo[a] && o <= hi[a]));
        }
        if (par_ok && enter <= exit_ && exit_ >= tmin && enter <= tmax) {
          const float e = jmax(enter, tmin);
          best = e < best ? e : best;
        }
      }
    }
    ent[(size_t)tile * k + cl] = best;
  }
}

// M: rays [9, n]; ent [n_tiles, k] (K's, or one +inf column without
// triangles); tri [n_tris, 41] (det, u_num, v_num, t_num rows over the ray
// features [o, d, o x d, 1], then the double-sided flag), `width` rows a
// cluster; sph [n_sph, 9] (c0, c1 - c0, t0, 1 / (t1 - t0), r); quad
// [n_quad, 9] (q, u, v). best_t [n] (inf: none), best_kind [n], best_idx
// [n] (the index within its kind's table; 0 for none).
__global__ void __launch_bounds__(BC)
fused_search_kernel(const float* __restrict__ rays,
                    const float* __restrict__ ent,
                    const float* __restrict__ tri,
                    const float* __restrict__ sph,
                    const float* __restrict__ quad, int n, int chunk, int k,
                    int width, int n_tris, int n_sph, int n_quad,
                    float* __restrict__ best_t, int* __restrict__ best_kind,
                    int* __restrict__ best_idx) {
  __shared__ float st[STAGE * TRI_COLS];
  __shared__ float ss[SMALL * 9];
  __shared__ float sq[SMALL * 9];
  const int tile = blockIdx.x;
  int start, count;
  tile_span(tile, chunk, n, start, count);
  for (int j = threadIdx.x; j < n_sph * 9; j += BC) ss[j] = sph[j];
  for (int j = threadIdx.x; j < n_quad * 9; j += BC) sq[j] = quad[j];

  const int r = threadIdx.x;
  const bool in = r < count;
  const int i = start + r;
  auto ray = [&](int c) { return in ? rays[(size_t)c * n + i] : 0.f; };
  const float ox = ray(0), oy = ray(1), oz = ray(2);
  const float dx = ray(3), dy = ray(4), dz = ray(5), time = ray(6);
  const float tmin = ray(7), tmax = in ? ray(8) : -1.f;
  const bool live = tmax > tmin;
  const float f[10] = {ox, oy, oz, dx, dy, dz, oy * dz - oz * dy,
                       oz * dx - ox * dz, ox * dy - oy * dx, 1.f};
  const float eps = TRI_DET_EPS * sqrtf(dx * dx + dy * dy + dz * dz);
  float bt = INFINITY;
  int bk = KIND_NONE, bi = 0;

  // ---- triangles: the clusters this tile enters, in id order ----------
  const float* __restrict__ erow = ent + (size_t)tile * k;
  for (int c = 0; n_tris > 0 && c < k; ++c) {
    if (!(erow[c] < INFINITY)) continue;     // the same for the whole block
    for (int base = c * width; base < (c + 1) * width; base += STAGE) {
      const int rows = min(STAGE, n_tris - base);
      __syncthreads();                       // the last stage is consumed
      const float* __restrict__ src = tri + (size_t)base * TRI_COLS;
      for (int j = threadIdx.x; j < rows * TRI_COLS; j += BC) st[j] = src[j];
      __syncthreads();
      if (!live) continue;
      for (int q = 0; q < rows; ++q) {
        const float* row = st + q * TRI_COLS;
        const float dm = dot10(row, f);
        const bool side_ok = dm > eps || (dm < -eps && row[40] > 0.5f);
        if (!side_ok) continue;
        const float inv = 1.f / (fabsf(dm) > eps ? dm : 1.f);
        const float u = dot10(row + 10, f) * inv;
        const float v = dot10(row + 20, f) * inv;
        const float t = dot10(row + 30, f) * inv;
        const bool valid = u >= 0.f && u <= 1.f && v >= 0.f && v < 1.f - u &&
                           t >= tmin && t <= tmax;
        // ascending ids with strict <: the lowest index wins a tie in t
        if (valid && t < bt) {
          bt = t;
          bk = KIND_TRI;
          bi = base + q;
        }
      }
    }
  }
  __syncthreads();                           // the small tables are staged

  // ---- the small tables, after every triangle: strict < --------------
  if (live) {
    for (int q = 0; q < n_sph; ++q) {
      const float* sp = ss + q * 9;
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
      const float sqd = sqrtf(jmax(disc, 1e-12f)) * (ok ? 1.f : 0.f);
      const float inv_a = 1.f / jmax(a, 1e-12f);
      const float root1 = (-bq - sqd) * inv_a;
      const float root2 = (-bq + sqd) * inv_a;
      const bool ok1 = ok && root1 >= tmin && root1 <= tmax;
      const bool ok2 = ok && root2 >= tmin && root2 <= tmax;
      const float t = ok1 ? root1 : (ok2 ? root2 : INFINITY);
      if (t < bt) {
        bt = t;
        bk = KIND_SPH;
        bi = q;
      }
    }
    for (int q = 0; q < n_quad; ++q) {
      const float* qd = sq + q * 9;
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
      if (valid && t < bt) {
        bt = t;
        bk = KIND_QUAD;
        bi = q;
      }
    }
  }
  if (!in) return;
  best_t[i] = bt;
  best_kind[i] = bk;
  best_idx[i] = bk == KIND_TRI ? min(bi, n_tris - 1) : bi;
}

int n_tiles(int n, int chunk) {
  return n / chunk * ((chunk + BC - 1) / BC);
}

}  // namespace

// Each entry launches on ``stream`` and returns cudaGetLastError() (0 =
// launched), -1 for arguments it refuses. n is a multiple of chunk.
extern "C" int tile_enter_launch(const float* rays, const float* cl_min,
                                 const float* cl_max, int n, int chunk, int k,
                                 float* ent, void* stream) {
  if (chunk <= 0 || n % chunk) return -1;
  const int tiles = n_tiles(n, chunk);
  if (tiles > 0 && k > 0)
    tile_enter_kernel<<<tiles, BC, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, cl_min, cl_max, n, chunk, k, ent);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_search_launch(const float* rays, const float* ent,
                                   const float* tri, const float* sph,
                                   const float* quad, int n, int chunk, int k,
                                   int width, int n_tris, int n_sph,
                                   int n_quad, float* best_t, int* best_kind,
                                   int* best_idx, void* stream) {
  if (chunk <= 0 || n % chunk || n_sph > SMALL || n_quad > SMALL ||
      (n_tris > 0 && (width <= 0 || n_tris > k * width)))
    return -1;
  const int tiles = n_tiles(n, chunk);
  if (tiles > 0)
    fused_search_kernel<<<tiles, BC, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, ent, tri, sph, quad, n, chunk, k, width, n_tris, n_sph, n_quad,
        best_t, best_kind, best_idx);
  return static_cast<int>(cudaGetLastError());
}
