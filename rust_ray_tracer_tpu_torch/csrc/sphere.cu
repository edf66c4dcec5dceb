// The split route's cluster-culled sphere search, on Hopper (sm_90a): one
// launch per bounce over the whole wave, for a scene of 128 or more sphere
// rows that takes the per-kind phase 1.
//
//   * sph_search_kernel (TPU kernel N) replaces
//     rust_ray_tracer_tpu/ops/pallas_sphere.py _kernel (launched by
//     sph_search, pallas_sphere.py:139): the closest sphere hit of each ray
//     over the 128-sphere clusters its 256-ray tile enters — the
//     time-lerped centre, the near root preferred, the lowest index
//     winning a tie in t. Plain version: ops/sphere.py sph_search_plain.
//
// What bounds it on the card: fp32 work, ~40 operations per ray-sphere
// test (the lerped centre, a, b, c, the discriminant, a square root, a
// division, two roots and their window tests) over every live ray of a
// tile and every sphere of the clusters the tile enters; its inputs are 9
// floats a ray and a sphere, its outputs 8 bytes a ray.
//
// What the design does about it: one block of 256 threads per tile, one
// thread per ray; tiles restart at each chunk's first ray, as JAX's
// per-chunk calls do. For each cluster in index order the block votes
// (__syncthreads_or) whether any live ray's slab test enters the
// cluster's swept box grown by 1e-3 — TPU kernel K's test, the TPU's
// _tile_cluster_mask — and skips the cluster when none does; else it
// stages the cluster's 128 x 9 floats in shared memory and every live
// thread tests all of them, each row a broadcast read. The vote is a
// barrier, so the next stage waits for every thread to finish this one.
// The cull is per tile and conservative: a ray tests every cluster its
// TPU tile tested and finds the TPU's winner. A ray with an empty window
// tests nothing.
//
// Numerics: built with --fmad=false, so every product rounds before its
// sum, as the plain version's torch elementwise ops do; IEEE division and
// square root, no fast-math. Max and min are written out (jmax/jmin
// propagate NaN like jnp.maximum/minimum): a far pad row (c0 = 1e30,
// r = 0) gives a NaN discriminant and must be rejected, which fmaxf would
// not do. Clusters fold in index order with strict <, so the lowest index
// wins a tie in t; the winner's index is clamped to the last real row; a
// miss gives t inf and index 0.

#include "trace_common.cuh"

namespace {

using namespace trace;

constexpr int BC = 256;          // rays per tile (pallas_intersect.py:62)
constexpr int BS = 128;          // spheres per cluster (pallas_sphere.py:31)
constexpr int SCOLS = 9;         // c0, c1 - c0, t0, 1 / (t1 - t0), r
constexpr float CULL_EPS = 1e-3f;

// The rays of tile `tile`: [start, start + count) of the [9, n] planes.
__device__ __forceinline__ void tile_span(int tile, int chunk, int n,
                                          int& start, int& count) {
  const int tpc = (chunk + BC - 1) / BC;
  const int c = tile / tpc, j = tile % tpc;
  start = c * chunk + j * BC;
  count = min(BC, min(chunk - j * BC, n - start));
}

// K's slab test of one ray against a box grown by CULL_EPS.
__device__ __forceinline__ bool enters(const float o[3], const float d[3],
                                       float tmin, float tmax,
                                       const float* __restrict__ mn,
                                       const float* __restrict__ mx) {
  float enter = 0.f, exit_ = 0.f;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ok = ok && mn[a] <= mx[a];                 // an empty (inverted) box
    const float lo = mn[a] - CULL_EPS, hi = mx[a] + CULL_EPS;
    const bool small = fabsf(d[a]) < 1e-12f;
    const float inv = 1.f / (small ? 1.f : d[a]);
    const float t0 = (lo - o[a]) * inv, t1 = (hi - o[a]) * inv;
    const float tlo = small ? -INFINITY : jmin(t0, t1);
    const float thi = small ? INFINITY : jmax(t0, t1);
    enter = a == 0 ? tlo : jmax(enter, tlo);
    exit_ = a == 0 ? thi : jmin(exit_, thi);
    ok = ok && (!small || (o[a] >= lo && o[a] <= hi));
  }
  return ok && enter <= exit_ && exit_ >= tmin && enter <= tmax;
}

// rays [9, n] planes (o, d, time, t_min, t_max); sph [k * BS, 9]; cl_min /
// cl_max [k, 3] the clusters' swept boxes; best_t [n] (inf: none),
// best_idx [n] (0 for none).
__global__ void __launch_bounds__(BC)
sph_search_kernel(const float* __restrict__ rays,
                  const float* __restrict__ sph,
                  const float* __restrict__ cl_min,
                  const float* __restrict__ cl_max, int n, int chunk, int k,
                  int n_sph, float* __restrict__ best_t,
                  int* __restrict__ best_idx) {
  __shared__ float ss[BS * SCOLS];
  const int tile = blockIdx.x;
  int start, count;
  tile_span(tile, chunk, n, start, count);
  const int r = threadIdx.x;
  const bool in = r < count;
  const int i = start + r;
  auto ray = [&](int c) { return in ? rays[(size_t)c * n + i] : 0.f; };
  const float o[3] = {ray(0), ray(1), ray(2)};
  const float d[3] = {ray(3), ray(4), ray(5)};
  const float time = ray(6), tmin = ray(7);
  const float tmax = in ? ray(8) : -1.f;       // a pad ray: no window
  const bool live = tmax > tmin;
  const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float inv_a = 1.f / jmax(a, 1e-12f);
  float bt = INFINITY;
  int bi = 0;
  for (int c = 0; c < k; ++c) {
    const bool hit = live && enters(o, d, tmin, tmax, cl_min + 3 * c,
                                    cl_max + 3 * c);
    if (!__syncthreads_or(hit)) continue;      // the same for the block
    const float* __restrict__ src = sph + (size_t)c * BS * SCOLS;
    for (int j = threadIdx.x; j < BS * SCOLS; j += BC) ss[j] = src[j];
    __syncthreads();
    if (!live) continue;
    for (int q = 0; q < BS; ++q) {
      const float* sp = ss + q * SCOLS;
      const float frac = (time - sp[6]) * sp[7];
      const float cx = sp[0] + frac * sp[3];
      const float cy = sp[1] + frac * sp[4];
      const float cz = sp[2] + frac * sp[5];
      const float ocx = o[0] - cx, ocy = o[1] - cy, ocz = o[2] - cz;
      const float b = ocx * d[0] + ocy * d[1] + ocz * d[2];
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - sp[8] * sp[8];
      const float disc = b * b - a * cc;
      const bool ok = disc > 0.f;
      const float sq = sqrtf(jmax(disc, 1e-12f)) * (ok ? 1.f : 0.f);
      const float root1 = (-b - sq) * inv_a;
      const float root2 = (-b + sq) * inv_a;
      const bool ok1 = ok && root1 >= tmin && root1 <= tmax;
      const bool ok2 = ok && root2 >= tmin && root2 <= tmax;
      const float t = ok1 ? root1 : (ok2 ? root2 : INFINITY);
      // ascending ids with strict <: the lowest index wins a tie in t
      if (t < bt) {
        bt = t;
        bi = c * BS + q;
      }
    }
  }
  if (!in) return;
  best_t[i] = bt;
  best_idx[i] = min(bi, n_sph - 1);
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 = launched), -1
// for arguments it refuses. n is a multiple of chunk; the table holds k
// whole clusters.
extern "C" int sph_search_launch(const float* rays, const float* sph,
                                 const float* cl_min, const float* cl_max,
                                 int n, int chunk, int k, int n_sph,
                                 float* best_t, int* best_idx, void* stream) {
  if (chunk <= 0 || n % chunk || k <= 0 || n_sph <= 0 || n_sph > k * BS)
    return -1;
  const int tiles = n / chunk * ((chunk + BC - 1) / BC);
  if (tiles > 0)
    sph_search_kernel<<<tiles, BC, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, sph, cl_min, cl_max, n, chunk, k, n_sph, best_t, best_idx);
  return static_cast<int>(cudaGetLastError());
}
