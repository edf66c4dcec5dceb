// The split route's cluster-culled sphere search, on Hopper (sm_90a): one
// launch per bounce over the whole wave, for a scene of 128 or more sphere
// rows that takes the per-kind phase 1.
//
//   * sph_search_kernel (TPU kernel N) replaces
//     rust_ray_tracer_tpu/ops/pallas_sphere.py _kernel (launched by
//     sph_search, pallas_sphere.py:139): the closest sphere hit of each ray
//     over the 128-sphere clusters its 256-ray tile enters — the
//     time-lerped centre, the near root preferred, the lowest index
//     winning a tie in t. Plain version: ops/sphere.py sph_search_plain;
//     ops/sphere.py sph_sweep_replay replays this kernel's sweep in torch.
//
// What bounds it on the card: fp32 work, ~27 operations per ray-sphere
// test up to the discriminant (the lerped centre, b, c, b^2 - a c) and ~14
// more for the roots and their windows (a square root, two products, four
// compares), and ~33 per slab test of a box; its inputs are 9 floats a
// ray and 12 a sphere, its outputs 8 bytes a ray.
//
// What N's first port lost (PERF.md, kernel table): a thread per tile
// position, so after bounce 0 a warp swept its tile's clusters for a few
// live lanes (random earth's rays are not sorted); a live ray tested all
// 128 rows of every cluster any ray of its tile entered, and the ground
// sphere's cluster box spans the world; every test ran the square root
// and both roots. The design:
//   * packed live rays: a ballot and a prefix over the block's 8 warps put
//     the tile's n live rays into the first n slots of shared memory, 32
//     to a warp. A dead or pad lane writes (inf, 0) at once, and a tile
//     without a live ray leaves;
//   * the tile's cull, then a warp's: the warps vote (__any_sync) K's slab
//     test of each cluster box (the 1e-3 growth) into a bit a cluster in
//     shared memory — the plain version's per-tile cull. Then each warp
//     walks the clusters its tile enters and votes its rays' slab test on
//     each of the cluster's sub-boxes of ROWS (32) rows (ops/sphere.py
//     sph_boxes builds them once a scene from the rows' swept boxes,
//     min(c0, c1) - r and max(c0, c1) + r; 16-row boxes measured slower,
//     PERF.md), sweeping the rows of a sub-box one of its rays enters. A
//     cluster that holds a row with r < 0 (a hollow sphere: an inverted
//     row box) is flagged, and there the tile's vote alone decides, the
//     plain version's cull exactly;
//   * a warp sweeps for its own 32 rays alone: letting a tile's idle
//     warps (after bounce 0) share a busy warp's sub-boxes, met by the
//     least (t, index), measured 6% slower on the mean of random earth's
//     bounces (faster on the last alone; PERF.md);
//   * the rows of an entered sub-box are staged in the warp's slice of
//     shared memory (12 floats a row, three 16-byte loads; read from L1
//     they measured slower), every lane reading the same row;
//   * a staged test: the centre, b, c and the discriminant on every test,
//     four rows at a time; the square root, the roots and their windows
//     only where some lane of the warp has disc > 0 (a ballot). A lane
//     with disc <= 0 (or NaN) gets t = inf whatever its roots, so nothing
//     changes.
//
// Why the winners are the plain version's. The kernel tests a subset of
// the rows the plain version tests (a sub-box is swept only in a cluster
// the tile enters). A sub-box contains its rows' spheres at every time of
// the rays' [t0, t1] (the compiler's zero-radius pad rows included: a box
// holding one spans the origin), so a sphere with a root in a ray's
// window lies in a sub-box the ray enters, and the same rows reach the
// least t and its lowest index; in a flagged cluster every live ray of an
// entering tile tests every row, as in the plain version. Each test's
// arithmetic is the plain version's (r * r comes from the table, the same
// product), so t matches bit for bit.
//
// Numerics: built with --fmad=false, so every product rounds before its
// sum, as the plain version's torch elementwise ops do; IEEE division and
// square root, no fast-math. Max and min are written out (jmax/jmin
// propagate NaN like jnp.maximum/minimum): a far pad row (c0 = 1e30,
// r = 0) gives a NaN discriminant and must be rejected, which fmaxf would
// not do. Clusters, sub-boxes and rows fold in index order with strict <,
// so the lowest index wins a tie in t; the winner's index is clamped to
// the last real row; a miss gives t inf and index 0. No float atomics
// (the tile's cluster bits are an integer atomicOr in shared memory).

#include "trace_common.cuh"

namespace {

using namespace trace;

constexpr int BC = 256;          // rays per tile (pallas_intersect.py:62)
constexpr int WARPS = BC / 32;
constexpr int BS = 128;          // spheres per cluster (pallas_sphere.py:31)
constexpr int ROW_F4 = 3;        // a sphere row: 12 floats (ops/sphere.py)
constexpr int ROWS = 32;         // rows a sub-box (ops/sphere.py SUB_ROWS)
constexpr int SUBS = BS / ROWS;  // sub-boxes a cluster
constexpr int NUNROLL = 4;       // rows whose discriminants a sweep takes
                                 // together
// resident blocks an SM (__launch_bounds__): 55 registers; 5 (one round
// for a wave's 576 tiles on 132 SMs) and more measured no faster
constexpr int N_MIN_BLOCKS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float CULL_EPS = 1e-3f;

// The rays of tile `tile`: [start, start + count) of the [9, n] planes.
__device__ __forceinline__ void tile_span(int tile, int chunk, int n,
                                          int& start, int& count) {
  const int tpc = (chunk + BC - 1) / BC;
  const int c = tile / tpc, j = tile % tpc;
  start = c * chunk + j * BC;
  count = min(BC, min(chunk - j * BC, n - start));
}

// K's slab test of one ray against the box [lo - eps, hi + eps] within
// [tmin, tmax]: axes with |d| < 1e-12 ask for the origin inside the slab,
// an inverted (empty) box never passes. inv[a] = 1 / d[a] (the same IEEE
// quotient each time). The same verdicts as ops/quad.py enters_boxes.
__device__ __forceinline__ bool enters(const float o[3], const float d[3],
                                       const float inv[3], float tmin,
                                       float tmax, float lx, float ly,
                                       float lz, float hx, float hy,
                                       float hz) {
  const float lo[3] = {lx, ly, lz}, hi[3] = {hx, hy, hz};
  float enter = -INFINITY, exit_ = INFINITY;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ok = ok && lo[a] <= hi[a];
    const float l = lo[a] - CULL_EPS, h = hi[a] + CULL_EPS;
    if (fabsf(d[a]) < 1e-12f) {
      ok = ok && o[a] >= l && o[a] <= h;
    } else {
      const float t0 = (l - o[a]) * inv[a], t1 = (h - o[a]) * inv[a];
      enter = jmax(enter, jmin(t0, t1));
      exit_ = jmin(exit_, jmax(t0, t1));
    }
  }
  return ok && enter <= exit_ && exit_ >= tmin && enter <= tmax;
}

// The static shared memory: the tile's live rays packed in thread order
// (o, d, time, t_min, t_max and the ray's index), the per-warp counts of
// the block's prefix and each warp's staged sub-box of rows.
struct SphSmem {
  float ray[9][BC];
  int src[BC];
  int warp_cnt[WARPS];
  float4 rows[WARPS][ROWS * ROW_F4];
};

// Packed ray `q` of the tile: o, d, the slab test's 1 / d (0 where |d| <
// 1e-12, which the test does not read), time, t_min, t_max.
__device__ __forceinline__ void packed_ray(const SphSmem& sm, int q,
                                           float o[3], float d[3],
                                           float inv[3], float& time,
                                           float& tmin, float& tmax) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = sm.ray[a][q];
    d[a] = sm.ray[3 + a][q];
    inv[a] = fabsf(d[a]) < 1e-12f ? 0.f : 1.f / d[a];
  }
  time = sm.ray[6][q];
  tmin = sm.ray[7][q];
  tmax = sm.ray[8][q];
}

// The tile's cluster bits ([ceil(k / 32)] words), dynamic.
__device__ __forceinline__ unsigned* tile_bits() {
  extern __shared__ unsigned sph_tile_bits[];
  return sph_tile_bits;
}

// One warp's sweep of the ROWS staged rows at `row` (three float4 each:
// c0 e1x | e1y e1z t0 1/(t1 - t0) | r r*r 0 0) for its ray, the staged
// test: the discriminants of NUNROLL rows first (their chains
// independent), then in ascending order the roots of a row where a lane
// of the warp has disc > 0. Strict <: the lowest index keeps a tie.
__device__ __forceinline__ void sweep_rows(
    const float4* row, int base, bool mine, const float o[3],
    const float d[3], float time, float tmin, float tmax, float a,
    float inv_a, float& bt, int& bi) {
  for (int q0 = 0; q0 < ROWS; q0 += NUNROLL) {
    float b[NUNROLL], disc[NUNROLL];
#pragma unroll
    for (int j = 0; j < NUNROLL; ++j) {
      const float4* r = row + ROW_F4 * (q0 + j);
      const float4 r0 = r[0], r1 = r[1];
      const float rr = r[2].y;
      const float frac = (time - r1.z) * r1.w;
      const float cx = r0.x + frac * r0.w;
      const float cy = r0.y + frac * r1.x;
      const float cz = r0.z + frac * r1.y;
      const float ocx = o[0] - cx, ocy = o[1] - cy, ocz = o[2] - cz;
      b[j] = ocx * d[0] + ocy * d[1] + ocz * d[2];
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rr;
      disc[j] = b[j] * b[j] - a * cc;
    }
#pragma unroll
    for (int j = 0; j < NUNROLL; ++j) {
      const bool ok = disc[j] > 0.f;
      if (!__any_sync(FULL_MASK, mine && ok)) continue;
      const float sq = sqrtf(jmax(disc[j], 1e-12f)) * (ok ? 1.f : 0.f);
      const float root1 = (-b[j] - sq) * inv_a;
      const float root2 = (-b[j] + sq) * inv_a;
      const bool ok1 = ok && root1 >= tmin && root1 <= tmax;
      const bool ok2 = ok && root2 >= tmin && root2 <= tmax;
      const float t = ok1 ? root1 : (ok2 ? root2 : INFINITY);
      if (t < bt) {
        bt = t;
        bi = base + q0 + j;
      }
    }
  }
}

// rays [9, n] planes (o, d, time, t_min, t_max); sph [k * BS, 12] rows
// (float4 x 3); boxes [k * SUBS, 8] sub-boxes (lo, hollow flag | hi, 0;
// float4 x 2); cl_min / cl_max [k, 3] the clusters' swept boxes; best_t
// [n] (inf: none), best_idx [n] (0 for none).
__global__ void __launch_bounds__(BC, N_MIN_BLOCKS)
sph_search_kernel(const float* __restrict__ rays,
                  const float4* __restrict__ sph,
                  const float4* __restrict__ boxes,
                  const float* __restrict__ cl_min,
                  const float* __restrict__ cl_max, int n, int chunk, int k,
                  int n_sph, float* __restrict__ best_t,
                  int* __restrict__ best_idx) {
  __shared__ SphSmem sm;
  unsigned* bits = tile_bits();
  const int s = threadIdx.x, lane = s & 31, warp = s >> 5;
  int start, count;
  tile_span(blockIdx.x, chunk, n, start, count);

  // ---- pack the tile's live rays; a dead lane misses at once ----------
  const bool in = s < count;
  const int i = start + s;
  const float tmin0 = in ? rays[(size_t)7 * n + i] : 0.f;
  const float tmax0 = in ? rays[(size_t)8 * n + i] : -1.f;
  const bool live = tmax0 > tmin0;           // a pad ray: no window
  if (in && !live) {
    best_t[i] = INFINITY;
    best_idx[i] = 0;
  }
  for (int w = s; w < (k + 31) / 32; w += BC) bits[w] = 0u;
  const unsigned m = __ballot_sync(FULL_MASK, live);
  if (lane == 0) sm.warp_cnt[warp] = __popc(m);
  __syncthreads();                           // counts and zero bits set
  int at = __popc(m & ((1u << lane) - 1u)), n_live = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = sm.warp_cnt[w];
    at += w < warp ? c : 0;
    n_live += c;
  }
  if (n_live == 0) return;                   // the same for the whole block
  if (live) {
#pragma unroll
    for (int c = 0; c < 7; ++c) sm.ray[c][at] = rays[(size_t)c * n + i];
    sm.ray[7][at] = tmin0;
    sm.ray[8][at] = tmax0;
    sm.src[at] = i;
  }
  __syncthreads();                           // the rays are set

  // ---- the tile's cull: a bit for each cluster one of its rays enters -
  if (warp * 32 < n_live) {                  // the same for the warp
    const bool mine = s < n_live;
    float o[3], d[3], inv[3], time, tmin, tmax;
    packed_ray(sm, mine ? s : 0, o, d, inv, time, tmin, tmax);
    for (int c = 0; c < k; ++c) {
      const float* lo = cl_min + 3 * c;
      const float* hi = cl_max + 3 * c;
      const bool e = mine && enters(o, d, inv, tmin, tmax, __ldg(lo),
                                    __ldg(lo + 1), __ldg(lo + 2), __ldg(hi),
                                    __ldg(hi + 1), __ldg(hi + 2));
      if (__any_sync(FULL_MASK, e) && lane == 0)
        atomicOr(bits + (c >> 5), 1u << (c & 31));
    }
  }
  __syncthreads();                           // the bits are set

  // ---- each warp sweeps the entered sub-boxes for its 32 packed rays,
  // ---- in index order ---------------------------------------------------
  if (warp * 32 >= n_live) return;           // the same for the warp
  const bool mine = s < n_live;
  float o[3], d[3], inv[3], time, tmin, tmax;
  packed_ray(sm, mine ? s : 0, o, d, inv, time, tmin, tmax);
  const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float inv_a = 1.f / jmax(a, 1e-12f);
  float4* stage = sm.rows[warp];
  float bt = INFINITY;
  int bi = 0;
  for (int c = 0; c < k; ++c) {
    if (!((bits[c >> 5] >> (c & 31)) & 1u)) continue;
    for (int j = 0; j < SUBS; ++j) {
      const float4 lo = __ldg(boxes + 2 * (c * SUBS + j));
      const float4 hi = __ldg(boxes + 2 * (c * SUBS + j) + 1);
      // a cluster with a hollow row: the tile's vote alone
      if (lo.w == 0.f &&
          !__any_sync(FULL_MASK, mine && enters(o, d, inv, tmin, tmax, lo.x,
                                                lo.y, lo.z, hi.x, hi.y,
                                                hi.z)))
        continue;
      const int base = c * BS + j * ROWS;
      const float4* src = sph + (size_t)base * ROW_F4;
      __syncwarp();                          // the last sub-box is read
      for (int x = lane; x < ROWS * ROW_F4; x += 32)
        stage[x] = __ldg(src + x);
      __syncwarp();
      sweep_rows(stage, base, mine, o, d, time, tmin, tmax, a, inv_a, bt,
                 bi);
    }
  }
  if (!mine) return;
  best_t[sm.src[s]] = bt;
  best_idx[sm.src[s]] = min(bi, n_sph - 1);
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 = launched), -1
// for arguments it refuses. n is a multiple of chunk; the table holds k
// whole clusters and boxes k * SUBS sub-boxes; the table and the boxes
// are 16-byte aligned.
extern "C" int sph_search_launch(const float* rays, const float* sph,
                                 const float* boxes, const float* cl_min,
                                 const float* cl_max, int n, int chunk,
                                 int k, int n_sph, float* best_t,
                                 int* best_idx, void* stream) {
  if (chunk <= 0 || n % chunk || k <= 0 || n_sph <= 0 || n_sph > k * BS ||
      (reinterpret_cast<size_t>(sph) | reinterpret_cast<size_t>(boxes)) % 16)
    return -1;
  const int tiles = n / chunk * ((chunk + BC - 1) / BC);
  if (tiles > 0)
    sph_search_kernel<<<tiles, BC, (k + 31) / 32 * sizeof(unsigned),
                        static_cast<cudaStream_t>(stream)>>>(
        rays, reinterpret_cast<const float4*>(sph),
        reinterpret_cast<const float4*>(boxes), cl_min, cl_max, n, chunk, k,
        n_sph, best_t, best_idx);
  return static_cast<int>(cudaGetLastError());
}
