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
//     fused_search_plain. Launched with no sphere or quad rows it is TPU
//     kernel L (pallas_intersect.py:326 tri_search; plain version
//     ops/search.py tri_search_plain).
//
// Tiles are 256 rays and restart at each chunk's first ray, as JAX's
// per-chunk calls do; a chunk that is not a multiple of 256 ends in a
// short tile. With a permutation (ops/search.py search_order, JAX's
// intersect._search_order: dead rays last, live ones by direction octant,
// then Morton order of the origin) position j of the wave is the ray
// perm[j]: both kernels read the rays through it and M writes each winner
// back to the ray's own position, so no sorted copy is made.
//
// What bounds them on the card. K: fp32 work, the slab test's ~36
// operations per (live ray, nonempty box) (147,456 rays x 512 clusters on
// bounce 0 of the mesh workload) after three IEEE divisions per live ray;
// its inputs and its [tiles, clusters] output are a few MB.
//
// What K's first port lost (PERF.md, kernel table): one 256-thread block
// a tile, a thread a cluster, walked every ray of its tile, dead ones
// included, and divided by d in every (ray, box) test; since the sort
// puts a chunk's live rays into its first tiles, a bounce's work sat on a
// fraction of the blocks, each serial over up to 256 rays. The design:
//   * packed live rays, their inverses computed once: a ballot and a
//     prefix (block_slot, below) put the tile's n live rays into the first
//     n slots of shared memory, each as its origin, 1 / d (the quotient
//     1 / (|d| < 1e-12 ? 1 : d) the test always used, so every (lo - o) *
//     inv rounds as before), t_min, t_max and a bit per axis with |d| <
//     1e-12. A tile without a live ray writes its +inf row and leaves;
//   * a short test for the common ray: where no axis has |d| < 1e-12,
//     o is finite and 1 / d holds no NaN, no t of a nonempty box is NaN,
//     so the NaN-propagating jmin / jmax become their plain compares and
//     selects (the same selections, ties and signed zeros included) and
//     the per-axis selects of the parallel case drop out; other rays
//     take the full test;
//   * a live tile spread over blocks: the grid's y splits the clusters,
//     cpb of them a block (ENTER_CPB = 64, or the least power of two that
//     holds k; 64 measured 5% under 32 and 128, PERF.md), so a tile's k
//     clusters go to ceil(k / cpb) blocks and no entry is met across
//     blocks. A block's threads are cpb clusters x 256 / cpb slices of
//     the packed rays: a warp's lanes test neighbouring
//     clusters against the same ray (a broadcast read), each thread keeps
//     the least entry of its slice, and the slices meet in shared memory
//     in slice order. Each (tile, cluster) entry is the least of the same
//     values as before (strict <, no float atomics), so K gives the plain
//     version's entries. The other way to spread a tile, its packed rays
//     split over 2 or 4 blocks of a grid z met by an integer atomicMin of
//     the entries' bits (and the output filled with +inf first), measured
//     8% and 29% slower on the mean of the mesh's bounces, each bounce
//     slower (PERF.md): the cluster split already gives a live tile
//     ceil(k / 64) blocks with no merge.
// M: fp32 work per ray-triangle test: the
// determinant's 3-term dot and the face test on every test, the t dot and
// a division where the face is seen, the u and v dots where t can win
// (8, 12 and 29 operations; tools/search_times.py m_work counts the tests
// each stage needs). Its table is read once per (tile, swept cluster),
// from L2: the search is bound by the instructions a warp issues a test
// and by how many warps the live tiles can keep busy.
//
// What M's first port lost, measured (PERF.md, kernel table): after a
// bounce the few live rays sat in warps of dead ones, so every warp swept
// its tile's cluster union for one or two lanes, and a tile's union grew
// to a half-space; each test read 41 floats as scalar loads and computed
// four 10-term dots before any check; clusters were swept in id order, so
// a ray that had hit kept testing the clusters behind its hit. The design:
//   * the sort (above) puts a chunk's live rays into its first tiles and
//     near rays, going the same way, into the same tile; the dead ones
//     fill whole tiles at the chunk's end. On the mesh a tile's rays
//     still reach across the cloud (a few thousand live rays a chunk
//     against 512 clusters): a live tile enters 200-400 of them;
//   * parts: so a bounce's few live tiles, each entering hundreds of
//     clusters, do not sit on a few SMs while the rest idle (measured: 16
//     live tiles took 10.5 ms where the parent's 384 sparse ones took
//     6.7), the grid's y is the part: a tile of m entered clusters is
//     swept by min(32, m / 8) blocks (at least one), each taking every
//     parts-th cluster of the tile's order. Each keeps its rays' least
//     (t, row) and meets the others' in a 64-bit word a ray by an integer
//     atomicMin of (the t's ordered bits, the row): the least of the same
//     candidates whatever the order the parts end in. The last part to
//     finish (a counter a tile) folds the spheres and quads and writes
//     the winners. No float atomics;
//   * live rays packed per tile: a ballot and a prefix over the block's 8
//     warps put the tile's n live rays into the first n slots of shared
//     memory; the first ceil(n / 32) warps sweep them and the rest only
//     stage and wait. A tile without a live ray writes its misses and
//     leaves before it stages anything;
//   * the compact triangle row: _tri_coeffs' rows have structural zeros
//     (det = -n.d lives on d: 3 terms; t_num = n.o - v0.n on o and the
//     constant: 4; u_num and v_num on d and o x d: 6 each), so a row is
//     19 coefficients and the flag, 20 floats, five 16-byte loads
//     (ops/search.py compact_rows: det | t_o0, t_o1 t_o2 t_1 flag, u, v);
//   * staged tests: det and the face test, then t against the window and
//     the ray's best (t <= best, kept for the lexicographic tie), then u
//     and v. The same values compared in another order;
//   * front to back: the wrapper gives each tile's entered clusters in
//     ascending K entry (a stable argsort of ent's rows, the order of
//     JAX's dense grid, pallas_intersect.py:992), and each part sweeps its
//     share of them in that order. Near clusters first give a ray a small
//     best t early, so the t <= best check skips the u and v dots of the
//     triangles behind its hit. No warp stops early: a prune on K's entry
//     would need t's rounding to stay below the box's CULL_EPS margin,
//     and near a grazing hit (|n.d| down to the face test's 1e-5 |d|) it
//     does not, so a pruned cluster could hold the plain version's winner;
//   * the staged tile stays in shared memory: two buffers of 128 rows
//     (10 KB each), the next cluster's copied by cp.async while the
//     current one is swept, every lane of a warp reading the same row (a
//     broadcast). The sphere and quad rows are read from global memory,
//     also as broadcasts, by the packed rays alone. A cluster wider than
//     128 rows (compile_scene widens them past 65,536 triangles so at most
//     512 remain: 256 to 2,048 rows) is width / 128 stages, swept in row
//     order within the cluster.
//
// M's packed input (fused_search_kernel<true>, fused_search_packed_launch;
// replaces the same two grids with packed=True, pallas_intersect.py:808,
// whose kernels build the rows with _coeffs_from_pack, :394-431). The
// table is [T, 10] (v0, e1, e2, the double-sided flag; ops/search.py
// packed_rows), 40 bytes a triangle against the compact row's 80, so a
// 1,048,576-triangle mesh is 42 MB (inside the H100's 50 MB L2) instead of
// 84 MB, and the tables need no [10, T] temporaries. Each stage copies its
// 128 packed rows (5,120 contiguous bytes) by cp.async into one of two
// raw buffers; after they land, threads 0-127 each assemble one compact
// row into the buffer the sweep reads (assemble_row: the cross product,
// |n|, 1 / |n| and the products by it, ops/search.py assemble_rows' order,
// which is intersect._tri_coeffs'), and the sweep runs unchanged. With
// --fmad=false, IEEE sqrtf and division, the assembled rows are the
// compact rows bit for bit (the probe packed_rows_probe_launch writes them
// out, so the card checks every row), hence the same winners, ties
// included. What it adds per (live tile, swept cluster), whatever the
// tile's live rays: per triangle the three cross products (27), |n|^2
// (5), the guard, 1 / |n|, n / |n| (3), the t constant (6), the products
// by 1 / |n| (12) and the negations (12): about 70 fp32 operations with a
// square root and a division (tools/search_times.py OPS_M_ASSEMBLE), and
// one more barrier a stage; against that, half the table's bytes.
//
// Why the compact sums are the plain version's. The plain version sums
// all ten products of a row in feature order; the kernel sums the live
// ones in the same order (--fmad=false: every product and sum rounds on
// its own). A structural zero's product with a finite feature is +0 or
// -0, and in round-to-nearest x + (+-0) = x for any x != 0 and is a zero
// for x = +-0. So, step by step, the two sums are equal or both zero: they
// can differ only in the sign of a zero result. A zero determinant fails
// the face test either way (|det| > eps fails, eps >= 0), a zero t
// numerator gives t = +-0, which fails the window's t >= t_min (the route
// searches from T_MIN = 1e-4), and a zero u or v numerator compares as
// +0 in every test. So the tests, the winners and their t are the plain
// version's bit for bit (tests/test_torch_search_order.py replays this
// sweep; chip_smoke.py holds the kernel to the plain version on every
// lane).
//
// Numerics: built with --fmad=false; IEEE division, no fast-math. Max and
// min are written out (jmax/jmin propagate NaN like jnp.maximum/minimum):
// fminf/fmaxf drop NaN, and a far sphere pad row (c0 = 1e30) relies on a
// NaN discriminant to be rejected. No float atomics.
//
// Tie rules, the TPU kernel's: triangles fold lexicographically in (t,
// index), so the lowest index wins a tie in t whatever the sweep's order;
// then spheres, then quads, each with strict <, so a tie goes triangle >
// sphere > quad. A triangle winner's index is clamped to the last row; a
// miss has kind 0, index 0 and t inf.

#include <cuda_pipeline.h>

#include "trace_common.cuh"

namespace {

using namespace trace;

constexpr int BC = 256;          // rays per tile (pallas_intersect.py:62)
constexpr int WARPS = BC / 32;
constexpr int STAGE = 128;       // triangle rows staged at a time
constexpr int TRI_ROW = 20;      // floats of a compact triangle row
constexpr int ROW_F4 = TRI_ROW / 4;
constexpr int STAGE_F4 = STAGE * ROW_F4;
constexpr int PACK_ROW = 10;     // floats of a packed row: v0, e1, e2, flag
constexpr int PACK_STAGE_F4 = STAGE * PACK_ROW / 4;  // 5,120 bytes
constexpr int SMALL = 128;       // the sphere and quad tables' row bound
constexpr float CULL_EPS = 1e-3f;
constexpr int ENTER_CPB = 64;    // K's clusters a block, at most
// M's resident blocks an SM (__launch_bounds__): 4 at 64 registers
constexpr int M_MIN_BLOCKS = 4;
// a tile's clusters go to up to MAX_PARTS blocks, at least PART_CLUSTERS
// of them each
constexpr int MAX_PARTS = 32;
constexpr int PART_CLUSTERS = 8;

// The rays of tile `tile`: [start, start + count) of the wave's positions.
__device__ __forceinline__ void tile_span(int tile, int chunk, int n,
                                          int& start, int& count) {
  const int tpc = (chunk + BC - 1) / BC;
  const int c = tile / tpc, j = tile % tpc;
  start = c * chunk + j * BC;
  count = min(BC, min(chunk - j * BC, n - start));
}

// The ray at wave position j: perm[j], or j without a permutation.
__device__ __forceinline__ int ray_at(const long long* __restrict__ perm,
                                      int j) {
  return perm ? static_cast<int>(perm[j]) : j;
}

// K's static shared memory: the tile's live rays packed in thread order
// (o, the slab test's 1 / d, t_min, t_max; a bit an axis where |d| <
// 1e-12, and SLOW_RAY where the ray takes the full test), the per-warp
// counts of the block's prefix, and each thread's least entry.
constexpr int SLOW_RAY = 8;
struct EnterSmem {
  float4 ray[2][BC];               // (ox oy oz tmin), (ix iy iz tmax)
  int small[BC];
  float part[BC];
  int warp_cnt[WARPS];
};

// This thread's place among the block's threads whose `flag` is set, in
// thread order, and (in total) how many are set. Every thread calls it.
__device__ __forceinline__ int block_slot(bool flag, int* warp_cnt,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_cnt[warp] = __popc(m);
  __syncthreads();
  int slot = __popc(m & ((1u << lane) - 1u));
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_cnt[w];
    slot += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();                           // warp_cnt is free again
  return slot;
}

// K: rays [9, n] planes (o, d, time, t_min, t_max), perm [n] or null;
// cl_min / cl_max [k, 3]; ent [n_tiles, k]. Block (tile, y) computes the
// entries of clusters [y * cpb, y * cpb + cpb) of the tile; cpb is a power
// of two of at most BC.
__global__ void __launch_bounds__(BC)
tile_enter_kernel(const float* __restrict__ rays,
                  const long long* __restrict__ perm,
                  const float* __restrict__ cl_min,
                  const float* __restrict__ cl_max, int n, int chunk, int k,
                  int cpb, float* __restrict__ ent) {
  __shared__ EnterSmem sm;
  const int tile = blockIdx.x;
  int start, count;
  tile_span(tile, chunk, n, start, count);
  const int s = threadIdx.x;
  const int c0 = blockIdx.y * cpb, nc = min(cpb, k - c0);
  float* __restrict__ row = ent + (size_t)tile * k + c0;

  // ---- pack the tile's live rays, their inverses once a ray -----------
  const bool in = s < count;
  const int src = in ? ray_at(perm, start + s) : 0;
  const float tmin0 = in ? rays[(size_t)7 * n + src] : 0.f;
  const float tmax0 = in ? rays[(size_t)8 * n + src] : -1.f;
  const bool live = tmax0 > tmin0;           // a pad ray: no window
  int n_live;
  const int slot = block_slot(live, sm.warp_cnt, n_live);
  if (n_live == 0) {                         // the same for the whole block
    for (int c = s; c < nc; c += BC) row[c] = INFINITY;
    return;
  }
  if (live) {
    float o[3], inv[3];
    int small = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = rays[(size_t)a * n + src];
      const float d = rays[(size_t)(3 + a) * n + src];
      const bool sm_a = fabsf(d) < 1e-12f;
      inv[a] = 1.f / (sm_a ? 1.f : d);
      small |= sm_a ? 1 << a : 0;
      small |= (!(fabsf(o[a]) < INFINITY) || inv[a] != inv[a]) ? SLOW_RAY
                                                              : 0;
    }
    small |= small ? SLOW_RAY : 0;
    sm.ray[0][slot] = make_float4(o[0], o[1], o[2], tmin0);
    sm.ray[1][slot] = make_float4(inv[0], inv[1], inv[2], tmax0);
    sm.small[slot] = small;
  }
  __syncthreads();

  // ---- cpb clusters x BC / cpb slices of the packed rays --------------
  const int slices = BC / cpb;
  const int cl = s & (cpb - 1), sl = s / cpb;
  float best = INFINITY;
  if (cl < nc) {
    const int c = c0 + cl;
    float lo[3], hi[3];
    bool nonempty = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float mn = cl_min[c * 3 + a], mx = cl_max[c * 3 + a];
      nonempty = nonempty && mn <= mx;
      lo[a] = mn - CULL_EPS;
      hi[a] = mx + CULL_EPS;
    }
    if (nonempty) {
      for (int q = sl; q < n_live; q += slices) {
        const float4 ro = sm.ray[0][q], ri = sm.ray[1][q];
        const int small = sm.small[q];
        const float o[3] = {ro.x, ro.y, ro.z}, inv[3] = {ri.x, ri.y, ri.z};
        const float tmin = ro.w, tmax = ri.w;
        if (!(small & SLOW_RAY)) {
          // no axis with |d| < 1e-12, o finite, 1 / d not NaN: a nonempty
          // box's bounds are not NaN, so no t below is NaN and jmin /
          // jmax reduce to their compares, the same selections
          float enter = 0.f, exit_ = 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float t0 = (lo[a] - o[a]) * inv[a];
            const float t1 = (hi[a] - o[a]) * inv[a];
            const float tlo = t0 < t1 ? t0 : t1;
            const float thi = t0 > t1 ? t0 : t1;
            enter = a == 0 ? tlo : (enter > tlo ? enter : tlo);
            exit_ = a == 0 ? thi : (exit_ < thi ? exit_ : thi);
          }
          if (enter <= exit_ && exit_ >= tmin && enter <= tmax) {
            const float e = enter > tmin ? enter : tmin;
            best = e < best ? e : best;
          }
          continue;
        }
        float enter = 0.f, exit_ = 0.f;
        bool par_ok = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const bool sm_a = (small >> a) & 1;
          const float t0 = (lo[a] - o[a]) * inv[a];
          const float t1 = (hi[a] - o[a]) * inv[a];
          const float tlo = sm_a ? -INFINITY : jmin(t0, t1);
          const float thi = sm_a ? INFINITY : jmax(t0, t1);
          enter = a == 0 ? tlo : jmax(enter, tlo);
          exit_ = a == 0 ? thi : jmin(exit_, thi);
          par_ok = par_ok && (!sm_a || (o[a] >= lo[a] && o[a] <= hi[a]));
        }
        if (par_ok && enter <= exit_ && exit_ >= tmin && enter <= tmax) {
          const float e = jmax(enter, tmin);
          best = e < best ? e : best;
        }
      }
    }
  }

  // ---- the slices meet in slice order ---------------------------------
  sm.part[s] = best;
  __syncthreads();
  if (s < nc) {
    float b = sm.part[s];
    for (int j = 1; j < slices; ++j) {
      const float v = sm.part[j * cpb + s];
      b = v < b ? v : b;
    }
    row[s] = b;
  }
}

// M's static shared memory: the tile's live rays packed in thread order
// (o, d, time, t_min, t_max and the ray's index), the per-warp counts of a
// block-wide prefix, and whether this block finishes the tile.
struct SearchSmem {
  float ray[9][BC];
  int src[BC];
  int warp_cnt[WARPS];
  int last;
};

// Bits of a non-NaN float that order as the float does (-0 before +0),
// and back.
__device__ __forceinline__ unsigned int order_bits(float x) {
  const unsigned int u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_order_bits(unsigned int b) {
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

// The block's dynamic shared memory: two stages of compact triangle rows.
__device__ __forceinline__ float4* search_dyn_smem() {
  extern __shared__ float4 search_dyn[];
  return search_dyn;
}

// The compact row (ops/search.py compact_rows: det | t_o0, t_o1 t_o2 t_1
// flag, u, v) of the packed row `pk` (v0, e1, e2, flag) into `row`, in
// ops/search.py assemble_rows' order of operations (intersect._tri_coeffs'
// and JAX's _coeffs_from_pack): with --fmad=false and IEEE sqrtf and
// division, the compact row of the same triangle bit for bit.
__device__ __forceinline__ void assemble_row(const float* __restrict__ pk,
                                             float4* __restrict__ row) {
  const float v0x = pk[0], v0y = pk[1], v0z = pk[2];
  const float e1x = pk[3], e1y = pk[4], e1z = pk[5];
  const float e2x = pk[6], e2y = pk[7], e2z = pk[8];
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  const float nl = sqrtf(nx * nx + ny * ny + nz * nz);
  const float inv_n = 1.f / (nl > 0.f ? nl : 1.f);
  const float nhx = nx * inv_n, nhy = ny * inv_n, nhz = nz * inv_n;
  const float c1x = e2y * v0z - e2z * v0y;   // cross(e2, v0)
  const float c1y = e2z * v0x - e2x * v0z;
  const float c1z = e2x * v0y - e2y * v0x;
  const float c2x = v0y * e1z - v0z * e1y;   // cross(v0, e1)
  const float c2y = v0z * e1x - v0x * e1z;
  const float c2z = v0x * e1y - v0y * e1x;
  const float t_1 = -(v0x * nhx + v0y * nhy + v0z * nhz);
  row[0] = make_float4(-nhx, -nhy, -nhz, nhx);
  row[1] = make_float4(nhy, nhz, t_1, pk[9]);
  row[2] = make_float4(-c1x * inv_n, -c1y * inv_n, -c1z * inv_n,
                       e2x * inv_n);
  row[3] = make_float4(e2y * inv_n, e2z * inv_n, -c2x * inv_n,
                       -c2y * inv_n);
  row[4] = make_float4(-c2z * inv_n, -e1x * inv_n, -e1y * inv_n,
                       -e1z * inv_n);
}

// Copy the STAGE rows from row `row0` of table `tab` (PACKED: [T, 10]
// packed rows, else [T, 20] compact rows) into `dst` by cp.async, every
// thread of the block taking every BC-th 16-byte piece. row0 is a
// multiple of STAGE, so the pieces are 16-byte aligned.
template <bool PACKED>
__device__ __forceinline__ void stage_copy(const float* __restrict__ tab,
                                           size_t row0, float4* dst) {
  constexpr int row_f = PACKED ? PACK_ROW : TRI_ROW;
  constexpr int pieces = PACKED ? PACK_STAGE_F4 : STAGE_F4;
  const float4* __restrict__ from =
      reinterpret_cast<const float4*>(tab + row0 * row_f);
  for (int i = threadIdx.x; i < pieces; i += BC)
    __pipeline_memcpy_async(dst + i, from + i, sizeof(float4));
}

// Threads 0..STAGE-1 each assemble one row of the packed stage `raw` into
// the compact stage `rows`; the caller synchronises before and after.
__device__ __forceinline__ void stage_assemble(const float4* raw,
                                               float4* rows) {
  const int q = threadIdx.x;
  if (q < STAGE)
    assemble_row(reinterpret_cast<const float*>(raw) + q * PACK_ROW,
                 rows + q * ROW_F4);
}

// M: rays [9, n]; ent [n_tiles, k] (K's, or one +inf column without
// triangles); order [n_tiles, k] each tile's clusters by ascending entry
// (a stable argsort of ent's rows; null without triangles); perm [n] or
// null; tri [n_tris, 20] compact rows (PACKED: [n_tris, 10] packed rows),
// `width` rows a cluster (a multiple of STAGE, n_tris = k * width); sph
// [n_sph, 9] (c0, c1 - c0,
// t0, 1 / (t1 - t0), r); quad [n_quad, 9] (q, u, v). best_t [n] (inf:
// none), best_kind [n], best_idx [n] (the index within its kind's table;
// 0 for none), at each ray's own index. merge ([n + n_tiles], every word
// all ones; null without triangles): the grid's y is the part, and a tile
// whose clusters are many is swept by several blocks, each taking every
// parts-th of them, whose least (t, row) a ray meet in merge[ray] (an
// integer atomicMin of the ordered t bits and the row: the same least,
// whatever the order); the last of them (the counter merge[n + tile])
// finishes the tile.
template <bool PACKED>
__global__ void __launch_bounds__(BC, M_MIN_BLOCKS)
fused_search_kernel(const float* __restrict__ rays,
                    const float* __restrict__ ent,
                    const long long* __restrict__ order,
                    const long long* __restrict__ perm,
                    const float* __restrict__ tri,
                    const float* __restrict__ sph,
                    const float* __restrict__ quad, int n, int chunk, int k,
                    int width, int n_tris, int n_sph, int n_quad,
                    float* __restrict__ best_t, int* __restrict__ best_kind,
                    int* __restrict__ best_idx,
                    unsigned long long* __restrict__ merge) {
  __shared__ SearchSmem sm;
  const int tile = blockIdx.x, part = blockIdx.y;
  int start, count;
  tile_span(tile, chunk, n, start, count);
  const int s = threadIdx.x;

  // ---- the clusters the tile enters: how many, and the tile's parts ---
  const float* __restrict__ erow = ent + (size_t)tile * k;
  int m = 0;
  if (n_tris > 0)
    for (int c0 = 0; c0 < k; c0 += BC)
      m += __syncthreads_count(c0 + s < k && erow[c0 + s] < INFINITY);
  const int parts =
      max(1, min(static_cast<int>(gridDim.y), m / PART_CLUSTERS));
  if (part >= parts) return;                 // the same for the whole block

  // ---- pack the tile's live rays into the first n_live slots ----------
  const bool in = s < count;
  const int src = in ? ray_at(perm, start + s) : 0;
  const float tmin0 = in ? rays[(size_t)7 * n + src] : 0.f;
  const float tmax0 = in ? rays[(size_t)8 * n + src] : -1.f;
  const bool live = tmax0 > tmin0;
  int n_live;
  const int slot = block_slot(live, sm.warp_cnt, n_live);
  if (part == 0 && in && !live) {            // an empty window: a miss
    best_t[src] = INFINITY;
    best_kind[src] = KIND_NONE;
    best_idx[src] = 0;
  }
  if (n_live == 0) return;                   // the same for the whole block
  if (live) {
#pragma unroll
    for (int c = 0; c < 7; ++c) sm.ray[c][slot] = rays[(size_t)c * n + src];
    sm.ray[7][slot] = tmin0;
    sm.ray[8][slot] = tmax0;
    sm.src[slot] = src;
  }

  __syncthreads();                           // the rays are set
  // the j-th cluster of this part: the (part + j * parts)-th by entry
  auto cluster_at = [&](int j) -> int {
    return static_cast<int>(order[(size_t)tile * k + part + j * parts]);
  };

  // ---- this thread's packed ray ----------------------------------------
  const bool mine = s < n_live;
  const int me = mine ? s : 0;
  const float ox = sm.ray[0][me], oy = sm.ray[1][me], oz = sm.ray[2][me];
  const float dx = sm.ray[3][me], dy = sm.ray[4][me], dz = sm.ray[5][me];
  const float tmin = sm.ray[7][me], tmax = sm.ray[8][me];
  const float cx = oy * dz - oz * dy;
  const float cy = oz * dx - ox * dz;
  const float cz = ox * dy - oy * dx;
  const float eps = TRI_DET_EPS * sqrtf(dx * dx + dy * dy + dz * dz);
  float bt = INFINITY;
  int bi = -1;                               // no triangle yet

  // ---- triangles: front to back, two staged buffers -------------------
  const int m_part = part < m ? (m - part + parts - 1) / parts : 0;
  if (m_part > 0) {
    const int spc = width / STAGE;           // stages a cluster
    const int n_st = m_part * spc;
    // staged: two buffers of compact rows; packed: the compact rows the
    // sweep reads, then two buffers of packed rows
    float4* stage = search_dyn_smem();
    constexpr int in_f4 = PACKED ? PACK_STAGE_F4 : STAGE_F4;
    float4* in = PACKED ? stage + STAGE_F4 : stage;
    auto copy = [&](int st) {
      stage_copy<PACKED>(
          tri, (size_t)cluster_at(st / spc) * width + (st % spc) * STAGE,
          in + (st & 1) * in_f4);
    };
    copy(0);
    __pipeline_commit();
    for (int st = 0; st < n_st; ++st) {
      const int c = cluster_at(st / spc);
      __syncthreads();                       // stage st - 1's buffers are read
      if (st + 1 < n_st) copy(st + 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
      __syncthreads();                       // stage st is in place
      if (PACKED) {
        stage_assemble(in + (st & 1) * in_f4, stage);
        __syncthreads();                     // its compact rows are built
      }
      if (!mine) continue;                   // warps past the packed rays too
      const float4* buf = PACKED ? stage : stage + (st & 1) * STAGE_F4;
      const int base = c * width + (st % spc) * STAGE;
      for (int q = 0; q < STAGE; ++q) {
        const float4* r = buf + q * ROW_F4;
        const float4 r0 = r[0], r1 = r[1];
        float dm = r0.x * dx;
        dm = dm + r0.y * dy;
        dm = dm + r0.z * dz;
        if (!(dm > eps || (dm < -eps && r1.w > 0.5f))) continue;
        float tm = r0.w * ox;
        tm = tm + r1.x * oy;
        tm = tm + r1.y * oz;
        tm = tm + r1.z;                      // the constant's term x 1
        const float inv = 1.f / (fabsf(dm) > eps ? dm : 1.f);
        const float t = tm * inv;
        if (!(t >= tmin && t <= tmax && t <= bt)) continue;
        const float4 r2 = r[2], r3 = r[3], r4 = r[4];
        float um = r2.x * dx;
        um = um + r2.y * dy;
        um = um + r2.z * dz;
        um = um + r2.w * cx;
        um = um + r3.x * cy;
        um = um + r3.y * cz;
        float vm = r3.z * dx;
        vm = vm + r3.w * dy;
        vm = vm + r4.x * dz;
        vm = vm + r4.y * cx;
        vm = vm + r4.z * cy;
        vm = vm + r4.w * cz;
        const float u = um * inv, v = vm * inv;
        if (!(u >= 0.f && u <= 1.f && v >= 0.f && v < 1.f - u)) continue;
        // lexicographic in (t, index): t <= bt here
        const int row = base + q;
        if (t < bt || row < bi) {
          bt = t;
          bi = row;
        }
      }
    }
  }

  // ---- the parts' least (t, row) of each ray: the last part finishes --
  const int dst = sm.src[me];
  if (parts > 1) {
    if (mine && bi >= 0)
      atomicMin(merge + dst,
                (static_cast<unsigned long long>(order_bits(bt)) << 32) |
                    static_cast<unsigned int>(bi));
    __threadfence();
    __syncthreads();
    if (s == 0)
      sm.last = atomicAdd(merge + n + tile, 1ull) ==
                static_cast<unsigned long long>(parts - 2);
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    if (mine) {
      const unsigned long long key = atomicOr(merge + dst, 0ull);
      bt = key == ~0ull ? INFINITY : from_order_bits(key >> 32);
      bi = key == ~0ull ? -1 : static_cast<int>(key & 0xffffffffu);
    }
  }
  if (!mine) return;

  // ---- the small tables, after every triangle: strict < --------------
  int bk = bi >= 0 ? KIND_TRI : KIND_NONE;
  bi = bi >= 0 ? min(bi, n_tris - 1) : 0;
  const float time = sm.ray[6][me];
  for (int q = 0; q < n_sph; ++q) {
    const float* sp = sph + q * 9;
    const float frac = (time - sp[6]) * sp[7];
    const float cx_ = sp[0] + frac * sp[3];
    const float cy_ = sp[1] + frac * sp[4];
    const float cz_ = sp[2] + frac * sp[5];
    const float ocx = ox - cx_, ocy = oy - cy_, ocz = oz - cz_;
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
    const float* qd = quad + q * 9;
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
  best_t[dst] = bt;
  best_kind[dst] = bk;
  best_idx[dst] = bi;
}

int n_tiles(int n, int chunk) {
  return n / chunk * ((chunk + BC - 1) / BC);
}

// M's dynamic shared memory with triangles: two stages of compact rows,
// or (packed) one of compact rows and two of packed rows.
size_t search_smem(bool triangles, bool packed) {
  if (!triangles) return 0;
  return (packed ? STAGE_F4 + 2 * PACK_STAGE_F4 : 2 * STAGE_F4) *
         sizeof(float4);
}

// The probe of M's packed input: block b copies packed rows [b * STAGE,
// b * STAGE + STAGE) of `pack` [n, 10] into shared memory as M's stages
// do, assembles them as M does, and writes the compact rows to `out`
// [n, 20]. No render launches it; it holds M's assembly against
// ops/search.py compact_rows(_tri_coeffs(...)) on every row.
__global__ void __launch_bounds__(BC)
packed_rows_probe_kernel(const float* __restrict__ pack,
                         float* __restrict__ out) {
  __shared__ float4 raw[PACK_STAGE_F4];
  __shared__ float4 rows[STAGE_F4];
  stage_copy<true>(pack, (size_t)blockIdx.x * STAGE, raw);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  stage_assemble(raw, rows);
  __syncthreads();
  float4* __restrict__ dst =
      reinterpret_cast<float4*>(out) + (size_t)blockIdx.x * STAGE_F4;
  for (int i = threadIdx.x; i < STAGE_F4; i += BC) dst[i] = rows[i];
}

template <bool PACKED>
int fused_search_launch_t(const float* rays, const float* ent,
                          const long long* order, const long long* perm,
                          const float* tri, const float* sph,
                          const float* quad, int n, int chunk, int k,
                          int width, int n_tris, int n_sph, int n_quad,
                          float* best_t, int* best_kind, int* best_idx,
                          unsigned long long* merge, void* stream) {
  if (chunk <= 0 || n % chunk || n_sph > SMALL || n_quad > SMALL ||
      (n_tris > 0 && (width <= 0 || width % STAGE || n_tris != k * width ||
                      !order || !merge)))
    return -1;
  const int tiles = n_tiles(n, chunk);
  const dim3 grid(tiles, n_tris > 0 ? MAX_PARTS : 1);
  if (tiles > 0)
    fused_search_kernel<PACKED>
        <<<grid, BC, search_smem(n_tris > 0, PACKED),
           static_cast<cudaStream_t>(stream)>>>(
            rays, ent, order, perm, tri, sph, quad, n, chunk, k, width,
            n_tris, n_sph, n_quad, best_t, best_kind, best_idx, merge);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches on ``stream`` and returns cudaGetLastError() (0 =
// launched), -1 for arguments it refuses. n is a multiple of chunk.
extern "C" int tile_enter_launch(const float* rays, const long long* perm,
                                 const float* cl_min, const float* cl_max,
                                 int n, int chunk, int k, float* ent,
                                 void* stream) {
  if (chunk <= 0 || n % chunk) return -1;
  const int tiles = n_tiles(n, chunk);
  int c = 1;                                 // ENTER_CPB, or the least
  while (c < ENTER_CPB && c < k) c <<= 1;    // power of two that holds k
  if (tiles > 0 && k > 0)
    tile_enter_kernel<<<dim3(tiles, (k + c - 1) / c), BC, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        rays, perm, cl_min, cl_max, n, chunk, k, c, ent);
  return static_cast<int>(cudaGetLastError());
}

// order and merge ([n + n_tiles] words, all ones) are given with
// triangles and null without: the tiles' clusters are split over up to
// MAX_PARTS blocks each. tri holds compact rows [n_tris, 20].
extern "C" int fused_search_launch(const float* rays, const float* ent,
                                   const long long* order,
                                   const long long* perm, const float* tri,
                                   const float* sph, const float* quad,
                                   int n, int chunk, int k, int width,
                                   int n_tris, int n_sph, int n_quad,
                                   float* best_t, int* best_kind,
                                   int* best_idx, unsigned long long* merge,
                                   void* stream) {
  return fused_search_launch_t<false>(rays, ent, order, perm, tri, sph, quad,
                                      n, chunk, k, width, n_tris, n_sph,
                                      n_quad, best_t, best_kind, best_idx,
                                      merge, stream);
}

// M's packed input: tri holds packed rows [n_tris, 10] (v0, e1, e2, flag).
extern "C" int fused_search_packed_launch(
    const float* rays, const float* ent, const long long* order,
    const long long* perm, const float* tri, const float* sph,
    const float* quad, int n, int chunk, int k, int width, int n_tris,
    int n_sph, int n_quad, float* best_t, int* best_kind, int* best_idx,
    unsigned long long* merge, void* stream) {
  return fused_search_launch_t<true>(rays, ent, order, perm, tri, sph, quad,
                                     n, chunk, k, width, n_tris, n_sph,
                                     n_quad, best_t, best_kind, best_idx,
                                     merge, stream);
}

// The probe: the compact rows out [n, 20] M assembles from the packed rows
// pack [n, 10]; n a multiple of STAGE.
extern "C" int packed_rows_probe_launch(const float* pack, int n, float* out,
                                        void* stream) {
  if (n < 0 || n % STAGE) return -1;
  if (n > 0)
    packed_rows_probe_kernel<<<n / STAGE, BC, 0,
                               static_cast<cudaStream_t>(stream)>>>(pack,
                                                                    out);
  return static_cast<int>(cudaGetLastError());
}
