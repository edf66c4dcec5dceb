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
// ops/uber.py:trace_wave_bwd_plain. The same body, trace_rays_bwd, is
// kernel D' too: the adjoint of one uber bounce, replacing pallas_uber.py
// _make_fused_bwd_kernel (:619, launched by _fused_bwd, :802), from kernel
// D's input state and winners; its plain version is
// ops/uber.py:fused_bounce_bwd_plain. D' is launched with depth 1 as a
// launch argument and votes on B's 1024-ray tile; its row cotangents and
// light-table partials are summed by bwd_reduce, as B's are. The adjoint
// below runs the device functions of trace_bwd_common.cuh
// (update_found_vjp, update_miss_vjp,
// shade_fwd + shade_vjp, hit_attrs_vjp), the per-ray transliteration of
// ops/{hit,shade,bounce}_core.py's *_vjp functions, winner's kind and
// material only; the split route's backward kernels J' and H' (split.cu)
// run the same functions.
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
//     then across blocks in block order. Gradients are bitwise repeatable;
//   * a scene with Noise textures runs the HAS_NOISE instantiation: the
//     Perlin tables go to shared memory once per block, before the bounce
//     loop, and a noise hit recomputes its marble albedo and sends the
//     albedo's cotangent through marble_vjp (trace_common.cuh) into the hit
//     point and into its row's scale column; the albedo columns take none.
//     The other instantiation is the kernel without it.
//
// Numerics: no fast-math (IEEE division and sqrt, as the forward), and
// built with --fmad=false (kernels/__init__.py), so it rounds as its plain
// version does; the forward is recomputed with the forward kernel's
// formulas (trace_common.cuh), so its branches (tir, metal_ok, the checker
// parity) are the forward's up to the forward's FMA contraction. The
// kinks follow jax.vjp: max/min split the cotangent evenly on a tie, a where() sends nothing to
// the untaken branch, abs'(0) = 1, the clamped divisor of safe_div and the
// floor of the pdf take none.

#include "trace_bwd_common.cuh"

namespace {

using namespace trace;

constexpr int TILE = 1024;           // the TPU kernels' liveness grain
constexpr int MAX_LT = 128;          // (n_lights + 1) * LT_COLS <= 128
constexpr int RED = 256;             // threads of a reduction block
constexpr int W_MAX = 32;            // winner-row columns a block sums

struct BwdTables {
  const float* uni;   // [P, w] winner rows (a miss reads none)
  const float* lt;    // [n_lights + 1, LT_COLS]; last row = background
  const float* perlin_vec;   // [256, 3] (noise scenes)
  const int* perlin_perm;    // [3, 256]
  int w, n_lights, has_checker, p_rows;
};

// The adjoint of ``depth`` bounces of the block's 128 rays replayed from
// the residuals, the body of kernels B and D': dst, each (bounce, ray)'s
// winner-row cotangent and key, and the block's light-table partial.
template <bool HAS_NOISE>
__device__ __forceinline__ void
trace_rays_bwd(const float* __restrict__ hist, const float* __restrict__ rnd,
               const int* __restrict__ kind, const int* __restrict__ idx,
               const float* __restrict__ g_in, const BwdTables& tb,
               float* __restrict__ dst, float* __restrict__ contrib,
               int* __restrict__ keys, float* __restrict__ dlt_part, int n,
               int depth) {
  extern __shared__ float perlin_smem[];     // PERLIN_SMEM bytes if noise
  Perlin perlin{nullptr, nullptr};
  if constexpr (HAS_NOISE) {                 // before any vote or continue
    perlin = perlin_load(perlin_smem, tb.perlin_vec, tb.perlin_perm);
    __syncthreads();
  }
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
      const V3 gb = update_miss_vjp(bg, beta, gL, {gs[11], gs[12], gs[13]},
                                    dlt + tb.n_lights * LT_COLS);
      gs[11] = gb.x;
      gs[12] = gb.y;
      gs[13] = gb.z;
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
    V3 alb = {att[leaf], att[leaf + 1], att[leaf + 2]};
    const int sc_col = tb.has_checker ? 13 : 6;   // noise scale, then flag
    const bool is_nz = HAS_NOISE && att[sc_col + 1] > 0.5f;
    if constexpr (HAS_NOISE) {
      if (is_nz) {
        const float m = marble(perlin, p, att[sc_col]);
        alb = {m, m, m};
      }
    }

    // ---- the shading recomputed, the adjoints of the estimator update
    // and of the shading (trace_bwd_common.cuh) --------------------------
    const float* __restrict__ r = rnd + (size_t)b * 15 * n + i;
    const ShadeFwd sf = shade_fwd(mkind, d, nrm, p, alb, fuzz, tb.lt,
                                  tb.n_lights, r, (size_t)n);
    const UpdateVjp u = update_found_vjp(
        beta, sf.em, sf.wt, sf.alive, {gs[0], gs[1], gs[2]},
        {gs[3], gs[4], gs[5]}, gL, {gs[11], gs[12], gs[13]});
    gs[11] = u.g_beta.x;
    gs[12] = u.g_beta.y;
    gs[13] = u.g_beta.z;
    V3 g_o = u.g_o, g_d = u.g_d, g_p = u.g_p, g_n, g_a;
    float g_fuzz, g_ior;
    shade_vjp(sf, mkind, d, nrm, p, alb, ior, tb.lt, tb.n_lights, r,
              (size_t)n, u.g_em, u.g_wt, u.g_sd, g_d, g_p, g_n, g_a, g_fuzz,
              g_ior, dlt);

    // ---- adjoint of the marble: the albedo's cotangent, summed over the
    // three channels, into the hit point and the texture's scale ----------
    float g_scale = 0.f;
    if constexpr (HAS_NOISE) {
      if (is_nz) {
        const MarbleGrad mg = marble_vjp(perlin, p, att[sc_col],
                                         g_a.x + g_a.y + g_a.z);
        g_p = add(g_p, mg.p);
        g_scale = mg.scale;
      }
    }

    // ---- adjoint of the hit attributes (trace_bwd_common.cuh) ----------
    float g_pk[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float g_time = 0.f, g_tmed = 0.f;
    hit_attrs_vjp<false>(kd, o, d, time, T_MIN, INFINITY, pk, flip, ny_pre,
                         t, p, {0.f, g_p, g_n, 0.f, 0.f, {0.f, 0.f, 0.f}},
                         g_o, g_d, g_time, g_pk, g_tmed);

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
    if (is_nz) {
      out[A_COL + sc_col] = g_scale;
    } else {
      out[A_COL + leaf] = g_a.x;
      out[A_COL + leaf + 1] = g_a.y;
      out[A_COL + leaf + 2] = g_a.z;
    }
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

// Kernel B: the adjoint of every bounce of the wave.
template <bool HAS_NOISE>
__global__ void __launch_bounds__(ROW)
trace_wave_bwd_kernel(const float* __restrict__ hist,
                      const float* __restrict__ rnd,
                      const int* __restrict__ kind,
                      const int* __restrict__ idx,
                      const float* __restrict__ g_in, const BwdTables tb,
                      float* __restrict__ dst, float* __restrict__ contrib,
                      int* __restrict__ keys, float* __restrict__ dlt_part,
                      int n, int depth) {
  trace_rays_bwd<HAS_NOISE>(hist, rnd, kind, idx, g_in, tb, dst, contrib,
                            keys, dlt_part, n, depth);
}

// Kernel D': the adjoint of one bounce (the caller passes depth 1, a
// launch argument, so the body is B's instruction for instruction) from
// kernel D's input state ``st`` and winners, voting on B's 1024-ray tile.
template <bool HAS_NOISE>
__global__ void __launch_bounds__(ROW)
fused_bounce_bwd_kernel(const float* __restrict__ st,
                        const float* __restrict__ rnd,
                        const int* __restrict__ kind,
                        const int* __restrict__ idx,
                        const float* __restrict__ g_in, const BwdTables tb,
                        float* __restrict__ dst, float* __restrict__ contrib,
                        int* __restrict__ keys, float* __restrict__ dlt_part,
                        int n, int depth) {
  trace_rays_bwd<HAS_NOISE>(st, rnd, kind, idx, g_in, tb, dst, contrib,
                            keys, dlt_part, n, depth);
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
// has_noise picks the variant with the marble's adjoint, which reads
// perlin_vec [256, 3] and perlin_perm [3, 256].
extern "C" int trace_wave_bwd_launch(
    const float* hist, const float* rnd, const int* kind, const int* idx,
    const float* g, const float* uni, const float* lt,
    float* dst, float* contrib, int* keys, float* dlt_part, int n,
    int depth, int w, int p_rows, int n_lights, int has_checker,
    const float* perlin_vec, const int* perlin_perm, int has_noise,
    void* stream) {
  if (n % TILE != 0 || (n_lights + 1) * LT_COLS > MAX_LT) return -1;
  BwdTables tb{uni, lt, perlin_vec, perlin_perm, w, n_lights, has_checker,
               p_rows};
  const int blocks = n / ROW;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && has_noise) {
    trace_wave_bwd_kernel<true><<<blocks, ROW, PERLIN_SMEM, s>>>(
        hist, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n,
        depth);
  } else if (blocks > 0) {
    trace_wave_bwd_kernel<false><<<blocks, ROW, 0, s>>>(
        hist, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n,
        depth);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch kernel D' on ``stream``; returns cudaGetLastError() (0 =
// launched). st (kernel D's input), g and dst [14, n], rnd [15, n]
// float32; kind, idx and keys [n] int32; contrib [n, w]; dlt_part
// [n / 128, (n_lights + 1) * 14]. n is a multiple of 1024; has_noise picks
// the variant, as in trace_wave_bwd_launch.
extern "C" int fused_bounce_bwd_launch(
    const float* st, const float* rnd, const int* kind, const int* idx,
    const float* g, const float* uni, const float* lt, float* dst,
    float* contrib, int* keys, float* dlt_part, int n, int w, int p_rows,
    int n_lights, int has_checker, const float* perlin_vec,
    const int* perlin_perm, int has_noise, void* stream) {
  if (n % TILE != 0 || (n_lights + 1) * LT_COLS > MAX_LT) return -1;
  BwdTables tb{uni, lt, perlin_vec, perlin_perm, w, n_lights, has_checker,
               p_rows};
  const int blocks = n / ROW;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && has_noise) {
    fused_bounce_bwd_kernel<true><<<blocks, ROW, PERLIN_SMEM, s>>>(
        st, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n, 1);
  } else if (blocks > 0) {
    fused_bounce_bwd_kernel<false><<<blocks, ROW, 0, s>>>(
        st, rnd, kind, idx, g, tb, dst, contrib, keys, dlt_part, n, 1);
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
