// The split route's shading for scenes of 9 or more lights, on Hopper
// (sm_90a): one launch of each per bounce over the whole wave.
//
//   * shade_kernel (TPU kernel I) replaces
//     rust_ray_tracer_tpu/ops/pallas_shade.py _make_kernel (launched by
//     _shade_pallas, pallas_shade.py:442): all five materials and the
//     light-mixture sampling of every lane (emitted, weight, direction,
//     alive) from its direction, hit point, normal, albedo, fuzz, ior, its
//     15 randoms and its material kind. Plain version:
//     ops/shade_core.py plane_core.
//   * shade_bwd_kernel (TPU kernel I') replaces pallas_shade.py
//     _make_bwd_kernel (launched by _shade_bwd_pallas, pallas_shade.py:491,
//     its per-tile light-table partials summed at :534): I's adjoint, the
//     cotangents of the 14 data planes and of the light table (the randoms
//     take none: detached sampling). Plain version: ops/shade_core.py
//     plane_core_vjp.
//
// The TPU kernels stop at 9 lights, a light table of one 128-lane row
// (pallas_shade._light_table's assert); these take n_lights at run time.
// Both call the device functions the other kernels run (trace_common.cuh
// shade; trace_bwd_common.cuh shade_fwd + shade_vjp), so I computes what
// A, H and F compute for a lane, and I' what B, H' and F' compute.
//
// What bounds them on the card: memory. A lane reads its kind and the
// planes its material needs: a Lambertian lane with lights its normal, p,
// albedo and randoms 0, 1, 3, 4 (and 5, 6 where it samples a light), 13
// to 15 floats; metal 14, dielectric 8, light 9, isotropic 7. I writes
// 10 planes (40 bytes); I' reads the cotangents its kind's adjoint needs
// besides and writes 14. Both do a few hundred operations a lane, plus ~60
// for each light of a Lambertian lane's mixture pdf (and its adjoint).
// One thread per ray, every plane read and written coalesced.
//
// What the design does about the light table. I stages it in dynamic
// shared memory, n_lights * LT_COLS floats, read by every lane of the
// block. I' keeps each ray's share of its cotangent in dynamic shared
// memory too, a row of n_lights * LT_COLS + 1 floats a thread (the odd
// stride puts a warp's 32 rows on 32 banks), because a per-thread local
// array would need its size at compile time; the block then sums each
// entry over its 128 rays in thread order into dlt_part [gridDim.x,
// n_lights * LT_COLS], kernel B's layout, which bwd_reduce_kernel sums in
// block order. No float atomics: the same bits in every run. The shared
// memory a block of I' needs grows as 4 * (14 L + 128 (14 L + 1)) bytes,
// so it takes at most 32 lights (232,448 bytes, the H100's per-block
// limit); the launcher refuses more. Each light's pdf is summed in light
// order, as plane_core sums it.
//
// The library is built with --fmad=false, so it rounds as its plain
// version's torch elementwise ops do.

#include "trace_bwd_common.cuh"

namespace {

using namespace trace;

constexpr int N_DATA = 14, N_OUT = 10;
constexpr size_t SMEM_MAX = 232448;   // a block's opt-in shared memory

// data [14, n] = d(3) p(3) n(3) albedo(3) fuzz ior; rng [15, n] = ub(9)
// gb(6); kind [n]; lt [n_lights, LT_COLS]. out [10, n] = emitted(3)
// weight(3) direction(3) alive (1 / 0).
__global__ void __launch_bounds__(ROW)
shade_kernel(const float* __restrict__ data, const float* __restrict__ rng,
             const int* __restrict__ kind, const float* __restrict__ lt,
             int n_lights, float* __restrict__ out, int n) {
  extern __shared__ float smem[];          // the light table
  for (int k = threadIdx.x; k < n_lights * LT_COLS; k += ROW)
    smem[k] = lt[k];
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
  if (i >= n) return;
  auto at = [&](int c) { return data[(size_t)c * n + i]; };
  const Scatter sc = shade(kind[i], {at(0), at(1), at(2)},
                           {at(6), at(7), at(8)}, {at(3), at(4), at(5)},
                           {at(9), at(10), at(11)}, at(12), at(13), smem,
                           n_lights, rng + i, (size_t)n);
  const float y[N_OUT] = {sc.em.x, sc.em.y, sc.em.z, sc.wt.x, sc.wt.y,
                          sc.wt.z, sc.dr.x, sc.dr.y, sc.dr.z,
                          sc.alive ? 1.f : 0.f};
#pragma unroll
  for (int c = 0; c < N_OUT; ++c) out[(size_t)c * n + i] = y[c];
}

// I': data, rng, kind, lt as I's; g [9, n] the cotangents of emitted,
// weight and direction. d_data [14, n]; dlt_part [gridDim.x, n_lights *
// LT_COLS] the block's sum of its rays' light-table cotangents.
__global__ void __launch_bounds__(ROW)
shade_bwd_kernel(const float* __restrict__ data,
                 const float* __restrict__ rng, const int* __restrict__ kind,
                 const float* __restrict__ lt, int n_lights,
                 const float* __restrict__ g, float* __restrict__ d_data,
                 float* __restrict__ dlt_part, int n) {
  extern __shared__ float smem[];          // the table, then the rays' rows
  const int ltn = n_lights * LT_COLS;
  const int stride = ltn + 1;
  float* slt = smem;
  float* dl = smem + ltn + threadIdx.x * stride;   // this ray's share
  for (int k = threadIdx.x; k < ltn; k += ROW) slt[k] = lt[k];
  for (int k = 0; k < ltn; ++k) dl[k] = 0.f;
  __syncthreads();
  const int i = blockIdx.x * ROW + threadIdx.x;
  if (i < n) {
    auto at = [&](int c) { return data[(size_t)c * n + i]; };
    auto gat = [&](int c) { return g[(size_t)c * n + i]; };
    const V3 d = {at(0), at(1), at(2)}, p = {at(3), at(4), at(5)};
    const V3 nrm = {at(6), at(7), at(8)}, alb = {at(9), at(10), at(11)};
    const int mk = kind[i];
    const float* __restrict__ r = rng + i;
    const ShadeFwd sf = shade_fwd(mk, d, nrm, p, alb, at(12), slt, n_lights,
                                  r, (size_t)n);
    V3 g_d = {0.f, 0.f, 0.f}, g_p = g_d, g_n = g_d, g_a = g_d;
    float g_fuzz = 0.f, g_ior = 0.f;
    shade_vjp(sf, mk, d, nrm, p, alb, at(13), slt, n_lights, r, (size_t)n,
              {gat(0), gat(1), gat(2)}, {gat(3), gat(4), gat(5)},
              {gat(6), gat(7), gat(8)}, g_d, g_p, g_n, g_a, g_fuzz, g_ior,
              dl);
    const float y[N_DATA] = {g_d.x, g_d.y, g_d.z, g_p.x, g_p.y, g_p.z,
                             g_n.x, g_n.y, g_n.z, g_a.x, g_a.y, g_a.z,
                             g_fuzz, g_ior};
#pragma unroll
    for (int c = 0; c < N_DATA; ++c) d_data[(size_t)c * n + i] = y[c];
  }
  __syncthreads();
  // the block's partial: each entry summed over the rays in thread order
  const float* rows = smem + ltn;
  for (int k = threadIdx.x; k < ltn; k += ROW) {
    float acc = rows[k];
    for (int t = 1; t < ROW; ++t) acc += rows[t * stride + k];
    dlt_part[(size_t)blockIdx.x * ltn + k] = acc;
  }
}

size_t bwd_smem(int n_lights) {
  const size_t ltn = (size_t)n_lights * LT_COLS;
  return (ltn + (size_t)ROW * (ltn + 1)) * sizeof(float);
}

// Opt the kernel in to ``bytes`` of dynamic shared memory past the default
// 48 KB; 0 on success.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

int launched(int n) {
  return n > 0 ? static_cast<int>(cudaGetLastError()) : 0;
}

}  // namespace

// The most lights shade_bwd_launch takes (its shared memory).
extern "C" int shade_max_lights() {
  int l = 0;
  while (bwd_smem(l + 1) <= SMEM_MAX) ++l;
  return l;
}

// Each entry launches on ``stream`` and returns cudaGetLastError() (0 =
// launched), or -1 for a light count past the shared memory. Shapes as
// above; n is the ray count (any n >= 0).
extern "C" int shade_launch(const float* data, const float* rng,
                            const int* kind, const float* lt, int n_lights,
                            float* out, int n, void* stream) {
  const size_t smem = (size_t)n_lights * LT_COLS * sizeof(float);
  if (n_lights < 0 || smem > SMEM_MAX) return -1;
  if (const int e = allow_smem(shade_kernel, smem)) return e;
  if (n > 0)
    shade_kernel<<<(n + ROW - 1) / ROW, ROW, smem,
                   static_cast<cudaStream_t>(stream)>>>(
        data, rng, kind, lt, n_lights, out, n);
  return launched(n);
}

// dlt_part [ceil(n / ROW), n_lights * LT_COLS]. With n == 0 nothing is
// launched.
extern "C" int shade_bwd_launch(const float* data, const float* rng,
                                const int* kind, const float* lt,
                                int n_lights, const float* g, float* d_data,
                                float* dlt_part, int n, void* stream) {
  const size_t smem = bwd_smem(n_lights);
  if (n_lights < 0 || smem > SMEM_MAX) return -1;
  if (const int e = allow_smem(shade_bwd_kernel, smem)) return e;
  if (n > 0)
    shade_bwd_kernel<<<(n + ROW - 1) / ROW, ROW, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        data, rng, kind, lt, n_lights, g, d_data, dlt_part, n);
  return launched(n);
}
