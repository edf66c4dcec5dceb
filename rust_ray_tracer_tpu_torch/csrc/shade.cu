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
// What bounds them on the card. A lane reads its kind and the planes its
// material needs: a Lambertian lane with lights its normal, p, albedo and
// randoms 0, 1, 3, 4 (and 5, 6 where it samples a light), 13 to 15
// floats; metal 14, dielectric 8, light 9, isotropic 7. I writes 10
// planes (40 bytes); I' reads the cotangents its kind's adjoint needs
// besides and writes 14. Both do a few hundred operations a lane, plus,
// for a Lambertian lane, each light's term of the mixture pdf; I' runs
// that light's hit test again in its adjoint, and on the H100 this
// per-light work, not its bytes, sets I''s time (about 2.6 us a light on
// a 147,456-ray wave). One thread per ray, every plane read and written
// coalesced.
//
// What I's design does about it. (1) A lane's loads go out in two rounds
// ahead of its branches: p, its normal, its albedo and its kind, then the
// other data planes its kind reads and its material's randoms
// (trace_common.cuh load_randoms: a Lambertian lane's 5 and 6 whether or
// not it samples a light), expanded into the 15 slots shade reads with
// stride 1. A Lambertian lane reads 16 floats, not 21: all 14 data planes
// in the first round ran 6% slower. (2) The mixture pdf runs over each lane's
// candidate lights only (CandidateLights): a light's pdf is non-zero only
// where the lane's ray line crosses it, which a sphere light's
// discriminant tells for ~20 operations, against ~60 and three IEEE
// divisions and two square roots for the whole test (the library is
// built --fmad=false, so each is a sequence of instructions). The terms
// left out are exactly +0, so the sum keeps its bits. (3) The full test
// of a candidate sphere takes only the far root: r1 <= r2, so r1 >= 1e-4
// implies r2 >= 1e-4, and the near root's division goes.
//
// What the design does about the light table. I stages it in dynamic
// shared memory, n_lights * LT_COLS floats, read by every lane of the
// block; I' stages it too. I' takes the lights' cotangents light-major:
// each lane runs its forward and the part of the adjoint that reads no
// light row first (lambertian_vjp_head, or shade_vjp for the other kinds),
// then the block steps through the lights together. For light l a
// Lambertian lane of the mixture puts its share of the light's 14 entries
// (sphere_pdf_bwd / quad_pdf_bwd, the adjoint shade_vjp runs for that
// light) into a stage [LT_COLS][ROW + 1] in shared memory (the odd stride
// spreads the summing threads over the banks), and the warps' ballots
// mark the lanes whose share is not all zero. After one barrier 14
// threads each sum one entry over the marked lanes in thread order into
// dlt_part [gridDim.x, n_lights * LT_COLS], kernel B's layout, which
// bwd_reduce_kernel sums in block order. Two stages alternate, so one
// barrier a light is enough. A lane's adds to its g_p come light by light,
// in shade_vjp's order, and each entry of a ray takes at most one add (0 +
// x, never -0), so a lane left out adds +0, which changes no sum: every
// bit of dlt_part is what a sum over all 128 rays in thread order gives.
// No float atomics: the same bits in every run. The shared memory a block
// of I' needs is 4 * (14 L + 2 * 14 * 129) + 32 bytes, 14,984 at 9
// lights, so occupancy is set by registers,
// and the cap (shade_max_lights) is what the H100's 227 KB a block holds
// of the light table: 3,892 lights. Each light's pdf is summed in light
// order, as plane_core sums it.
//
// The library is built with --fmad=false, so it rounds as its plain
// version's torch elementwise ops do.

#include "trace_bwd_common.cuh"

namespace {

using namespace trace;

constexpr int N_DATA = 14, N_OUT = 10;
constexpr int SP = ROW + 1;           // the stage's stride a light entry
constexpr int WARPS = ROW / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;   // a block's opt-in shared memory

// The discriminant of the sphere light l against the line p + t sd, with
// light_pdf's operations (trace_common.cuh), and the line's aa and bb.
__device__ __forceinline__ float sphere_disc(const float* __restrict__ l,
                                             V3 p, V3 sd, float& aa,
                                             float& bb) {
  const V3 c = {l[1], l[2], l[3]};
  const float r = l[4];
  const V3 oc = {p.x - c.x, p.y - c.y, p.z - c.z};
  aa = dot3(sd, sd);
  bb = dot3(oc, sd);
  const float cc = dot3(oc, oc) - r * r;
  return bb * bb - aa * cc;
}

// light_pdf of a sphere light whose discriminant is positive, its hit
// test on the far root alone: safe_sqrt gives sq >= 0, so -bb - sq <= -bb
// + sq, and rounding and the division by aas > 0 keep the order, so r1 <=
// r2 and (r1 >= 1e-4 || r2 >= 1e-4) is r2 >= 1e-4. The cone's solid
// angle only where the line hits. Every operation that remains is
// light_pdf's, so the value is its bit for bit.
__device__ __forceinline__ float sphere_candidate_pdf(
    const float* __restrict__ l, V3 p, V3 sd) {
  float aa, bb;
  const float disc = sphere_disc(l, p, sd, aa, bb);
  const float sq = safe_sqrt(disc);
  const float aas = jmax(aa, EPS);
  const float r2 = (-bb + sq) / aas;
  if (!(r2 >= 1e-4f)) return 0.f;
  const V3 c = {l[1], l[2], l[3]};
  const float r = l[4];
  const V3 cp = {c.x - p.x, c.y - p.y, c.z - p.z};
  const float dist_sq = dot3(cp, cp);
  const float cos_max = safe_sqrt(1.f - r * r / jmax(dist_sq, EPS));
  const float solid = TWO_PI_F * (1.f - cos_max);
  return 1.f / jmax(solid, EPS);
}

// I's LightPdfSum for shade (trace_common.cuh: the terms of its loop over
// every light, in light order, without those that are exactly +0). Pass
// 1, cheap: for each light in order, bit l of a 32-bit mask where a
// sphere light's discriminant is positive; a quad light is always a
// candidate (its pdf as light_pdf computes it), a row of another kind
// never (light_pdf gives it +0). Pass 2: the full pdf over the set bits
// in ascending order. Past 32 lights the lights go in chunks of 32, in
// order. A light left out has light_pdf +0 (disc > 0 fails), pdf_sum
// starts at +0 and no term is negative, so pdf_sum + 0.f would be pdf_sum
// bit for bit: the sum is the loop's. A warp runs pass 2 as many times as
// its lane with the most candidates.
struct CandidateLights {
  static __device__ __forceinline__ float sum(const float* __restrict__ lt,
                                              int n_lights, V3 p, V3 sd) {
    float pdf_sum = 0.f;
    for (int base = 0; base < n_lights; base += 32) {
      const float* __restrict__ chunk = lt + base * LT_COLS;
      const int m = min(n_lights - base, 32);
      unsigned cand = 0u;
      for (int k = 0; k < m; ++k) {
        const float* __restrict__ l = chunk + k * LT_COLS;
        float aa, bb;
        const bool c = l[0] == LIGHT_SPHERE_F
                           ? sphere_disc(l, p, sd, aa, bb) > 0.f
                           : l[0] == LIGHT_QUAD_F;
        cand |= (c ? 1u : 0u) << k;
      }
      for (; cand; cand &= cand - 1u) {
        const float* __restrict__ l = chunk + (__ffs(cand) - 1) * LT_COLS;
        pdf_sum = pdf_sum + (l[0] == LIGHT_SPHERE_F
                                 ? sphere_candidate_pdf(l, p, sd)
                                 : light_pdf(l, p, sd));
      }
    }
    return pdf_sum;
  }
};

// data [14, n] = d(3) p(3) n(3) albedo(3) fuzz ior; rng [15, n] = ub(9)
// gb(6); kind [n]; lt [n_lights, LT_COLS]. out [10, n] = emitted(3)
// weight(3) direction(3) alive (1 / 0). A lane issues its loads in two
// rounds ahead of its branches and ahead of the block's barrier: p, the
// normal, the albedo and its kind, then what its kind reads besides (d,
// fuzz, ior) and its material's randoms; then shade with CandidateLights
// (the header's design). A plane a lane's kind does not read stays 0.
__global__ void __launch_bounds__(ROW)
shade_kernel(const float* __restrict__ data, const float* __restrict__ rng,
             const int* __restrict__ kind, const float* __restrict__ lt,
             int n_lights, float* __restrict__ out, int n) {
  extern __shared__ float smem[];          // the light table
  const int i = blockIdx.x * ROW + threadIdx.x;
  // first round: p, the normal, the albedo and the material kind
  float x[N_DATA] = {};
  int mk = MAT_LIGHT;
  if (i < n) {
#pragma unroll
    for (int c = 3; c < 12; ++c) x[c] = data[(size_t)c * n + i];
    mk = kind[i];
  }
  // second round: d, fuzz and ior where the kind reads them (shade's
  // Lambertian and isotropic branches read none), the material's randoms
  float rv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    if (mk == MAT_METAL || mk == MAT_DIELECTRIC || mk == MAT_LIGHT) {
      x[0] = data[i];
      x[1] = data[(size_t)n + i];
      x[2] = data[(size_t)2 * n + i];
    }
    if (mk == MAT_METAL) x[12] = data[(size_t)12 * n + i];
    if (mk == MAT_DIELECTRIC) x[13] = data[(size_t)13 * n + i];
    load_randoms<false>(rng + i, (size_t)n, mk, n_lights, rv);
  }
  for (int k = threadIdx.x; k < n_lights * LT_COLS; k += ROW)
    smem[k] = lt[k];
  __syncthreads();
  if (i >= n) return;
  float rr[15];
  expand_randoms(rv, rr);
  const Scatter sc = shade<CandidateLights>(
      mk, {x[0], x[1], x[2]}, {x[6], x[7], x[8]}, {x[3], x[4], x[5]},
      {x[9], x[10], x[11]}, x[12], x[13], smem, n_lights, rr, 1);
  const float y[N_OUT] = {sc.em.x, sc.em.y, sc.em.z, sc.wt.x, sc.wt.y,
                          sc.wt.z, sc.dr.x, sc.dr.y, sc.dr.z,
                          sc.alive ? 1.f : 0.f};
#pragma unroll
  for (int c = 0; c < N_OUT; ++c) out[(size_t)c * n + i] = y[c];
}

// shade_vjp's Lambertian branch with lights (trace_bwd_common.cuh) but its
// loop over the lights, which adds only into g_p and the light rows: the
// cotangents of the normal and the albedo, and g_ps, the cotangent of each
// light's pdf, which I' hands the lights one at a time. The operations
// and their order are shade_vjp's.
__device__ __forceinline__ void lambertian_vjp_head(const ShadeFwd& f,
                                                    V3 nrm, V3 alb,
                                                    int n_lights, V3 g_wt,
                                                    V3& g_n, V3& g_a,
                                                    float& g_ps) {
  const V3 lam = f.lam;
  const float pdf = f.pdf, spdf = f.spdf, lam_w = f.lam_w;
  g_n = {0.f, 0.f, 0.f};
  g_a = {g_wt.x * lam_w, g_wt.y * lam_w, g_wt.z * lam_w};
  const float g_lamw = g_wt.x * alb.x + g_wt.y * alb.y + g_wt.z * alb.z;
  const float g_spdf = g_lamw / pdf;
  const float g_pdf = f.pdf_raw > PDF_FLOOR ? -g_lamw * spdf / (pdf * pdf)
                                            : 0.f;
  const float g_s = pick_bwd(f.s_in, spdf, 0.f, g_spdf) / PI_F;
  g_n = add(g_n, scl(g_s, normalize(lam)));
  const float g_cos = 0.5f * g_pdf;
  g_ps = (g_pdf / (float)n_lights) * 0.5f;
  const float g_c = pick_bwd(f.cos_in, jmax(f.cos_in, 0.f), 0.f, g_cos) /
                    PI_F;
  g_n = add(g_n, normalize_bwd(nrm, scl(g_c, normalize(lam))));
}

// I': data, rng, kind, lt as I's; g [9, n] the cotangents of emitted,
// weight and direction. d_data [14, n]; dlt_part [gridDim.x, n_lights *
// LT_COLS] the block's sum of its rays' light-table cotangents, light by
// light (the header's design).
__global__ void __launch_bounds__(ROW)
shade_bwd_kernel(const float* __restrict__ data,
                 const float* __restrict__ rng, const int* __restrict__ kind,
                 const float* __restrict__ lt, int n_lights,
                 const float* __restrict__ g, float* __restrict__ d_data,
                 float* __restrict__ dlt_part, int n) {
  extern __shared__ float smem[];          // the table, stages and masks
  const int ltn = n_lights * LT_COLS;
  float* slt = smem;
  float* stage = smem + ltn;               // [2][LT_COLS][SP]
  unsigned* smask = reinterpret_cast<unsigned*>(stage + 2 * LT_COLS * SP);
  for (int k = threadIdx.x; k < ltn; k += ROW) slt[k] = lt[k];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * ROW + threadIdx.x;
  V3 p = {0.f, 0.f, 0.f}, lam = p, g_d = p, g_p = p, g_n = p, g_a = p;
  float g_fuzz = 0.f, g_ior = 0.f, g_ps = 0.f;
  bool mix = false;                        // Lambertian, the lights' pdfs
  if (i < n) {
    auto at = [&](int c) { return data[(size_t)c * n + i]; };
    auto gat = [&](int c) { return g[(size_t)c * n + i]; };
    const V3 d = {at(0), at(1), at(2)};
    const V3 nrm = {at(6), at(7), at(8)}, alb = {at(9), at(10), at(11)};
    p = {at(3), at(4), at(5)};
    const int mk = kind[i];
    const float* __restrict__ r = rng + i;
    const ShadeFwd sf = shade_fwd(mk, d, nrm, p, alb, at(12), slt, n_lights,
                                  r, (size_t)n);
    const V3 g_wt = {gat(3), gat(4), gat(5)};
    mix = mk == MAT_LAMBERTIAN && n_lights > 0;
    if (mix) {
      lam = sf.lam;
      lambertian_vjp_head(sf, nrm, alb, n_lights, g_wt, g_n, g_a, g_ps);
    } else {                               // no light row is read
      shade_vjp(sf, mk, d, nrm, p, alb, at(13), slt, n_lights, r, (size_t)n,
                {gat(0), gat(1), gat(2)}, g_wt, {gat(6), gat(7), gat(8)},
                g_d, g_p, g_n, g_a, g_fuzz, g_ior, nullptr);
    }
  }
  // the lights one at a time: the lanes' shares staged, the block's sums
  for (int l = 0; l < n_lights; ++l) {
    const int b = l & 1;
    float* st = stage + b * LT_COLS * SP;
    bool nz = false;
    if (mix) {
      float* c = st + threadIdx.x;         // this ray's share, SP apart
#pragma unroll
      for (int e = 0; e < LT_COLS; ++e) c[e * SP] = 0.f;
      const float* lr = slt + l * LT_COLS;
      if (lr[0] == LIGHT_SPHERE_F)
        sphere_pdf_bwd<SP>(lr, p, lam, g_ps, c, g_p);
      else if (lr[0] == LIGHT_QUAD_F)
        quad_pdf_bwd<SP>(lr, p, lam, g_ps, c, g_p);
#pragma unroll
      for (int e = 0; e < LT_COLS; ++e) nz = nz || c[e * SP] != 0.f;
    }
    const unsigned m = __ballot_sync(FULL, nz);
    if (lane == 0) smask[b * WARPS + warp] = m;
    __syncthreads();
    if (threadIdx.x < LT_COLS) {
      // entry e of light l over the marked lanes, in thread order
      const float* x = st + threadIdx.x * SP;
      float acc = 0.f;
      for (int w = 0; w < WARPS; ++w)
        for (unsigned mm = smask[b * WARPS + w]; mm; mm &= mm - 1)
          acc += x[w * 32 + __ffs(mm) - 1];
      dlt_part[(size_t)blockIdx.x * ltn + l * LT_COLS + threadIdx.x] = acc;
    }
  }
  if (i < n) {
    const float y[N_DATA] = {g_d.x, g_d.y, g_d.z, g_p.x, g_p.y, g_p.z,
                             g_n.x, g_n.y, g_n.z, g_a.x, g_a.y, g_a.z,
                             g_fuzz, g_ior};
#pragma unroll
    for (int c = 0; c < N_DATA; ++c) d_data[(size_t)c * n + i] = y[c];
  }
}

// Shared memory of a block of I': the light table, two stages and their
// masks.
size_t bwd_smem(int n_lights) {
  return ((size_t)n_lights * LT_COLS + 2 * LT_COLS * SP) * sizeof(float) +
         2 * WARPS * sizeof(unsigned);
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

// The most lights shade_launch and shade_bwd_launch take: what a block of
// I' holds in shared memory (I's table alone is smaller).
extern "C" int shade_max_lights() {
  int l = 0;
  while (bwd_smem(l + 1) <= SMEM_MAX) ++l;
  return l;
}

// I''s resident blocks per multiprocessor at n_lights, from the CUDA
// runtime's occupancy calculator at the launch's shared memory: out[0]
// the blocks, out[1] the dynamic shared memory a block (bytes).
extern "C" int shade_bwd_occupancy(int n_lights, int* out) {
  const size_t smem = bwd_smem(n_lights);
  if (n_lights < 0 || smem > SMEM_MAX) return -1;
  if (const int e = allow_smem(shade_bwd_kernel, smem)) return e;
  out[1] = (int)smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, shade_bwd_kernel, ROW, smem));
}

// I's resident blocks per multiprocessor at n_lights, from the CUDA
// runtime's occupancy calculator at the launch's shared memory: out[0]
// the blocks, out[1] the dynamic shared memory a block (bytes).
extern "C" int shade_occupancy(int n_lights, int* out) {
  const size_t smem = (size_t)n_lights * LT_COLS * sizeof(float);
  if (n_lights < 0 || bwd_smem(n_lights) > SMEM_MAX) return -1;
  if (const int e = allow_smem(shade_kernel, smem)) return e;
  out[1] = (int)smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, shade_kernel, ROW, smem));
}

// Each entry launches on ``stream`` and returns cudaGetLastError() (0 =
// launched), or -1 for a light count past shade_max_lights (both take
// the route's cap). Shapes as above; n is the ray count (any n >= 0).
extern "C" int shade_launch(const float* data, const float* rng,
                            const int* kind, const float* lt, int n_lights,
                            float* out, int n, void* stream) {
  const size_t smem = (size_t)n_lights * LT_COLS * sizeof(float);
  if (n_lights < 0 || bwd_smem(n_lights) > SMEM_MAX) return -1;
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
