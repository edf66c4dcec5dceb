"""The whole-wave trace: state layout, scene tables, the plain version and
the dispatcher to the Hopper kernel.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_uber.py``:

  * :func:`uber_eligible` — the predicate of ``pallas_uber.py:1234-1267``
    (noise scenes are eligible, noise beside checker textures is not);
  * ``_scene_tables``, ``_search_tables``, ``_chunk_aabbs`` and
    :func:`make_ctx` (``:1294-1446``), with the cull grain fixed at
    ``TCC = 512`` triangles;
  * :func:`pack_tri_rows` and :func:`tri_cols` — the four coefficient
    tables and the double-sided flags packed into one row a triangle for
    the kernels' 16-byte loads, and the plain versions' column views of
    it (no JAX counterpart: the TPU took the tables as matrix operands);
  * :func:`pack_state` (``:1270``);
  * :func:`search_row_plain` — phase 1 (closest hit) for all rays at once,
    mirroring ``_search_row`` (``:121-343``) with its per-(128-ray row,
    TCC-triangle chunk) AABB cull and tie rules;
  * :func:`tile_core_plain` — ``_tile_core`` (``:500-548``);
  * :func:`trace_wave_plain` — the bounce loop of ``_make_trace_kernel``
    (``:876``) in plain torch: the plain version of ``csrc/trace_wave.cu``,
    optionally with the backward's residuals;
  * :func:`tile_core_vjp_plain` and :func:`trace_wave_bwd_plain` — the
    adjoint of one bounce and the reversed bounce loop of
    ``_make_trace_bwd_kernel`` (``:926``): the plain version of
    ``csrc/trace_wave_bwd.cu``;
  * :class:`TraceWave` — the ``torch.autograd.Function`` of the trace,
    the counterpart of ``_trace_call``'s ``custom_vjp`` (``:1069-1148``);
  * :func:`trace_wave` and :func:`trace_wave_bwd` — the dispatchers: CPU
    tensors take the plain versions, CUDA tensors the kernels (no
    fallback);
  * :func:`trace_wave_uber` — one sample wave with the per-chunk keying
    and padding of ``:1151-1218``;
  * :func:`fused_bounce_plain` and :func:`fused_bounce_bwd_plain` — one
    bounce of the trace and of its backward: the plain versions of TPU
    kernels D and D' (``_make_fused_kernel``, ``:568``, and
    ``_make_fused_bwd_kernel``, ``:619``); :class:`FusedBounce`, the
    ``custom_vjp`` of ``_fused_call`` (``:766``); :func:`bounce_uber`, the
    per-chunk path's bounce (``:1449``), with its dispatcher to the
    kernels;
  * the unfused bounce of ``bounce_uber`` under ``RRT_NO_UBER_FUSED=1``
    (``:1507-1545``): :func:`select_plain`, the plain version of TPU
    kernel E (``_make_select_kernel``, ``:346``, launched by
    ``_select_impl``, ``:392``; ``csrc/trace_wave.cu`` ``select_kernel``):
    phase 1 alone with the winner's row fetched; :func:`select`, its
    dispatcher; :class:`SelectRows`, the ``custom_vjp`` of ``_select_call``
    (``:436-474``); then ``_tile_planes`` and TPU kernel G
    (``ops/bounce.BouncePlanesLive``).

State layout: structure of arrays ``[N_STATE, N]`` float32 with planes
o(3) d(3) time alive L(3) beta(3) — a reshape of JAX's ``[14, CR, 128]``
plane stack; randoms ``[depth, 15, N]`` (9 uniforms then 6 normals).
Each chunk is padded to a multiple of 1024 rays with dead lanes.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops import gather
from rust_ray_tracer_tpu_torch.ops import search as search_ops
from rust_ray_tracer_tpu_torch.ops.bounce import (LIVE_TILE,
                                                  BouncePlanesLive,
                                                  light_table, live_tiles,
                                                  megakernels_off)
from rust_ray_tracer_tpu_torch.ops.bounce_core import (
    bounce_plane_core, bounce_plane_core_vjp)
from rust_ray_tracer_tpu_torch.ops.intersect import (
    KIND_QUAD, KIND_SPH, KIND_TRI, MATTR_ALBEDO, MATTR_EVEN, MATTR_FUZZ,
    MATTR_IOR, MATTR_ISCHK, MATTR_MKIND, MATTR_ODD, T_MIN, _tri_coeffs,
    mattr_noise_cols, winner_table)
from rust_ray_tracer_tpu_torch.ops.perlin import PerlinTables
from rust_ray_tracer_tpu_torch.ops.shade_core import LANES, LT_COLS
from rust_ray_tracer_tpu_torch.utils import rng as rngu

N_STATE = 14
N_RND = 15
TILE = LIVE_TILE        # rays per TPU tile: the per-chunk padding grain
ROWS_MAX = 4096         # eligibility: total winner-table rows
TCC = 512               # triangle rows per culled sweep chunk
TRI_PACK = 44           # floats a row of the kernels' triangle table
PRIM_PACK = 12          # floats a row of their sphere and quad tables
A_COL = 11              # uni column where the material-attr block starts
_RAY_BLOCK = 8192       # rays per block of the plain search (memory bound)


def ineligible_reason(scene) -> str | None:
    """Why the trace kernel (TPU kernel A) cannot render ``scene``, or
    None when it can: the predicate of ``pallas_uber.py:1234-1267``.
    Where such a scene goes instead is ``ops/integrator``'s choice
    (``split_reason``). The route flags are read at each call, as JAX
    reads them: ``RRT_NO_UBER=1``, ``RRT_NO_MEGAKERNEL=1`` and
    ``RRT_NO_PALLAS_SHADE=1`` send every scene off the trace kernel,
    ``RRT_UBER_NOISE=0`` the noise scenes."""
    flag = ("RRT_NO_UBER" if os.environ.get("RRT_NO_UBER", "") == "1"
            else megakernels_off())
    if flag:
        return f"{flag}=1: the trace kernel is switched off"
    if scene.n_media:
        return "media: the trace kernel has no free flight"
    if scene.img_data.shape[0]:
        return "image textures: the trace kernel has no image leaf"
    if (scene.n_lights + 1) * LT_COLS > LANES:
        return (f"{scene.n_lights} lights exceed the trace kernel's light "
                "table")
    if scene.perlin_vec.shape[0] and os.environ.get("RRT_UBER_NOISE",
                                                   "1") == "0":
        return "noise textures under RRT_UBER_NOISE=0"
    if scene.perlin_vec.shape[0] and scene.tex_even.shape[0]:
        return ("noise textures beside checker textures: the trace "
                "kernel's marble does not evaluate a checker's leaves")
    if scene.perlin_vec.shape[0] and unfused():
        return ("noise textures under RRT_NO_UBER_FUSED=1: the unfused "
                "bounce's kernels E and G have no marble")
    rows = scene.n_tris + scene.n_spheres + scene.n_quads
    if not 0 < rows <= ROWS_MAX:
        return f"{rows} primitive rows (trace kernel: 1..{ROWS_MAX})"
    return None


def unfused() -> bool:
    """``RRT_NO_UBER_FUSED=1``, read at each call as JAX reads it
    (``pallas_uber.py:1261, 1497``): the per-chunk bounce runs kernels E
    and G instead of D, and noise scenes leave the trace kernel."""
    return os.environ.get("RRT_NO_UBER_FUSED", "") == "1"


def uber_eligible(scene) -> bool:
    """Can the whole-wave trace kernel render this scene?"""
    return ineligible_reason(scene) is None


@dataclasses.dataclass
class TraceCtx:
    """Scene-derived tables of the trace, built once per render.

    ``uni`` [P, W] winner rows (pack(9), flip, mat, material attrs) with
    ``dflt`` [W] the miss default; the detached search tables, packed for
    the kernels' 16-byte loads: ``tri_pack`` [Tp, TRI_PACK] (det | u | v
    | t, 10 each, | dbl | 3 zeros; :func:`tri_cols` gives the plain
    versions' views), ``sph_pack`` [S, PRIM_PACK] (c0, c1-c0, t0,
    1/(t1-t0), r | 3 zeros; far pads), ``quad_pack`` [Q, PRIM_PACK] (q,
    u, v | 3 zeros); ``cab`` [Tp/TCC, 8] cull boxes; ``lt``
    [n_lights+1, LT_COLS] lights plus the background row; ``perlin`` the
    detached Perlin tables (0-length without noise), read when
    ``has_noise``.
    """

    uni: torch.Tensor
    dflt: torch.Tensor
    t_off: int
    s_off: int
    q_off: int
    tri_pack: torch.Tensor
    sph_pack: torch.Tensor
    quad_pack: torch.Tensor
    cab: torch.Tensor
    lt: torch.Tensor
    n_tris: int
    n_sph: int
    n_quad: int
    n_lights: int
    has_checker: bool
    has_noise: bool
    perlin: PerlinTables

    @property
    def n_tri_chunks(self) -> int:
        """Cull chunks holding real rows: the sweep's bound (an all-pad
        chunk's inverted box would pass the slab test)."""
        return -(-self.n_tris // TCC)


def _pad_rows(x, mult, value=0.0):
    n = x.shape[0]
    target = max(mult, -(-n // mult) * mult)
    if target == n:
        return x
    pad = torch.full((target - n,) + tuple(x.shape[1:]), value,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _scene_tables(scene):
    """(uni, dflt, offsets): the winner table in tri/sphere/quad row
    order (the kernel's global ids), padded to 8 rows —
    differentiable w.r.t. the scene."""
    uni, dflt, offsets = winner_table(scene)
    return _pad_rows(uni, 8), dflt, offsets


def _pad_cols(x, width):
    pad = torch.zeros((x.shape[0], width - x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1).contiguous()


def pack_tri_rows(det_t, u_t, v_t, t_t, dbl_t):
    """[T, TRI_PACK] float32 rows det | u | v | t (10 each) | dbl | 3 zeros
    of the coefficient tables [T, 10] and the double-sided flags [T, 1]:
    the trace kernels read a triangle as eleven 16-byte loads of one row
    (``csrc/trace_wave.cu``). Contiguous, so each row is 16-byte aligned
    where the tensor's storage is."""
    return _pad_cols(torch.cat([det_t, u_t, v_t, t_t, dbl_t], dim=1),
                     TRI_PACK)


def tri_cols(tri_pack):
    """(det, u, v, t [T, 10], dbl [T, 1]): the column views of the packed
    triangle rows that the plain versions read."""
    return tuple(tri_pack[:, 10 * k:10 * k + 10] for k in range(4)) + (
        tri_pack[:, 40:41],)


def _search_tables(scene):
    """Detached search tables, packed: triangles [Tp, TRI_PACK] padded to
    TCC rows (:func:`pack_tri_rows`), spheres [S, PRIM_PACK] with far
    pads, quads [Q, PRIM_PACK] with zero pads (three zero columns each)."""
    f32 = torch.float32
    dev = scene.device
    if scene.n_tris:
        det_c, u_c, v_c, t_c = _tri_coeffs(scene.tri_v0, scene.tri_e1,
                                           scene.tri_e2)
        tri = pack_tri_rows(det_c.T, u_c.T, v_c.T, t_c.T,
                            scene.tri_double.to(f32)[:, None])
    else:
        tri = torch.zeros((8, TRI_PACK), dtype=f32, device=dev)
    # pad rows are zeros -> det 0 -> always rejected
    tri = _pad_rows(tri, TCC)

    far = torch.zeros((8, 9), dtype=f32, device=dev)
    far[:, 0:3] = 1e30      # c0 = 1e30 -> disc = inf - inf = NaN: rejected
    s_n = scene.n_spheres
    if s_n:
        sph = search_ops.sphere_rows(scene)
        pad = (-s_n) % 8
        if pad:
            sph = torch.cat([sph, far[:pad]], dim=0)
    else:
        sph = far
    if scene.n_quads:
        quad = _pad_rows(torch.cat([scene.quad_q, scene.quad_u,
                                    scene.quad_v], dim=1), 8)
    else:
        quad = torch.zeros((8, 9), dtype=f32, device=dev)
    return tri, _pad_cols(sph, PRIM_PACK), _pad_cols(quad, PRIM_PACK)


def _chunk_aabbs(scene, tp: int):
    """[ceil(tp/TCC), 8] = (lo3, hi3, 0, 0) boxes over TCC-row chunks of
    the Morton-ordered triangle table; rows past the compiled count get
    inverted boxes so they never widen a real chunk's box."""
    n_chunks = max(1, -(-tp // TCC))
    dev = scene.device
    n = scene.n_tris
    if n == 0:
        return torch.zeros((n_chunks, 8), dtype=torch.float32, device=dev)
    v0 = scene.tri_v0
    c1 = v0 + scene.tri_e1
    c2 = v0 + scene.tri_e2
    lo3 = torch.minimum(torch.minimum(v0, c1), c2)
    hi3 = torch.maximum(torch.maximum(v0, c1), c2)
    padn = n_chunks * TCC - n
    lo3 = torch.cat([lo3, torch.full((padn, 3), torch.inf, device=dev)])
    hi3 = torch.cat([hi3, torch.full((padn, 3), -torch.inf, device=dev)])
    lo = lo3.reshape(n_chunks, TCC, 3).amin(dim=1)
    hi = hi3.reshape(n_chunks, TCC, 3).amax(dim=1)
    return torch.cat([lo, hi, torch.zeros((n_chunks, 2), device=dev)],
                     dim=1).contiguous()


def make_ctx(scene) -> TraceCtx:
    """Scene tables for the trace, built once per render. ``uni`` and
    ``lt`` stay in the autograd graph; the search tables are detached.
    Raises NotImplementedError for a scene the trace cannot render."""
    reason = ineligible_reason(scene)
    if reason is not None:
        raise NotImplementedError(
            f"TPU kernel A cannot render this scene: {reason} "
            "(ops/integrator.render_waves routes it)")
    uni, dflt, (t_off, s_off, q_off) = _scene_tables(scene)
    scene_s = dataclasses.replace(
        scene, **{f.name: getattr(scene, f.name).detach()
                  for f in dataclasses.fields(scene) if f.name != "camera"})
    tri_pack, sph_pack, quad_pack = _search_tables(scene_s)
    lt = light_table(scene)
    # the Perlin tables, detached (pallas_uber.py:1407-1416)
    perlin = PerlinTables(scene_s.perlin_vec.contiguous(), torch.stack(
        [scene_s.perlin_px, scene_s.perlin_py, scene_s.perlin_pz]))
    return TraceCtx(
        uni=uni.contiguous(), dflt=dflt.contiguous(), t_off=t_off,
        s_off=s_off, q_off=q_off, tri_pack=tri_pack, sph_pack=sph_pack,
        quad_pack=quad_pack, cab=_chunk_aabbs(scene_s, tri_pack.shape[0]),
        lt=lt,
        n_tris=scene.n_tris, n_sph=scene.n_spheres, n_quad=scene.n_quads,
        n_lights=scene.n_lights, has_checker=scene.tex_even.shape[0] > 0,
        has_noise=scene.perlin_vec.shape[0] > 0, perlin=perlin)


def pack_state(o, d, time, L, beta, alive):
    """[..., C, *] wavefront carry -> [N_STATE, ..., Cp] planes, Cp = C
    rounded up to a multiple of TILE; pad lanes are dead (all zero)."""
    pad = (-o.shape[-2]) % TILE
    cols = ([o[..., i] for i in range(3)] + [d[..., i] for i in range(3)]
            + [time, alive.to(o.dtype)] + [L[..., i] for i in range(3)]
            + [beta[..., i] for i in range(3)])
    return torch.nn.functional.pad(torch.stack(cols), (0, pad))


# ---------------------------------------------------------------------------
# plain version of the trace kernel
# ---------------------------------------------------------------------------

def _search_block(st, ctx):
    """Phase 1 for one block of rays (a multiple of 128): (kind, idx)."""
    ox, oy, oz, dx, dy, dz, time, alive = (st[i] for i in range(8))
    nb = ox.shape[0]
    dev = ox.device
    tmin = torch.full_like(ox, T_MIN)
    tmax = torch.where(alive > 0.5, torch.inf, -1.0)
    best = (torch.full_like(ox, torch.inf),
            torch.zeros(nb, dtype=torch.int32, device=dev),
            torch.zeros(nb, dtype=torch.int64, device=dev))
    if not bool((alive > 0.5).any()):
        return best[1], best[2]      # an all-dead block hits nothing

    if ctx.n_tris:
        # Plücker features [o, d, o x d, 1]
        f = (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
             ox * dy - oy * dx, torch.ones_like(ox))
        nt = ctx.n_tri_chunks * TCC
        valid, t = search_ops.tri_tests(
            f, tri_cols(ctx.tri_pack[:nt]), tmin, tmax)
        # per-(128-ray row, chunk) AABB cull: a chunk is swept for a row
        # when any live ray of the row enters its box
        big = torch.tensor(1e-30, device=dev)
        inv_d = [1.0 / torch.where(c.abs() < 1e-30, big, c)
                 for c in (dx, dy, dz)]
        cab = ctx.cab[:ctx.n_tri_chunks]
        ts0 = [(cab[:, a:a + 1] - oc) * iv
               for a, (oc, iv) in enumerate(zip((ox, oy, oz), inv_d))]
        ts1 = [(cab[:, 3 + a:4 + a] - oc) * iv
               for a, (oc, iv) in enumerate(zip((ox, oy, oz), inv_d))]
        mn = [torch.minimum(a, b) for a, b in zip(ts0, ts1)]
        mxs = [torch.maximum(a, b) for a, b in zip(ts0, ts1)]
        tn = torch.maximum(torch.maximum(mn[0], mn[1]),
                           torch.maximum(mn[2], tmin))
        tf = torch.minimum(torch.minimum(mxs[0], mxs[1]), mxs[2])
        hit = (tf >= tn) & (alive > 0.5)             # [chunks, B]
        swept = hit.reshape(hit.shape[0], nb // LANES, LANES).any(dim=2)
        swept = swept.repeat_interleave(LANES, dim=1)
        valid = valid & swept.repeat_interleave(TCC, dim=0)
        tt = torch.where(valid, t, torch.inf)
        loc_t, loc_i = search_ops.first_min(tt)
        best = search_ops.fold(best, loc_t, loc_i + ctx.t_off, KIND_TRI)

    if ctx.n_sph:
        loc_t, loc_i = search_ops.first_min(search_ops.sphere_tests(
            (ox, oy, oz, dx, dy, dz, time), ctx.sph_pack[:, :9], tmin,
            tmax))
        best = search_ops.fold(best, loc_t, loc_i + ctx.s_off, KIND_SPH)

    if ctx.n_quad:
        loc_t, loc_i = search_ops.first_min(search_ops.quad_tests(
            (ox, oy, oz, dx, dy, dz), ctx.quad_pack[:, :9], tmin, tmax))
        best = search_ops.fold(best, loc_t, loc_i + ctx.q_off, KIND_QUAD)

    _, kind, idx = best
    return kind, torch.where(kind > 0, idx, torch.zeros_like(idx))


def search_row_plain(st, ctx: TraceCtx):
    """Phase 1 for all rays of ``st`` [N_STATE, N] (N a multiple of 128):
    (kind int32 [N], winner row int64 [N]; 0 on a miss).

    Triangles fold lexicographically on (t, row) — the lowest row wins a
    tie — then spheres and quads with strict ``<``, so a tie goes
    triangle > sphere > quad. Dead rays get an empty window (tmax = -1).
    """
    st = st.detach()
    outs = [_search_block(st[:8, i:i + _RAY_BLOCK], ctx)
            for i in range(0, st.shape[1], _RAY_BLOCK)]
    return (torch.cat([k for k, _ in outs]), torch.cat([i for _, i in outs]))


def _tile_planes(st, rnd_b, selv, ctx: TraceCtx):
    """``_tile_core``'s plane assembly: (P, mkind, flags)."""
    A = A_COL
    tminp = torch.full_like(st[0:1], T_MIN)
    tmaxp = torch.where(st[7:8] > 0.5, torch.inf, -1.0)
    parts = [st[0:7], tminp, tmaxp, selv[0:9], torch.zeros_like(st[0:1]),
             selv[A + MATTR_ALBEDO.start:A + MATTR_ALBEDO.stop],
             selv[A + MATTR_FUZZ:A + MATTR_FUZZ + 1],
             selv[A + MATTR_IOR:A + MATTR_IOR + 1],
             st[8:14], rnd_b, st[7:8]]
    flags = (selv[9] > 0.5).to(torch.int32)
    if ctx.has_checker:
        parts += [selv[A + MATTR_EVEN.start:A + MATTR_EVEN.stop],
                  selv[A + MATTR_ODD.start:A + MATTR_ODD.stop]]
        flags = flags | ((selv[A + MATTR_ISCHK] > 0.5).to(torch.int32) << 1)
    if ctx.has_noise:
        sc_col, nz_col = mattr_noise_cols(ctx.has_checker)
        parts += [selv[A + sc_col:A + sc_col + 1]]
        flags = flags | ((selv[A + nz_col] > 0.5).to(torch.int32) << 2)
    mkind = selv[A + MATTR_MKIND].to(torch.int32)
    return torch.cat(parts, dim=0), mkind, flags


def tile_core_plain(st, rnd_b, selv, kind, ctx: TraceCtx):
    """Hit attributes, shading and the estimator update for one bounce.

    ``st`` [N_STATE, N], ``rnd_b`` [15, N], ``selv`` [W, N] winner rows
    (miss lanes already defaulted), ``kind`` [N]. Returns the next state.
    """
    P, mkind, flags = _tile_planes(st, rnd_b, selv, ctx)
    out = bounce_plane_core(P, kind, mkind, flags, ctx.lt, ctx.n_lights,
                            ctx.has_checker, ctx.has_noise, ctx.perlin)
    return torch.cat([out[0:6], st[6:7], out[12:13], out[6:9], out[9:12]])


def tile_core_vjp_plain(st, rnd_b, selv, kind, ctx: TraceCtx, g):
    """Adjoint of :func:`tile_core_plain` for the next-state cotangent
    ``g`` [N_STATE, N]: (dst [N_STATE, N], dselv [W, N], dlt like
    ``ctx.lt``).

    Counterpart of ``jax.vjp(core, P, selv, lt)`` in
    ``_make_trace_bwd_kernel`` (``pallas_uber.py:971-976``), composed
    from :func:`ops.bounce_core.bounce_plane_core_vjp`. The shutter time
    passes through (plus a moving sphere's share); the alive plane takes
    no cotangent. The randoms take none, and the flag, material and kind
    columns of ``selv`` take zeros. A noise lane's scale cotangent goes to
    its winner row's scale column (and on through ``uni`` to
    ``tex_scale``); the Perlin tables take none.
    """
    A = A_COL
    P, mkind, flags = _tile_planes(st, rnd_b, selv, ctx)
    cot = torch.cat([g[0:6], g[8:11], g[11:14], g[7:8]])
    dP, dlt = bounce_plane_core_vjp(P, kind, mkind, flags, ctx.lt,
                                    ctx.n_lights, ctx.has_checker, cot,
                                    ctx.has_noise, ctx.perlin)
    dst = torch.cat([dP[0:6], g[6:7] + dP[6:7], torch.zeros_like(g[7:8]),
                     dP[24:30]])
    dselv = torch.zeros_like(selv)
    dselv[0:9] = dP[9:18]
    dselv[A + MATTR_ALBEDO.start:A + MATTR_ALBEDO.stop] = dP[19:22]
    dselv[A + MATTR_FUZZ] = dP[22]
    dselv[A + MATTR_IOR] = dP[23]
    if ctx.has_checker:
        dselv[A + MATTR_EVEN.start:A + MATTR_EVEN.stop] = dP[46:49]
        dselv[A + MATTR_ODD.start:A + MATTR_ODD.stop] = dP[49:52]
    if ctx.has_noise:
        dselv[A + mattr_noise_cols(ctx.has_checker)[0]] = dP[-1]
    return dst, dselv, dlt


def _select_rows(kind, idx, ctx: TraceCtx):
    """Winner rows [W, N]: ``uni[idx]``, the miss default where kind is 0
    (``_rebuild_row``, ``pallas_uber.py:551-565``)."""
    rows = ctx.uni[idx.long()].T
    return torch.where(kind[None] > 0, rows, ctx.dflt[:, None])


def _live_tiles(alive):
    """[N] bool: the ray's 1024-ray tile holds a live ray — the liveness
    predicate of the TPU trace kernels (``pallas_uber.py:889, 945``)."""
    return torch.repeat_interleave(live_tiles(alive) > 0, TILE)


def trace_wave_plain(st0, rnd, ctx: TraceCtx, depth: int,
                     residuals: bool = False):
    """``depth`` bounces of every ray: phase 1, winner-row fetch, then
    :func:`tile_core_plain`. Returns the final state [N_STATE, N]; with
    ``residuals``, also the backward's residuals as
    ``_make_trace_kernel`` writes them (``pallas_uber.py:887-916``):
    ``hist`` [depth, N_STATE, N] (bounce b's input state, written for
    every bounce), ``kind`` and ``idx`` [depth, N] int32 (0 on a miss and
    in a dead tile)."""
    st = st0
    hist, kinds, idxs = [], [], []
    for b in range(depth):
        kind, idx = search_row_plain(st, ctx)
        if residuals:
            hist.append(st)
            kinds.append(kind)
            idxs.append(idx.to(torch.int32))
        selv = _select_rows(kind, idx, ctx)
        st = tile_core_plain(st, rnd[b], selv, kind, ctx)
    if not residuals:
        return st
    return st, torch.stack(hist), torch.stack(kinds), torch.stack(idxs)


def trace_wave_bwd_plain(hist, rnd, kind, idx, ctx: TraceCtx, g):
    """The backward of the trace from its residuals: (dst [N_STATE, N],
    duni like ``ctx.uni``, dlt like ``ctx.lt``) for the final-state
    cotangent ``g`` [N_STATE, N].

    The plain version of ``csrc/trace_wave_bwd.cu``, mirroring
    ``_make_trace_bwd_kernel`` (``pallas_uber.py:926-1014``) and
    ``_trace_bwd``'s outputs (``:1140-1145``): bounces replay in reverse
    from ``hist``; a tile with no live ray keeps its cotangent; the
    winner rows are rebuilt from (kind, idx); each found ray's row
    cotangent is added into its ``uni`` row and every ray's light-table
    cotangent into ``dlt``. The miss default takes none.
    """
    depth = hist.shape[0]
    dst = g
    duni = torch.zeros_like(ctx.uni)
    dlt = torch.zeros_like(ctx.lt)
    for b in reversed(range(depth)):
        live = _live_tiles(hist[b, 7])
        if not bool(live.any()):
            continue
        found = kind[b] > 0
        selv = _select_rows(kind[b], idx[b], ctx)
        d_st, dselv, dlt_b = tile_core_vjp_plain(hist[b], rnd[b], selv,
                                                 kind[b], ctx, dst)
        dst = torch.where(live[None], d_st, dst)
        duni.index_add_(0, idx[b][found].long(), dselv[:, found].T)
        dlt = dlt + dlt_b
    return dst, duni, dlt


def bwd_reduce_plain(contrib, keys, perm, p_rows: int, part):
    """Plain version of ``bwd_reduce`` (``csrc/trace_wave_bwd.cu``): duni
    [P, W] with row r the sum of the terms ``contrib.reshape(-1, W)[perm[
    j]]`` whose sorted key ``keys[j]`` is r (a key >= P names no row), and
    dlt [(n_lights + 1) * 14] the sum of the per-block partials ``part``;
    ``keys`` and ``perm`` as ``kernels.reduce_order`` returns them."""
    w = contrib.shape[-1]
    found = keys < p_rows
    duni = torch.zeros((p_rows, w), dtype=contrib.dtype,
                       device=contrib.device)
    duni.index_add_(0, keys[found].long(),
                    contrib.reshape(-1, w)[perm[found].long()])
    return duni, part.sum(dim=0)


REDUCE_PIECE = 1024     # sorted terms a block of B' sums (csrc PIECE)
REDUCE_THREADS = 256    # threads of a block of B' (csrc RED)
_PER = REDUCE_PIECE // REDUCE_THREADS
_WARP = 32


def bwd_reduce_replay(contrib, keys, perm, p_rows: int, part):
    """What ``bwd_reduce_kernel`` computes, in its order of operations, as
    torch ops on any device (float32 adds, so the kernel's sums equal it
    bit for bit): the sorted terms cut into pieces of
    :data:`REDUCE_PIECE`; in a piece thread t adds each run of equal keys
    among its terms 4t .. 4t + 3 from 0, left to right; the threads' last
    runs go through a segmented Hillis-Steele scan in each warp of 32
    (lane l takes lane l - s's value before its own, s = 1, 2, 4, 8, 16,
    unless a run starts between them), then the carry of the warps before
    in warp order; a thread's first run that came from the thread before
    is thread t - 1's scanned sum plus its own; a run that crosses pieces
    is its first piece's partial plus the next pieces' in piece order. The
    light table: thread t adds the partials' rows t, t + 256, ... from 0,
    then a tree (t += t + s for s = 128, 64, ..., 1). Arguments and
    results as :func:`bwd_reduce_plain`."""
    w = contrib.shape[-1]
    dev = contrib.device
    m = keys.numel()
    duni = torch.zeros((p_rows, w), dtype=torch.float32, device=dev)
    dlt = _light_sum_replay(part)
    if m == 0:
        return duni, dlt
    pieces = -(-m // REDUCE_PIECE)
    n_thr = pieces * REDUCE_THREADS
    key = keys.long()
    val = contrib.reshape(-1, w)[perm.long()]
    # each thread's terms [T, PER] (masked past m), its first term p0
    p0 = torch.arange(n_thr, device=dev) * _PER
    cnt = (m - p0).clamp(0, _PER)
    pos = (p0[:, None] + torch.arange(_PER, device=dev)).clamp(max=m - 1)
    kk, vv = key[pos], val[pos]
    act = torch.arange(_PER, device=dev) < cnt[:, None]
    base = p0 // REDUCE_PIECE * REDUCE_PIECE
    prev = key[(p0 - 1).clamp(0, m - 1)]
    s = torch.zeros_like(act)
    s[:, 0] = act[:, 0] & ((p0 == base) | (prev != kk[:, 0]))
    s[:, 1:] = act[:, 1:] & (kk[:, 1:] != kk[:, :-1])
    end = torch.minimum(base + REDUCE_PIECE, torch.full_like(base, m))
    last = (p0 + cnt - 1).clamp(0, m - 1)
    nxt = key[(p0 + cnt).clamp(max=m - 1)]
    tail_ends = (cnt > 0) & ((p0 + cnt == end) | (nxt != key[last]))
    head = s[:, 1:].any(1) & ~s[:, 0]
    f = s.any(1) | (cnt == 0)
    # the thread-local runs; a run ending inside a thread is written as
    # (key, value), unless it is the head, kept for after the scan
    writes = []
    acc = torch.zeros((n_thr, w), dtype=torch.float32, device=dev)
    hv = torch.zeros_like(acc)
    first = torch.ones(n_thr, dtype=torch.bool, device=dev)
    for i in range(_PER):
        if i > 0:
            b = s[:, i]
            keep = b & first & ~s[:, 0]
            hv = torch.where(keep[:, None], acc, hv)
            out = b & ~(first & ~s[:, 0])
            writes.append((out, kk[:, i - 1], acc))
            first = first & ~b
            acc = torch.where(b[:, None], torch.zeros_like(acc), acc)
        acc = torch.where(act[:, i, None], acc + vv[:, i], acc)
    # the warps' segmented scan of the tails, then the warps' carries
    tv = acc.reshape(pieces, REDUCE_THREADS // _WARP, _WARP, w)
    g = f.reshape(pieces, REDUCE_THREADS // _WARP, _WARP)
    lane = torch.arange(_WARP, device=dev)[None, None, :]
    for st in (1, 2, 4, 8, 16):
        up = torch.roll(tv, st, dims=2)
        gu = torch.roll(g, st, dims=2)
        on = lane >= st
        tv = torch.where((on & ~g)[..., None], up + tv, tv)
        g = g | (on & gu)
    n_warps = REDUCE_THREADS // _WARP
    carry = torch.zeros((pieces, n_warps, w), dtype=torch.float32,
                        device=dev)
    carry[:, 0] = carry[:, 1] = tv[:, 0, _WARP - 1]
    for j in range(1, n_warps - 1):
        carry[:, j + 1] = torch.where(g[:, j, _WARP - 1, None],
                                      tv[:, j, _WARP - 1],
                                      carry[:, j] + tv[:, j, _WARP - 1])
    warp0 = torch.arange(n_warps, device=dev)[None, :, None] == 0
    ssum = torch.where((warp0 | g)[..., None], tv, carry[:, :, None] + tv)
    sprev = torch.roll(ssum, 1, dims=2)
    sprev[:, :, 0] = carry
    ssum = ssum.reshape(n_thr, w)
    sprev = sprev.reshape(n_thr, w)
    writes.append((tail_ends, key[last], ssum))
    writes.append((head, kk[:, 0], sprev + hv))
    # each piece's first run began before it (lead), its last goes on
    # (trail): their sums go to the piece's partial slots 0 and 1
    pb = torch.arange(pieces, device=dev) * REDUCE_PIECE
    pe = torch.minimum(pb + REDUCE_PIECE, torch.full_like(pb, m))
    kfirst, klast = key[pb], key[pe - 1]
    lead = (pb > 0) & (key[(pb - 1).clamp(min=0)] == kfirst)
    trail = (pe < m) & (klast < p_rows) & (key[pe.clamp(max=m - 1)] == klast)
    partial = torch.zeros((pieces, 2, w), dtype=torch.float32, device=dev)
    piece = torch.arange(n_thr, device=dev) // REDUCE_THREADS
    for on, r, v in writes:
        on = on & (r < p_rows)
        to0 = on & lead[piece] & (r == kfirst[piece])
        to1 = on & ~to0 & trail[piece] & (r == klast[piece])
        inside = on & ~to0 & ~to1
        duni[r[inside]] = v[inside]
        partial[piece[to0], 0] = v[to0]
        partial[piece[to1], 1] = v[to1]
    # the runs that cross pieces: first piece's slot 1, then slot 0s
    starts = trail & ~(lead & (klast == kfirst))
    for q in torch.nonzero(starts).flatten().tolist():
        r = int(klast[q])
        q1 = q + 1
        while q1 + 1 < pieces and bool(lead[q1 + 1]) and \
                int(kfirst[q1 + 1]) == r:
            q1 += 1
        total = partial[q, 1]
        for q_ in range(q + 1, q1 + 1):
            total = total + partial[q_, 0]
        duni[r] = total
    return duni, dlt


def _light_sum_replay(part):
    """``bwd_reduce_kernel``'s light-table sums of ``part`` [n_part, ltn]
    in its order (:func:`bwd_reduce_replay`)."""
    n_part, ltn = part.shape
    acc = torch.zeros((REDUCE_THREADS, ltn), dtype=torch.float32,
                      device=part.device)
    for j0 in range(0, n_part, REDUCE_THREADS):
        rows = part[j0:j0 + REDUCE_THREADS]
        acc[:rows.shape[0]] = acc[:rows.shape[0]] + rows
    h = REDUCE_THREADS // 2
    while h > 0:
        acc[:h] = acc[:h] + acc[h:2 * h]
        h //= 2
    return acc[0].clone()


def _trace_forward(st0, rnd, ctx: TraceCtx, depth: int, residuals: bool):
    dev = st0.device.type
    if dev == "cpu":
        return trace_wave_plain(st0, rnd, ctx, depth, residuals=residuals)
    if dev != "cuda":
        raise ValueError(f"unsupported device {st0.device}")
    from rust_ray_tracer_tpu_torch.kernels import trace_kernel
    return trace_kernel(ctx)(st0, rnd, ctx, depth, residuals=residuals)


def trace_wave_bwd(hist, rnd, kind, idx, ctx: TraceCtx, g):
    """The trace's backward: :func:`trace_wave_bwd_plain` for CPU
    tensors, the Hopper kernels (``csrc/trace_wave_bwd.cu``: the adjoint
    kernel, then the fixed-order reduction of the table cotangents) for
    CUDA tensors."""
    dev = g.device.type
    if dev == "cpu":
        return trace_wave_bwd_plain(hist, rnd, kind, idx, ctx, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    from rust_ray_tracer_tpu_torch.kernels import trace_backward
    return trace_backward(hist, rnd, kind, idx, ctx, g)


class TraceWave(torch.autograd.Function):
    """The trace as a differentiable function of ``st0``, ``uni`` and
    ``lt`` — ``_trace_call``'s ``custom_vjp`` (``pallas_uber.py:1069-1148``).
    The forward saves the residuals (``hist``, ``kind``, ``idx``); the
    backward replays them through :func:`trace_wave_bwd`. The randoms,
    the miss default and the search tables take no gradient (JAX returns
    zeros for them)."""

    @staticmethod
    def forward(fctx, st0, rnd, uni, lt, ctx: TraceCtx, depth: int):
        stf, hist, kind, idx = _trace_forward(st0, rnd, ctx, depth, True)
        fctx.save_for_backward(hist, rnd, kind, idx)
        fctx.trace_ctx = ctx
        return stf

    @staticmethod
    def backward(fctx, g):
        hist, rnd, kind, idx = fctx.saved_tensors
        dst, duni, dlt = trace_wave_bwd(hist, rnd, kind, idx,
                                        fctx.trace_ctx, g.contiguous())
        return dst, None, duni, dlt, None, None


def trace_wave(st0, rnd, ctx: TraceCtx, depth: int):
    """The wave's bounce loop: the plain version for CPU tensors, the
    Hopper kernel (``csrc/trace_wave.cu``, its noise variant for a scene
    with Noise textures) for CUDA tensors. When a
    gradient is wanted it runs as :class:`TraceWave` (forward with
    residuals, backward by :func:`trace_wave_bwd`); otherwise the forward
    writes no residuals."""
    if st0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {st0.device}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (st0, ctx.uni, ctx.lt)):
        return TraceWave.apply(st0, rnd, ctx.uni, ctx.lt, ctx, depth)
    return _trace_forward(st0, rnd, ctx, depth, False)


def chunk_randoms(scene, keys, chunk_size: int, depth: int,
                  lanes: int | None = None):
    """[depth, 15 + M, K * lanes] randoms of the chunks whose CHUNK-stream
    keys are ``keys`` [K, 2], chunk-major, each chunk padded from
    ``chunk_size`` to ``lanes`` (default: no padding) with zeros: per
    bounce 9 uniforms (SCATTER), 6 normals (FUZZ), then for a scene with M
    media M uniforms (MEDIUM). Every chunk's ``depth`` bounces are drawn
    at once, keyed by (chunk key, bounce) exactly as the JAX package draws
    them per bounce (``integrator._wave_bounce_randoms``,
    ``integrator.py:396-422``; ``pallas_uber.bounce_uber``)."""
    lanes = chunk_size if lanes is None else lanes
    bk = rngu.bounce_key(keys[:, None, :],
                         torch.arange(depth, device=keys.device))
    cols = [rngu.uniform(rngu.stream(bk, rngu.SCATTER), (chunk_size, 9)),
            rngu.normal(rngu.stream(bk, rngu.FUZZ), (chunk_size, 6))]
    if scene.n_media:
        cols.append(rngu.uniform(rngu.stream(bk, rngu.MEDIUM),
                                 (chunk_size, scene.n_media)))
    rnd = torch.nn.functional.pad(                           # [D, R, K, Cp]
        torch.cat(cols, dim=-1).permute(1, 3, 0, 2), (0, lanes - chunk_size))
    return rnd.reshape(depth, rnd.shape[1], -1).contiguous()


def chunk_state(o, d, t):
    """[N_STATE, K, Cp] primary state of the camera rays ``o``, ``d`` [K,
    C, 3], ``t`` [K, C]: L 0, beta 1, alive; each chunk padded to a
    multiple of TILE lanes with dead ones."""
    return pack_state(o, d, t, torch.zeros_like(o), torch.ones_like(o),
                      torch.ones_like(t, dtype=torch.bool))


def wave_inputs(scene, wkey, width: int, height: int, depth: int,
                chunk_size: int):
    """(st0 [N_STATE, N], rnd [depth, 15 + M, N]) of one sample wave, N =
    n_chunks * Cp: camera rays and randoms keyed by (wave key, global
    chunk id, bounce) exactly as the JAX package draws them
    (:func:`chunk_randoms`) — no MEDIUM draws for the trace kernel's
    scenes."""
    n = width * height
    n_chunks = -(-n // chunk_size)
    dev = wkey.device
    ids = torch.arange(n_chunks, device=dev)
    o, d, t, ckey = cam_ops.camera_rays_for_chunks(
        scene.camera, wkey, ids, chunk_size, width, height)
    st = chunk_state(o, d, t)                                # [14, K, Cp]
    rnd = chunk_randoms(scene, rngu.stream(ckey, rngu.CHUNK), chunk_size,
                        depth, st.shape[-1])
    return st.reshape(N_STATE, -1), rnd


# ---------------------------------------------------------------------------
# one uber bounce (TPU kernel D) and its backward (D')
# ---------------------------------------------------------------------------

def fused_bounce_plain(st, rnd_b, ctx: TraceCtx):
    """One bounce of :func:`trace_wave_plain` from ``st`` [N_STATE, N]
    with this bounce's randoms ``rnd_b`` [15, N]: (st2 [N_STATE, N], kind,
    idx [N] int32; 0 on a miss and for a dead ray) — the plain version of
    kernel D (``csrc/trace_wave.cu`` ``fused_bounce_kernel``), mirroring
    ``_make_fused_kernel`` (``pallas_uber.py:568-610``): phase 1, the
    winner row with the miss default, ``_tile_core``. A dead ray passes
    its state through (JAX's dead-tile pass-through is that identity)."""
    st2, _, kind, idx = trace_wave_plain(st, rnd_b[None], ctx, 1,
                                         residuals=True)
    return st2, kind[0], idx[0]


def fused_bounce_bwd_plain(st, rnd_b, kind, idx, ctx: TraceCtx, g):
    """The backward of one uber bounce from its input state ``st``, its
    randoms and winners, for the next-state cotangent ``g`` [N_STATE, N]:
    (dst [N_STATE, N], duni like ``ctx.uni``, dlt like ``ctx.lt``) — one
    bounce of :func:`trace_wave_bwd_plain`, the plain version of kernel D'
    (``fused_bounce_bwd_kernel``), mirroring ``_make_fused_bwd_kernel``
    and ``_fused_bwd`` (``pallas_uber.py:619-710, 787-846``): a 1024-ray
    tile with no live ray keeps ``g``; the selection, the search tables,
    the randoms and the Perlin tables take none."""
    return trace_wave_bwd_plain(st[None], rnd_b[None], kind[None],
                                idx[None], ctx, g)


def _fused_forward(st, rnd_b, ctx: TraceCtx):
    dev = st.device.type
    if dev == "cpu":
        return fused_bounce_plain(st, rnd_b, ctx)
    if dev != "cuda":
        raise ValueError(f"unsupported device {st.device}")
    from rust_ray_tracer_tpu_torch.kernels import fused_bounce_kernel
    return fused_bounce_kernel(ctx)(st, rnd_b, ctx)


def fused_bounce_bwd(st, rnd_b, kind, idx, ctx: TraceCtx, g):
    """One uber bounce's backward: :func:`fused_bounce_bwd_plain` for CPU
    tensors, kernel D' and the fixed-order sums of B' for CUDA tensors."""
    dev = g.device.type
    if dev == "cpu":
        return fused_bounce_bwd_plain(st, rnd_b, kind, idx, ctx, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    from rust_ray_tracer_tpu_torch.kernels import fused_bounce_backward
    return fused_bounce_backward(st, rnd_b, kind, idx, ctx, g)


class FusedBounce(torch.autograd.Function):
    """One uber bounce as a differentiable function of ``st``, ``uni``
    and ``lt`` — ``_fused_call``'s ``custom_vjp``
    (``pallas_uber.py:766-846``). The forward saves (st, rnd, kind, idx),
    the residual set of JAX's remat policy (the winners are its
    ``isect_sel``); the backward runs :func:`fused_bounce_bwd`. The
    randoms, the miss default and the search tables take no gradient."""

    @staticmethod
    def forward(fctx, st, rnd_b, uni, lt, ctx: TraceCtx):
        st2, kind, idx = _fused_forward(st, rnd_b, ctx)
        fctx.save_for_backward(st, rnd_b, kind, idx)
        fctx.trace_ctx = ctx
        return st2

    @staticmethod
    def backward(fctx, g):
        st, rnd_b, kind, idx = fctx.saved_tensors
        dst, duni, dlt = fused_bounce_bwd(st, rnd_b, kind, idx,
                                          fctx.trace_ctx, g.contiguous())
        return dst, None, duni, dlt, None


# ---------------------------------------------------------------------------
# the unfused uber bounce: phase 1 (TPU kernel E), then kernel G
# ---------------------------------------------------------------------------

def select_plain(st, ctx: TraceCtx):
    """Phase 1 of every lane of ``st`` [>= 8, N] (o, d, time, alive; N a
    multiple of 128) and the winners' rows: (selv [W, N], kind, idx [N]
    int32), W = ``uni``'s columns. A found lane's plane column is its row
    of ``uni``, a miss's ``dflt`` — the plain version of kernel E
    (``csrc/trace_wave.cu`` ``select_kernel``), mirroring
    ``_make_select_kernel`` (``pallas_uber.py:346-381``): the search of
    :func:`search_row_plain`, the fetch of ``_select_rows``. A dead ray
    finds nothing (kind 0, idx 0, ``dflt``), so a tile with no live ray
    gives what the kernel's dead-tile branch (``:357-362``) writes."""
    kind, idx = search_row_plain(st, ctx)
    return _select_rows(kind, idx, ctx), kind, idx.to(torch.int32)


def select(st, ctx: TraceCtx):
    """Phase 1 and the winners' rows of ``st`` [8, N]: :func:`select_plain`
    for CPU tensors, kernel E for CUDA tensors (no fallback)."""
    dev = st.device.type
    if dev == "cpu":
        return select_plain(st, ctx)
    if dev != "cuda":
        raise ValueError(f"unsupported device {st.device}")
    from rust_ray_tracer_tpu_torch.kernels import select_kernel
    return select_kernel(st, ctx)


class SelectRows(torch.autograd.Function):
    """Phase 1 and the winners' rows as a function of ``uni``, the only
    input that takes a gradient — ``_select_call``'s ``custom_vjp``
    (``pallas_uber.py:436-474``). The forward is :func:`select` on the
    detached state; the backward (``_select_bwd``, ``:454-471``) sums each
    found lane's row cotangent into its ``uni`` row by
    :func:`ops.gather.row_sums` (B' on the card), in a fixed order. The
    state, the miss default and the search tables take none."""

    @staticmethod
    def forward(fctx, st, uni, ctx: TraceCtx):
        selv, kind, idx = select(st, ctx)
        fctx.save_for_backward(kind, idx)
        fctx.p_rows = uni.shape[0]
        fctx.mark_non_differentiable(kind, idx)
        return selv, kind, idx

    @staticmethod
    def backward(fctx, g_selv, _g_kind, _g_idx):
        kind, idx = fctx.saved_tensors
        p = fctx.p_rows
        # a miss goes to the extra row p, which is dropped
        rows = torch.where(kind > 0, idx.long(), p)
        return None, gather.row_sums(g_selv.T, rows, p + 1)[:p], None


def unfused_bounce(st, rnd_b, ctx: TraceCtx):
    """The next state [N_STATE, N] of ``st`` through kernels E and G:
    ``bounce_uber``'s ``RRT_NO_UBER_FUSED=1`` branch
    (``pallas_uber.py:1507-1545``). The liveness of each 1024-lane tile
    (``:1490-1492``), phase 1 on the detached state (:class:`SelectRows`),
    the planes of ``_tile_planes``, then G (``ops/bounce.BouncePlanesLive``)
    and the state's order."""
    if ctx.has_noise:
        raise ValueError("the unfused bounce has no marble: under "
                         "RRT_NO_UBER_FUSED=1 a noise scene takes the split "
                         "route (make_ctx refuses it)")
    tlive = live_tiles(st[7])
    selv, kind, _ = SelectRows.apply(st[0:8].detach(), ctx.uni, ctx)
    P, mkind, flags = _tile_planes(st, rnd_b, selv, ctx)
    out = BouncePlanesLive.apply(P, kind, mkind, flags, ctx.lt, ctx.n_lights,
                                 tlive)
    return torch.cat([out[0:6], st[6:7], out[12:13], out[6:9], out[9:12]])


def bounce_uber(scene, bkey_or_rnd, st, ctx: TraceCtx | None = None):
    """One uber bounce of every lane of ``st`` [N_STATE, N] (whole
    chunks, each padded to a multiple of TILE lanes): the next state.
    Counterpart of ``pallas_uber.bounce_uber`` (``:1449-1504``).
    ``bkey_or_rnd`` is this bounce's randoms [15, N], or a bounce key [2]
    from which they are drawn for all N lanes as JAX draws them (9
    SCATTER uniforms, 6 FUZZ normals). CPU tensors take
    :func:`fused_bounce_plain`, CUDA tensors kernel D (no fallback); when a
    gradient is wanted the bounce runs as :class:`FusedBounce`. Under
    ``RRT_NO_UBER_FUSED=1`` it runs :func:`unfused_bounce` (E, then G;
    their plain versions on the CPU)."""
    if st.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {st.device}")
    if ctx is None:
        ctx = make_ctx(scene)
    rnd_b = bkey_or_rnd
    if rnd_b.dim() == 1:
        n = st.shape[1]
        rnd_b = torch.cat(
            [rngu.uniform(rngu.stream(bkey_or_rnd, rngu.SCATTER), (n, 9)),
             rngu.normal(rngu.stream(bkey_or_rnd, rngu.FUZZ), (n, 6))],
            dim=1).T.contiguous()
    if unfused():
        return unfused_bounce(st, rnd_b, ctx)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (st, ctx.uni, ctx.lt)):
        return FusedBounce.apply(st, rnd_b, ctx.uni, ctx.lt, ctx)
    return _fused_forward(st, rnd_b, ctx)[0]


def wave_radiance(stf, width: int, height: int, chunk_size: int):
    """Final state -> [n_chunks * chunk_size, 3] radiance rows
    (chunk-major, pad tail included)."""
    n_chunks = -(-(width * height) // chunk_size)
    cp = stf.shape[1] // n_chunks
    L = stf[8:11].reshape(3, n_chunks, cp)[:, :, :chunk_size]
    return L.permute(1, 2, 0).reshape(n_chunks * chunk_size, 3)


def trace_wave_uber(scene, wkey, width: int, height: int, depth: int,
                    chunk_size: int, ctx: TraceCtx | None = None):
    """One full sample wave through :func:`trace_wave` — the
    [n_chunks * chunk_size, 3] radiance rows (the caller crops the tail)."""
    if ctx is None:
        ctx = make_ctx(scene)
    st0, rnd = wave_inputs(scene, wkey, width, height, depth, chunk_size)
    stf = trace_wave(st0, rnd, ctx, depth)
    return wave_radiance(stf, width, height, chunk_size)
