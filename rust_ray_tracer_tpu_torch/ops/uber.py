"""The whole-wave trace: state layout, scene tables, the plain version and
the dispatcher to the Hopper kernel.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_uber.py``:

  * :func:`uber_eligible` — the predicate of ``pallas_uber.py:1234-1267``
    (noise scenes refused until the marble kernel is ported, ROADMAP
    queue 2 C);
  * ``_scene_tables``, ``_search_tables``, ``_chunk_aabbs`` and
    :func:`make_ctx` (``:1294-1446``), with the cull grain fixed at
    ``TCC = 512`` triangles;
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
    and padding of ``:1151-1218``.

State layout: structure of arrays ``[N_STATE, N]`` float32 with planes
o(3) d(3) time alive L(3) beta(3) — a reshape of JAX's ``[14, CR, 128]``
plane stack; randoms ``[depth, 15, N]`` (9 uniforms then 6 normals).
Each chunk is padded to a multiple of 1024 rays with dead lanes.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops.bounce_core import (
    bounce_plane_core, bounce_plane_core_vjp)
from rust_ray_tracer_tpu_torch.ops.intersect import (
    KIND_QUAD, KIND_SPH, KIND_TRI, MATTR_ALBEDO, MATTR_EVEN, MATTR_FUZZ,
    MATTR_IOR, MATTR_ISCHK, MATTR_MKIND, MATTR_ODD, T_MIN, TRI_DET_EPS,
    _mat_attr_table, _tri_coeffs)
from rust_ray_tracer_tpu_torch.ops.shade_core import LANES, LT_COLS, \
    _light_table
from rust_ray_tracer_tpu_torch.utils import rng as rngu

N_STATE = 14
N_RND = 15
TILE = 8 * LANES        # rays per TPU tile: the per-chunk padding grain
ROWS_MAX = 4096         # eligibility: total winner-table rows
TCC = 512               # triangle rows per culled sweep chunk
A_COL = 11              # uni column where the material-attr block starts
_RAY_BLOCK = 8192       # rays per block of the plain search (memory bound)


def ineligible_reason(scene) -> str | None:
    """Why the trace kernel cannot render ``scene`` (naming the unported
    TPU kernel), or None when it can."""
    if scene.n_media:
        return ("media need the split-path search and bounce kernels "
                "(TPU kernels F and M, ROADMAP queue 2)")
    if scene.img_data.shape[0]:
        return ("image textures need the shade+update kernel "
                "(TPU kernel H, ROADMAP queue 2)")
    if (scene.n_lights + 1) * LT_COLS > LANES:
        return (f"{scene.n_lights} lights exceed the trace kernel's light "
                "table; they need the split-path shade kernel "
                "(TPU kernel I, ROADMAP queue 2)")
    if scene.perlin_vec.shape[0]:
        return ("noise textures need the in-kernel marble noise "
                "(TPU kernel C, ROADMAP queue 2)")
    rows = scene.n_tris + scene.n_spheres + scene.n_quads
    if not 0 < rows <= ROWS_MAX:
        return (f"{rows} primitive rows (trace kernel: 1..{ROWS_MAX}) need "
                "the split-path search (TPU kernel M, ROADMAP queue 2)")
    return None


def uber_eligible(scene) -> bool:
    """Can the whole-wave trace kernel render this scene?"""
    return ineligible_reason(scene) is None


@dataclasses.dataclass
class TraceCtx:
    """Scene-derived tables of the trace, built once per render.

    ``uni`` [P, W] winner rows (pack(9), flip, mat, material attrs) with
    ``dflt`` [W] the miss default; the detached search tables ``det_t``,
    ``u_t``, ``v_t``, ``t_t`` [Tp, 10], ``dbl_t`` [Tp, 1], ``sph`` [S, 9]
    (c0, c1-c0, t0, 1/(t1-t0), r; far pads), ``quad`` [Q, 9] (q, u, v),
    ``cab`` [Tp/TCC, 8] cull boxes; ``lt`` [n_lights+1, LT_COLS] lights
    plus the background row.
    """

    uni: torch.Tensor
    dflt: torch.Tensor
    t_off: int
    s_off: int
    q_off: int
    det_t: torch.Tensor
    u_t: torch.Tensor
    v_t: torch.Tensor
    t_t: torch.Tensor
    dbl_t: torch.Tensor
    sph: torch.Tensor
    quad: torch.Tensor
    cab: torch.Tensor
    lt: torch.Tensor
    n_tris: int
    n_sph: int
    n_quad: int
    n_lights: int
    has_checker: bool

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
    order (the kernel's global ids) — differentiable w.r.t. the scene."""
    f32 = scene.mat_fuzz.dtype
    matt = _mat_attr_table(scene)

    def kind_table(pack_cols, flip_col, mat_col):
        return torch.cat([pack_cols, flip_col.to(f32)[:, None],
                          mat_col.to(f32)[:, None], matt[mat_col.long()]],
                         dim=1)

    parts = []
    t_off = s_off = q_off = off = 0
    if scene.n_tris:
        t_off = off
        parts.append(kind_table(
            torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2], dim=1),
            scene.tri_flip, scene.tri_mat))
        off += scene.n_tris
    if scene.n_spheres:
        s_off = off
        parts.append(kind_table(
            torch.cat([scene.sph_c0, scene.sph_c1, scene.sph_t0[:, None],
                       scene.sph_t1[:, None], scene.sph_r[:, None]], dim=1),
            scene.sph_flip, scene.sph_mat))
        off += scene.n_spheres
    if scene.n_quads:
        q_off = off
        parts.append(kind_table(
            torch.cat([scene.quad_q, scene.quad_u, scene.quad_v], dim=1),
            scene.quad_flip, scene.quad_mat))
        off += scene.n_quads
    uni = torch.cat(parts, dim=0)
    # miss default: first kind's pack row 0, flip/mat 0, material 0's attrs
    dflt = torch.cat([uni[0, :9], torch.zeros(2, dtype=f32,
                                               device=uni.device), matt[0]])
    return _pad_rows(uni, 8), dflt, (t_off, s_off, q_off)


def _search_tables(scene):
    """Detached search tables: ([T,10] x4, dbl [T,1]) padded to TCC rows,
    sphere [S,9] with far pads, quad [Q,9] with zero pads."""
    f32 = torch.float32
    dev = scene.device
    if scene.n_tris:
        det_c, u_c, v_c, t_c = _tri_coeffs(scene.tri_v0, scene.tri_e1,
                                           scene.tri_e2)
        det_t, u_t, v_t, t_t = det_c.T, u_c.T, v_c.T, t_c.T
        dbl_t = scene.tri_double.to(f32)[:, None]
    else:
        det_t = u_t = v_t = t_t = torch.zeros((8, 10), dtype=f32, device=dev)
        dbl_t = torch.zeros((8, 1), dtype=f32, device=dev)
    # pad coefficient rows are zeros -> det 0 -> always rejected
    det_t, u_t, v_t, t_t, dbl_t = (_pad_rows(x, TCC).contiguous() for x in
                                   (det_t, u_t, v_t, t_t, dbl_t))

    far = torch.zeros((8, 9), dtype=f32, device=dev)
    far[:, 0:3] = 1e30      # c0 = 1e30 -> disc = inf - inf = NaN: rejected
    s_n = scene.n_spheres
    if s_n:
        dt = scene.sph_t1 - scene.sph_t0
        inv_dt = 1.0 / torch.where(dt.abs() < 1e-12,
                                   torch.where(dt < 0, -1e-12, 1e-12).to(f32),
                                   dt)
        sph = torch.cat([scene.sph_c0, scene.sph_c1 - scene.sph_c0,
                         scene.sph_t0[:, None], inv_dt[:, None],
                         scene.sph_r[:, None]], dim=1)
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
    return det_t, u_t, v_t, t_t, dbl_t, sph.contiguous(), quad.contiguous()


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
        raise NotImplementedError(reason)
    uni, dflt, (t_off, s_off, q_off) = _scene_tables(scene)
    scene_s = dataclasses.replace(
        scene, **{f.name: getattr(scene, f.name).detach()
                  for f in dataclasses.fields(scene) if f.name != "camera"})
    det_t, u_t, v_t, t_t, dbl_t, sph, quad = _search_tables(scene_s)
    bg_row = torch.nn.functional.pad(scene.background[None],
                                     (0, LT_COLS - 3))
    lt = torch.cat([_light_table(scene)[:scene.n_lights], bg_row])
    return TraceCtx(
        uni=uni.contiguous(), dflt=dflt.contiguous(), t_off=t_off,
        s_off=s_off, q_off=q_off, det_t=det_t, u_t=u_t, v_t=v_t, t_t=t_t,
        dbl_t=dbl_t, sph=sph, quad=quad,
        cab=_chunk_aabbs(scene_s, det_t.shape[0]), lt=lt.contiguous(),
        n_tris=scene.n_tris, n_sph=scene.n_spheres, n_quad=scene.n_quads,
        n_lights=scene.n_lights, has_checker=scene.tex_even.shape[0] > 0)


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

def _fold(best, loc_t, loc_i, kind):
    """Strict-``<`` fold of a later kind into the running winner."""
    bt, bk, bi = best
    better = loc_t < bt
    return (torch.where(better, loc_t, bt),
            torch.where(better, torch.full_like(bk, kind), bk),
            torch.where(better, loc_i, bi))


def _first_min(tt):
    """(min over rows, lowest row index attaining it) of tt [R, B] (the
    index is meaningless where the min is inf; the fold ignores it)."""
    loc_t = tt.amin(dim=0)
    return loc_t, torch.argmax((tt == loc_t).to(torch.int32), dim=0)


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
        mx = oy * dz - oz * dy
        my = oz * dx - ox * dz
        mz = ox * dy - oy * dx
        f = (ox, oy, oz, dx, dy, dz, mx, my, mz, torch.ones_like(ox))
        nt = ctx.n_tri_chunks * TCC

        def dots(tab):
            acc = tab[:nt, 0:1] * f[0]
            for k in range(1, 10):
                acc = acc + tab[:nt, k:k + 1] * f[k]
            return acc                               # [nt, B]

        dm, um, vm, tm = (dots(x) for x in (ctx.det_t, ctx.u_t, ctx.v_t,
                                            ctx.t_t))
        eps = TRI_DET_EPS * torch.sqrt(dx * dx + dy * dy + dz * dz)
        dbl = ctx.dbl_t[:nt]
        safe = torch.where(dm.abs() > eps, dm, torch.ones_like(dm))
        inv = 1.0 / safe
        u, v, t = um * inv, vm * inv, tm * inv
        side_ok = (dm > eps) | ((dm < -eps) & (dbl > 0.5))
        valid = (side_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                 & (v < 1.0 - u) & (t >= tmin) & (t <= tmax))
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
        loc_t, loc_i = _first_min(tt)
        best = _fold(best, loc_t, loc_i + ctx.t_off, KIND_TRI)

    if ctx.n_sph:
        sp = ctx.sph[:, :, None]                     # [S, 9, 1]
        c0x, c0y, c0z = sp[:, 0], sp[:, 1], sp[:, 2]
        e1x, e1y, e1z = sp[:, 3], sp[:, 4], sp[:, 5]
        st0, inv_dt, rr = sp[:, 6], sp[:, 7], sp[:, 8]
        frac = (time - st0) * inv_dt                 # [S, B]
        cx = c0x + frac * e1x
        cy = c0y + frac * e1y
        cz = c0z + frac * e1z
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a = dx * dx + dy * dy + dz * dz
        b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - rr * rr
        disc = b * b - a * cc
        ok = disc > 0.0
        sq = torch.sqrt(torch.maximum(disc, disc.new_tensor(1e-12))) * ok
        inv_a = 1.0 / torch.maximum(a, a.new_tensor(1e-12))
        root1 = (-b - sq) * inv_a
        root2 = (-b + sq) * inv_a
        ok1 = ok & (root1 >= tmin) & (root1 <= tmax)
        ok2 = ok & (root2 >= tmin) & (root2 <= tmax)
        t = torch.where(ok1, root1, torch.where(ok2, root2, torch.inf))
        loc_t, loc_i = _first_min(t)
        best = _fold(best, loc_t, loc_i + ctx.s_off, KIND_SPH)

    if ctx.n_quad:
        qd = ctx.quad[:, :, None]
        qx, qy, qz = qd[:, 0], qd[:, 1], qd[:, 2]
        ux, uy, uz = qd[:, 3], qd[:, 4], qd[:, 5]
        vx, vy, vz = qd[:, 6], qd[:, 7], qd[:, 8]
        wnx = uy * vz - uz * vy
        wny = uz * vx - ux * vz
        wnz = ux * vy - uy * vx
        denom = dx * wnx + dy * wny + dz * wnz       # [Q, B]
        dsafe = torch.where(denom.abs() < 1e-12,
                            torch.where(denom < 0, -1e-12, 1e-12).to(
                                denom.dtype), denom)
        t = ((qx - ox) * wnx + (qy - oy) * wny + (qz - oz) * wnz) / dsafe
        wx = ox + t * dx - qx
        wy = oy + t * dy - qy
        wz = oz + t * dz - qz
        n2 = wnx * wnx + wny * wny + wnz * wnz
        inv_n2 = 1.0 / torch.maximum(n2, n2.new_tensor(1e-12))
        alpha = ((wy * vz - wz * vy) * wnx + (wz * vx - wx * vz) * wny
                 + (wx * vy - wy * vx) * wnz) * inv_n2
        beta = ((uy * wz - uz * wy) * wnx + (uz * wx - ux * wz) * wny
                + (ux * wy - uy * wx) * wnz) * inv_n2
        valid = ((denom.abs() > 0.0) & (t >= tmin) & (t <= tmax)
                 & (alpha >= 0.0) & (alpha <= 1.0)
                 & (beta >= 0.0) & (beta <= 1.0))
        tt = torch.where(valid, t, torch.inf)
        loc_t, loc_i = _first_min(tt)
        best = _fold(best, loc_t, loc_i + ctx.q_off, KIND_QUAD)

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
    mkind = selv[A + MATTR_MKIND].to(torch.int32)
    return torch.cat(parts, dim=0), mkind, flags


def tile_core_plain(st, rnd_b, selv, kind, ctx: TraceCtx):
    """Hit attributes, shading and the estimator update for one bounce.

    ``st`` [N_STATE, N], ``rnd_b`` [15, N], ``selv`` [W, N] winner rows
    (miss lanes already defaulted), ``kind`` [N]. Returns the next state.
    """
    P, mkind, flags = _tile_planes(st, rnd_b, selv, ctx)
    out = bounce_plane_core(P, kind, mkind, flags, ctx.lt, ctx.n_lights,
                            ctx.has_checker)
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
    columns of ``selv`` take zeros.
    """
    A = A_COL
    P, mkind, flags = _tile_planes(st, rnd_b, selv, ctx)
    cot = torch.cat([g[0:6], g[8:11], g[11:14], g[7:8]])
    dP, dlt = bounce_plane_core_vjp(P, kind, mkind, flags, ctx.lt,
                                    ctx.n_lights, ctx.has_checker, cot)
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
    return dst, dselv, dlt


def _select_rows(kind, idx, ctx: TraceCtx):
    """Winner rows [W, N]: ``uni[idx]``, the miss default where kind is 0
    (``_rebuild_row``, ``pallas_uber.py:551-565``)."""
    rows = ctx.uni[idx.long()].T
    return torch.where(kind[None] > 0, rows, ctx.dflt[:, None])


def _live_tiles(alive):
    """[N] bool: the ray's 1024-ray tile holds a live ray — the liveness
    predicate of the TPU trace kernels (``pallas_uber.py:889, 945``)."""
    live = (alive > 0.5).reshape(-1, TILE).any(dim=1)
    return live.repeat_interleave(TILE)


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


def bwd_reduce_plain(contrib, perm, offs, part):
    """Plain version of ``bwd_reduce`` (``csrc/trace_wave_bwd.cu``): duni
    [P, W] with row p the sum of the contributions ``perm[offs[p]:offs[p +
    1]]`` of ``contrib`` [..., W], and dlt [(n_lights + 1) * 14] the sum of
    the per-block partials ``part``."""
    w = contrib.shape[-1]
    p_rows = offs.shape[0] - 1
    m = int(offs[-1])
    rows = torch.repeat_interleave(
        torch.arange(p_rows, device=contrib.device),
        (offs[1:] - offs[:-1]).long())
    duni = torch.zeros((p_rows, w), dtype=contrib.dtype,
                       device=contrib.device)
    duni.index_add_(0, rows, contrib.reshape(-1, w)[perm[:m].long()])
    return duni, part.sum(dim=0)


def _trace_forward(st0, rnd, ctx: TraceCtx, depth: int, residuals: bool):
    dev = st0.device.type
    if dev == "cpu":
        return trace_wave_plain(st0, rnd, ctx, depth, residuals=residuals)
    if dev != "cuda":
        raise ValueError(f"unsupported device {st0.device}")
    from rust_ray_tracer_tpu_torch.kernels import trace_wave_kernel
    return trace_wave_kernel(st0, rnd, ctx, depth, residuals=residuals)


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
    Hopper kernel (``csrc/trace_wave.cu``) for CUDA tensors. When a
    gradient is wanted it runs as :class:`TraceWave` (forward with
    residuals, backward by :func:`trace_wave_bwd`); otherwise the forward
    writes no residuals."""
    if st0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {st0.device}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (st0, ctx.uni, ctx.lt)):
        return TraceWave.apply(st0, rnd, ctx.uni, ctx.lt, ctx, depth)
    return _trace_forward(st0, rnd, ctx, depth, False)


def wave_inputs(scene, wkey, width: int, height: int, depth: int,
                chunk_size: int):
    """(st0 [N_STATE, N], rnd [depth, 15, N]) of one sample wave, N =
    n_chunks * Cp: camera rays and randoms keyed by (wave key, global
    chunk id, bounce) exactly as the JAX package draws them."""
    n = width * height
    n_chunks = -(-n // chunk_size)
    dev = wkey.device
    ids = torch.arange(n_chunks, device=dev)
    o, d, t, ckey = cam_ops.camera_rays_for_chunks(
        scene.camera, wkey, ids, chunk_size, width, height)
    st = pack_state(o, d, t, torch.zeros_like(o), torch.ones_like(o),
                    torch.ones_like(t, dtype=torch.bool))   # [14, K, Cp]
    ck = rngu.stream(ckey, rngu.CHUNK)                       # [K, 2]
    bk = rngu.bounce_key(ck[:, None, :], torch.arange(depth, device=dev))
    ub = rngu.uniform(rngu.stream(bk, rngu.SCATTER), (chunk_size, 9))
    gb = rngu.normal(rngu.stream(bk, rngu.FUZZ), (chunk_size, 6))
    rnd = torch.nn.functional.pad(                           # [D, 15, K, Cp]
        torch.cat([ub, gb], dim=-1).permute(1, 3, 0, 2),
        (0, st.shape[-1] - chunk_size))
    return (st.reshape(N_STATE, -1),
            rnd.reshape(depth, N_RND, -1).contiguous())


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
