"""Hit attributes + shading + the estimator update for one bounce, on
per-ray planes.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_bounce.py``:
:func:`bounce_plane_core` is the plain version of ``_bounce_plane_core``
(``pallas_bounce.py:178-280``), including the in-kernel checker select
(``:208-218``). The marble-noise branch (``:219-238``) is not ported yet
(ROADMAP queue 2 C); noise scenes are refused before they get here.

Input plane layout (rows of ``P``):
  0..18  : hit_core layout (o3 d3 time tmin tmax pack9 tmed)
  19..21 : albedo (solid leaf / checker base)
  22, 23 : fuzz, ior
  24..26 : L (radiance accum)    27..29 : beta (throughput)
  30..38 : ub (9 uniforms)       39..44 : gb (6 normals)
  45     : alive (0/1 float)
  46..51 : checker even / odd leaf colors (checker scenes only)
Output: ``[N_OUT_B, ...]`` = o'(3) d'(3) L'(3) beta'(3) alive'.

:func:`bounce_plane_core_vjp` is its hand-derived adjoint, composed from
:func:`ops.hit_core.hit_plane_core_vjp` and
:func:`ops.shade_core.plane_core_vjp`.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.hit_core import N_IN as N_HIT
from rust_ray_tracer_tpu_torch.ops.hit_core import (hit_plane_core,
                                                    hit_plane_core_vjp)
from rust_ray_tracer_tpu_torch.ops.intersect import KIND_NONE
from rust_ray_tracer_tpu_torch.ops.shade_core import (_mask, plane_core,
                                                      plane_core_vjp)

N_IN_B = 46
N_CHK = 6
N_OUT_B = 13


def bounce_plane_core(P, pkind, mkind, flags, lt, n_lights: int,
                      has_checker: bool = False):
    """One bounce for rays laid out as planes.

    Args:
      P: ``[N_IN_B (+N_CHK), ...]`` planes (layout in the module docstring).
      pkind: int32 primitive kind plane (``KIND_NONE`` = miss).
      mkind: int32 material kind plane.
      flags: int32 plane — bit 0 FlipFace, bit 1 checker texture.
      lt: ``[n_lights + 1, LT_COLS]`` light table plus a trailing
        background row (cols 0..2 = background RGB).
      n_lights: light count.
      has_checker: evaluate the checker select at the hit point.
    """
    hit_out = hit_plane_core(P[:N_HIT], pkind, flags & 1)
    px, py, pz = hit_out[1], hit_out[2], hit_out[3]
    nx, ny, nz = hit_out[4], hit_out[5], hit_out[6]

    ax, ay, az = P[19], P[20], P[21]
    if has_checker:
        # checker (texture.rs:50-57): the sin-product sign selects the leaf
        sines = (torch.sin(10.0 * px) * torch.sin(10.0 * py)
                 * torch.sin(10.0 * pz))
        is_chk = (flags & 2) > 0
        odd = sines < 0.0
        ax = torch.where(is_chk, torch.where(odd, P[49], P[46]), ax)
        ay = torch.where(is_chk, torch.where(odd, P[50], P[47]), ay)
        az = torch.where(is_chk, torch.where(odd, P[51], P[48]), az)

    data = (P[3], P[4], P[5], px, py, pz, nx, ny, nz, ax, ay, az,
            P[22], P[23])
    rng = tuple(P[30 + i] for i in range(15))
    (emx, emy, emz, wtx, wty, wtz,
     sdx, sdy, sdz, alive_f) = plane_core(data, rng, mkind, lt, n_lights)

    ox, oy, oz = P[0], P[1], P[2]
    dx, dy, dz = P[3], P[4], P[5]
    Lx, Ly, Lz = P[24], P[25], P[26]
    bx, by, bz = P[27], P[28], P[29]
    alive_in = P[45] > 0.5
    bgx, bgy, bgz = lt[n_lights, 0], lt[n_lights, 1], lt[n_lights, 2]

    is_hit = pkind != KIND_NONE
    miss = alive_in & ~is_hit
    live = alive_in & is_hit
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)

    # L += miss ? beta*background : 0 ; += live ? beta*emitted : 0
    Lx = Lx + torch.where(miss, bx * bgx, zero) + torch.where(live, bx * emx,
                                                              zero)
    Ly = Ly + torch.where(miss, by * bgy, zero) + torch.where(live, by * emy,
                                                              zero)
    Lz = Lz + torch.where(miss, bz * bgz, zero) + torch.where(live, bz * emz,
                                                              zero)
    bx = torch.where(live, bx * wtx, bx)
    by = torch.where(live, by * wty, by)
    bz = torch.where(live, bz * wtz, bz)
    alive2 = live & (alive_f > 0.5)
    ox = torch.where(alive2, px, ox)
    oy = torch.where(alive2, py, oy)
    oz = torch.where(alive2, pz, oz)
    dx = torch.where(alive2, sdx, dx)
    dy = torch.where(alive2, sdy, dy)
    dz = torch.where(alive2, sdz, dz)
    return torch.stack([ox, oy, oz, dx, dy, dz, Lx, Ly, Lz, bx, by, bz,
                        torch.where(alive2, one, zero)])


def bounce_plane_core_vjp(P, pkind, mkind, flags, lt, n_lights: int,
                          has_checker: bool, cot):
    """Adjoint of :func:`bounce_plane_core`: (dP like ``P``, dlt like
    ``lt``) for output cotangents ``cot`` ``[N_OUT_B, ...]``.

    Counterpart of ``jax.vjp`` of ``pallas_bounce._bounce_plane_core``
    (``pallas_bounce.py:178-280``): the checker's sin-product sign picks
    the leaf and only that leaf takes the albedo cotangent; a miss adds
    ``beta * background`` (the background row takes ``L``'s cotangent
    times beta); a dead lane passes o, d, L and beta through unchanged.
    The alive planes (in and out) take none.
    """
    hit_out = hit_plane_core(P[:N_HIT], pkind, flags & 1)
    px, py, pz = hit_out[1], hit_out[2], hit_out[3]
    nx, ny, nz = hit_out[4], hit_out[5], hit_out[6]
    ax, ay, az = P[19], P[20], P[21]
    if has_checker:
        sines = (torch.sin(10.0 * px) * torch.sin(10.0 * py)
                 * torch.sin(10.0 * pz))
        is_chk = (flags & 2) > 0
        odd = sines < 0.0
        ax = torch.where(is_chk, torch.where(odd, P[49], P[46]), ax)
        ay = torch.where(is_chk, torch.where(odd, P[50], P[47]), ay)
        az = torch.where(is_chk, torch.where(odd, P[51], P[48]), az)
    data = (P[3], P[4], P[5], px, py, pz, nx, ny, nz, ax, ay, az,
            P[22], P[23])
    rng = tuple(P[30 + i] for i in range(15))
    shade = plane_core(data, rng, mkind, lt, n_lights)
    em, wt, alive_f = shade[0:3], shade[3:6], shade[9]
    beta = (P[27], P[28], P[29])
    alive_in = P[45] > 0.5
    is_hit = pkind != KIND_NONE
    miss = alive_in & ~is_hit
    live = alive_in & is_hit
    alive2 = live & (alive_f > 0.5)
    cot = tuple(cot)
    g_o, g_d, g_L, g_b = cot[0:3], cot[3:6], cot[6:9], cot[9:12]

    dP = torch.zeros_like(P)
    dlt = torch.zeros_like(lt)
    # L' = L + [miss] beta * bg + [live] beta * em; beta' = [live] beta * wt
    dP[24:27] = torch.stack(g_L)
    dP[27:30] = torch.stack([
        _mask(miss, gl * lt[n_lights, i]) + _mask(live, gl * em[i])
        + torch.where(live, gb * wt[i], gb)
        for i, (gl, gb) in enumerate(zip(g_L, g_b))])
    dlt[n_lights, 0:3] = torch.stack(
        [_mask(miss, gl * b).sum() for gl, b in zip(g_L, beta)])
    g_em = [_mask(live, gl * b) for gl, b in zip(g_L, beta)]
    g_wt = [_mask(live, gb * b) for gb, b in zip(g_b, beta)]
    # o' = [alive2] p : o ; d' = [alive2] sd : d
    g_p = [_mask(alive2, g) for g in g_o]
    g_sd = [_mask(alive2, g) for g in g_d]
    zero = torch.zeros_like(px)
    d_data, dlt_s = plane_core_vjp(data, rng, mkind, lt, n_lights,
                                   g_em + g_wt + g_sd + [zero])
    dlt = dlt + dlt_s
    g_a = d_data[9:12]
    if has_checker:
        for i in range(3):
            dP[19 + i] = _mask(~is_chk, g_a[i])
            dP[46 + i] = _mask(is_chk & ~odd, g_a[i])
            dP[49 + i] = _mask(is_chk & odd, g_a[i])
    else:
        dP[19:22] = torch.stack(g_a)
    dP[22], dP[23] = d_data[12], d_data[13]
    g_hit = torch.stack([zero] + [g + dd for g, dd in zip(g_p, d_data[3:6])]
                        + list(d_data[6:9]) + [zero] * 5)
    dP[:N_HIT] = hit_plane_core_vjp(P[:N_HIT], pkind, flags & 1, g_hit)
    for i in range(3):
        dP[i] = dP[i] + _mask(~alive2, g_o[i])
        dP[3 + i] = dP[3 + i] + _mask(~alive2, g_d[i]) + d_data[i]
    return dP, dlt
