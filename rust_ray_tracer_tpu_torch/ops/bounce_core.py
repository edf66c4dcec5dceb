"""Hit attributes + shading + the estimator update for one bounce, on
per-ray planes.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_bounce.py``:
:func:`bounce_plane_core` is the plain version of ``_bounce_plane_core``
(``pallas_bounce.py:178-280``), including the in-kernel checker select
(``:208-218``) and the marble-noise branch (``:219-238``, TPU kernel C,
through :func:`ops.perlin.marble`).

Input plane layout (rows of ``P``):
  0..18  : hit_core layout (o3 d3 time tmin tmax pack9 tmed)
  19..21 : albedo (solid leaf / checker base)
  22, 23 : fuzz, ior
  24..26 : L (radiance accum)    27..29 : beta (throughput)
  30..38 : ub (9 uniforms)       39..44 : gb (6 normals)
  45     : alive (0/1 float)
  46..51 : checker even / odd leaf colors (checker scenes only)
  last   : the winner's noise frequency scale (noise scenes only)
Output: ``[N_OUT_B, ...]`` = o'(3) d'(3) L'(3) beta'(3) alive'.

:func:`bounce_plane_core_vjp` is its hand-derived adjoint, composed from
:func:`ops.hit_core.hit_plane_core_vjp`,
:func:`ops.shade_core.plane_core_vjp`, :func:`ops.perlin.marble_vjp` and
:func:`update_vjp`, the adjoint of the estimator update, which the split
route's ``ops/bounce.su_plane_core_vjp`` shares.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_ray_tracer_tpu_torch.ops.hit_core import N_IN as N_HIT
from rust_ray_tracer_tpu_torch.ops.hit_core import (hit_plane_core,
                                                    hit_plane_core_vjp)
from rust_ray_tracer_tpu_torch.ops.intersect import KIND_NONE
from rust_ray_tracer_tpu_torch.ops.perlin import marble, marble_vjp
from rust_ray_tracer_tpu_torch.ops.shade_core import (_mask, plane_core,
                                                      plane_core_vjp)

N_IN_B = 46
N_CHK = 6
N_OUT_B = 13


def _noise_inputs(P, pkind, flags, px, py, pz, has_checker):
    """(is_nz, gx, gy, gz, scale): the noise lanes — a hit whose winner has
    the noise flag (a miss may carry material 0's flag) — and the marble's
    inputs, p zeroed on the other lanes (``pallas_bounce.py:225-230``)."""
    is_nz = ((flags & 4) > 0) & (pkind != KIND_NONE)
    zero = torch.zeros_like(px)
    return (is_nz, torch.where(is_nz, px, zero), torch.where(is_nz, py, zero),
            torch.where(is_nz, pz, zero),
            P[N_IN_B + (N_CHK if has_checker else 0)])


def bounce_plane_core(P, pkind, mkind, flags, lt, n_lights: int,
                      has_checker: bool = False, has_noise: bool = False,
                      tables=None):
    """One bounce for rays laid out as planes.

    Args:
      P: ``[N_IN_B (+N_CHK) (+1), ...]`` planes (layout in the module
        docstring).
      pkind: int32 primitive kind plane (``KIND_NONE`` = miss).
      mkind: int32 material kind plane.
      flags: int32 plane — bit 0 FlipFace, bit 1 checker texture, bit 2
        marble-noise texture.
      lt: ``[n_lights + 1, LT_COLS]`` light table plus a trailing
        background row (cols 0..2 = background RGB).
      n_lights: light count.
      has_checker: evaluate the checker select at the hit point.
      has_noise: evaluate the marble noise at the hit point, from
        ``tables`` (an :class:`ops.perlin.PerlinTables`).
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
    if has_noise:
        # marble (texture.rs:74-82) at the hit point, all three channels
        is_nz, gx, gy, gz, scale = _noise_inputs(P, pkind, flags, px, py,
                                                 pz, has_checker)
        m = marble(tables, gx, gy, gz, scale)
        ax = torch.where(is_nz, m, ax)
        ay = torch.where(is_nz, m, ay)
        az = torch.where(is_nz, m, az)

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
                          has_checker: bool, cot, has_noise: bool = False,
                          tables=None):
    """Adjoint of :func:`bounce_plane_core`: (dP like ``P``, dlt like
    ``lt``) for output cotangents ``cot`` ``[N_OUT_B, ...]``.

    Counterpart of ``jax.vjp`` of ``pallas_bounce._bounce_plane_core``
    (``pallas_bounce.py:178-280``): the checker's sin-product sign picks
    the leaf and only that leaf takes the albedo cotangent; on a noise
    lane the three albedo cotangents, summed, go through
    :func:`ops.perlin.marble_vjp` into the hit point and the scale plane,
    and the albedo planes take none; a miss adds
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
    if has_noise:
        is_nz, gx, gy, gz, scale = _noise_inputs(P, pkind, flags, px, py,
                                                 pz, has_checker)
        m = marble(tables, gx, gy, gz, scale)
        ax = torch.where(is_nz, m, ax)
        ay = torch.where(is_nz, m, ay)
        az = torch.where(is_nz, m, az)
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
    u = update_vjp(cot, beta, lt[n_lights], em, wt, miss, live, alive2)

    dP = torch.zeros_like(P)
    dlt = torch.zeros_like(lt)
    dP[24:27] = torch.stack(u.L)
    dP[27:30] = torch.stack(u.beta)
    dlt[n_lights, 0:3] = torch.stack(u.bg)
    g_p = u.p
    zero = torch.zeros_like(px)
    d_data, dlt_s = plane_core_vjp(data, rng, mkind, lt, n_lights,
                                   u.em + u.wt + u.sd + [zero])
    dlt = dlt + dlt_s
    g_a = d_data[9:12]
    g_pn = [zero, zero, zero]           # the marble's share of p's cotangent
    if has_noise:
        g_m = _mask(is_nz, g_a[0] + g_a[1] + g_a[2])
        *g_pn, g_sc = marble_vjp(tables, gx, gy, gz, scale, g_m)
        g_pn = [_mask(is_nz, g) for g in g_pn]
        dP[N_IN_B + (N_CHK if has_checker else 0)] = g_sc
        g_a = [_mask(~is_nz, g) for g in g_a]
    if has_checker:
        for i in range(3):
            dP[19 + i] = _mask(~is_chk, g_a[i])
            dP[46 + i] = _mask(is_chk & ~odd, g_a[i])
            dP[49 + i] = _mask(is_chk & odd, g_a[i])
    else:
        dP[19:22] = torch.stack(g_a)
    dP[22], dP[23] = d_data[12], d_data[13]
    g_hit = torch.stack([zero] + [g + dd + gn for g, dd, gn in
                                  zip(g_p, d_data[3:6], g_pn)]
                        + list(d_data[6:9]) + [zero] * 5)
    dP[:N_HIT] = hit_plane_core_vjp(P[:N_HIT], pkind, flags & 1, g_hit)
    for i in range(3):
        dP[i] = dP[i] + u.o[i]
        dP[3 + i] = dP[3 + i] + u.d[i] + d_data[i]
    return dP, dlt


class UpdateCot(NamedTuple):
    """Cotangents through the estimator update, each a list of 3 planes
    (``bg`` of 3 scalars): of L, beta, the background row's colour, the
    emitted radiance, the weight, the hit point, the scattered direction,
    and the o and d that a ray whose path did not go on keeps."""

    L: list
    beta: list
    bg: list
    em: list
    wt: list
    p: list
    sd: list
    o: list
    d: list


def update_vjp(cot, beta, bg, em, wt, miss, live, alive2) -> UpdateCot:
    """Adjoint of the estimator update that ends ``_bounce_plane_core``
    and ``_su_plane_core`` (``pallas_bounce.py:248-280``, ``:608-634``) for
    the output cotangents ``cot`` (o', d', L', beta'; alive' takes none):
    ``L' = L + [miss] beta * bg + [live] beta * em``, ``beta' = [live] beta
    * wt : beta``, ``o' = [alive2] p : o``, ``d' = [alive2] sd : d``.
    ``beta``, ``em``, ``wt`` are plane triples, ``bg`` the background row
    (its first three columns), ``miss``, ``live``, ``alive2`` bool planes.
    A dead lane passes its cotangents through; a live miss sends ``g_L *
    beta`` to the background."""
    cot = tuple(cot)
    g_o, g_d, g_L, g_b = cot[0:3], cot[3:6], cot[6:9], cot[9:12]
    return UpdateCot(
        L=list(g_L),
        beta=[_mask(miss, gl * bg[i]) + _mask(live, gl * em[i])
              + torch.where(live, gb * wt[i], gb)
              for i, (gl, gb) in enumerate(zip(g_L, g_b))],
        bg=[_mask(miss, gl * b).sum() for gl, b in zip(g_L, beta)],
        em=[_mask(live, gl * b) for gl, b in zip(g_L, beta)],
        wt=[_mask(live, gb * b) for gb, b in zip(g_b, beta)],
        p=[_mask(alive2, g) for g in g_o],
        sd=[_mask(alive2, g) for g in g_d],
        o=[_mask(~alive2, g) for g in g_o],
        d=[_mask(~alive2, g) for g in g_d])
