"""Shading and the estimator update of a split-route bounce, the albedo
given: TPU kernel H.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_bounce.py:575-805``:
:func:`su_plane_core` is the plain version of ``_su_plane_core``
(``pallas_bounce.py:590-634``) — ``pallas_shade._plane_core``
(:func:`ops.shade_core.plane_core`, all five materials and the light
mixture) plus the estimator update — and the plain version of
``shade_update_kernel`` (``csrc/split.cu``). :func:`su_planes` runs the
one or the other by the device of its tensors, and
:func:`shade_update_fused` is ``shade_update_fused`` (``:752``) on the
port's plane layout.

Plane layout ([N_SU, N]): 0..2 o, 3..5 d, 6..8 p, 9..11 n, 12..14 albedo,
15 fuzz, 16 ior, 17..19 L, 20..22 beta, 23..31 ub (9 uniforms), 32..37 gb
(6 normals), 38 alive, 39 hit (0/1). Output [N_SU_OUT, N]: o'(3) d'(3)
L'(3) beta'(3) alive'.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.shade_core import (LT_COLS, _light_table,
                                                      plane_core)

N_SU = 40
N_SU_OUT = 13


def su_plane_core(P, mkind, lt, n_lights: int):
    """Material eval and the estimator update for rays laid out as planes:
    ``P`` [N_SU, ...], ``mkind`` int32 material kinds, ``lt``
    [n_lights + 1, LT_COLS] lights plus the background row."""
    data = tuple(P[3 + i] for i in range(14))
    rng = tuple(P[23 + i] for i in range(15))
    (emx, emy, emz, wtx, wty, wtz,
     sdx, sdy, sdz, alive_f) = plane_core(data, rng, mkind, lt, n_lights)

    ox, oy, oz = P[0], P[1], P[2]
    dx, dy, dz = P[3], P[4], P[5]
    px, py, pz = P[6], P[7], P[8]
    Lx, Ly, Lz = P[17], P[18], P[19]
    bx, by, bz = P[20], P[21], P[22]
    alive_in = P[38] > 0.5
    is_hit = P[39] > 0.5
    bgx, bgy, bgz = lt[n_lights, 0], lt[n_lights, 1], lt[n_lights, 2]

    miss = alive_in & ~is_hit
    live = alive_in & is_hit
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
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


def su_planes(P, mkind, lt, n_lights: int):
    """[N_SU_OUT, N] next-state planes: :func:`su_plane_core` for CPU
    tensors, kernel H (``csrc/split.cu``) for CUDA tensors."""
    dev = P.device.type
    if dev == "cpu":
        return su_plane_core(P, mkind, lt, n_lights)
    if dev != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    from rust_ray_tracer_tpu_torch.kernels import shade_update_kernel
    return shade_update_kernel(P, mkind, lt, n_lights)


def light_table(scene):
    """[n_lights + 1, LT_COLS]: the light rows (``_light_table``) and the
    background row (``pallas_bounce.py:795-799``)."""
    bg = torch.nn.functional.pad(scene.background[None], (0, LT_COLS - 3))
    return torch.cat([_light_table(scene)[:scene.n_lights], bg]).contiguous()


def shade_update_fused(st, hit, hit_planes, albedo, fuzz, ior, mkind, rnd_b,
                       lt, n_lights: int):
    """The next state [14, N] of one split-route bounce: the shading of
    each found ray and the estimator update (``shade_update_fused``,
    ``pallas_bounce.py:752``).

    ``st`` [14, N] the state planes (o, d, time, alive, L, beta); ``hit``
    [N] bool, the ray found something; ``hit_planes`` [>= 7, N] kernel J's
    output (t, p, n, ...); ``albedo`` [3, N]; ``fuzz``, ``ior`` [N];
    ``mkind`` int32 [N]; ``rnd_b`` [>= 15, N] the bounce's uniforms and
    normals; ``lt`` from :func:`light_table`."""
    P = torch.cat([st[0:6], hit_planes[1:7], albedo, fuzz[None], ior[None],
                   st[8:14], rnd_b[0:15], st[7:8], hit.to(st.dtype)[None]])
    out = su_planes(P, mkind, lt, n_lights)
    return torch.cat([out[0:6], st[6:7], out[12:13], out[6:12]])
