"""Shading and the estimator update of a split-route bounce, the albedo
given: TPU kernel H and its backward H'.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_bounce.py:575-805``:
:func:`su_plane_core` is the plain version of ``_su_plane_core``
(``pallas_bounce.py:590-634``) — ``pallas_shade._plane_core``
(:func:`ops.shade_core.plane_core`, all five materials and the light
mixture) plus the estimator update — and the plain version of
``shade_update_kernel`` (``csrc/split.cu``); :func:`su_plane_core_vjp` is
its adjoint, the plain version of ``shade_update_bwd_kernel``.
:func:`su_planes` and :func:`su_planes_bwd` run the one or the other by
the device of their tensors, :class:`ShadeUpdate` pairs them for autograd
(``_su_planes_call``'s ``custom_vjp``), and :func:`shade_update_fused` is
``shade_update_fused`` (``:752``) on the port's plane layout.

Plane layout ([N_SU, N]): 0..2 o, 3..5 d, 6..8 p, 9..11 n, 12..14 albedo,
15 fuzz, 16 ior, 17..19 L, 20..22 beta, 23..31 ub (9 uniforms), 32..37 gb
(6 normals), 38 alive, 39 hit (0/1). Output [N_SU_OUT, N]: o'(3) d'(3)
L'(3) beta'(3) alive'.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.bounce_core import update_vjp
from rust_ray_tracer_tpu_torch.ops.shade_core import (LT_COLS, _light_table,
                                                      plane_core,
                                                      plane_core_vjp)

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


def su_plane_core_vjp(P, mkind, lt, n_lights: int, cot):
    """Adjoint of :func:`su_plane_core`: (dP like ``P``, dlt like ``lt``)
    for output cotangents ``cot`` [N_SU_OUT, ...]; the plain version of
    kernel H' (``shade_update_bwd_kernel``, ``csrc/split.cu``).

    Counterpart of ``jax.vjp`` of ``pallas_bounce._su_plane_core``
    (``pallas_bounce.py:590-634``), which ``_su_bwd`` (``:705``) runs:
    :func:`ops.bounce_core.update_vjp` for the estimator update, then
    :func:`ops.shade_core.plane_core_vjp` for the shading, whose light
    rows take the mixture pdf's share. The randoms, alive and hit planes
    take none; dlt sums over the lanes."""
    data = tuple(P[3 + i] for i in range(14))
    rng = tuple(P[23 + i] for i in range(15))
    shade = plane_core(data, rng, mkind, lt, n_lights)
    em, wt, alive_f = shade[0:3], shade[3:6], shade[9]
    alive_in = P[38] > 0.5
    is_hit = P[39] > 0.5
    miss = alive_in & ~is_hit
    live = alive_in & is_hit
    alive2 = live & (alive_f > 0.5)
    u = update_vjp(cot, (P[20], P[21], P[22]), lt[n_lights], em, wt, miss,
                   live, alive2)
    zero = torch.zeros_like(P[0])
    d_data, dlt_s = plane_core_vjp(data, rng, mkind, lt, n_lights,
                                   u.em + u.wt + u.sd + [zero])
    dP = torch.zeros_like(P)
    dlt = torch.zeros_like(lt)
    dlt[n_lights, 0:3] = torch.stack(u.bg)
    dlt = dlt + dlt_s
    dP[0:3] = torch.stack(u.o)
    dP[3:6] = torch.stack([a + b for a, b in zip(u.d, d_data[0:3])])
    dP[6:9] = torch.stack([a + b for a, b in zip(u.p, d_data[3:6])])
    dP[9:17] = torch.stack(list(d_data[6:14]))
    dP[17:20] = torch.stack(u.L)
    dP[20:23] = torch.stack(u.beta)
    return dP, dlt


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


def su_planes_bwd(P, mkind, lt, n_lights: int, g):
    """(dP [N_SU, N], dlt like ``lt``): :func:`su_plane_core_vjp` for CPU
    tensors, kernel H' (``csrc/split.cu``) and B''s sum of its light-table
    partials for CUDA tensors."""
    dev = P.device.type
    if dev == "cpu":
        return su_plane_core_vjp(P, mkind, lt, n_lights, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    from rust_ray_tracer_tpu_torch.kernels import shade_update_bwd_kernel
    return shade_update_bwd_kernel(P, mkind, lt, n_lights, g)


class ShadeUpdate(torch.autograd.Function):
    """Kernel H as a differentiable function of its planes and the light
    table: ``_su_planes_call``'s ``custom_vjp`` (``pallas_bounce.py:
    673-737``). The forward is :func:`su_planes` (H or its plain version),
    the backward :func:`su_planes_bwd` (H' or its plain version), both by
    the tensors' device. It saves H's inputs, not its outputs: H' recomputes
    the shading from them."""

    @staticmethod
    def forward(fctx, P, mkind, lt, n_lights: int):
        fctx.save_for_backward(P, mkind, lt)
        fctx.n_lights = n_lights
        return su_planes(P, mkind, lt, n_lights)

    @staticmethod
    def backward(fctx, g):
        P, mkind, lt = fctx.saved_tensors
        dP, dlt = su_planes_bwd(P, mkind, lt, fctx.n_lights, g.contiguous())
        return dP, None, dlt, None


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
    out = ShadeUpdate.apply(P, mkind, lt, n_lights)
    return torch.cat([out[0:6], st[6:7], out[12:13], out[6:12]])
