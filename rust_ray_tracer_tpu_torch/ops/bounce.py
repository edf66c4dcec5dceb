"""A split-route bounce's shading and estimator update: TPU kernels F and
H, and their backward kernels F' and H'.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_bounce.py``:

  * F, the fused bounce of a scene whose textures are solid or checkers
    of solids (``bounce_fused``, ``pallas_bounce.py:822-899``, launched by
    ``_bounce_planes_call``, ``:328-356``): hit attributes, the checker
    select, shading and the estimator update in one kernel. Its plain
    version is ``ops/bounce_core.bounce_plane_core`` (the whole-wave
    trace's per-bounce core too), its adjoint (F', ``_bp_bwd``, ``:359-
    407``) ``bounce_plane_core_vjp``. :func:`bounce_planes` and
    :func:`bounce_planes_bwd` run the one or the other by the device of
    their tensors (``bounce_planes_kernel`` / ``bounce_planes_bwd_kernel``
    in ``csrc/split.cu`` on the card), :class:`BouncePlanes` pairs them
    for autograd, and :func:`bounce_fused` packs a bounce's planes in
    JAX's layout (``ops/bounce_core.py``'s docstring: 46 planes, 52 with
    the checker leaves);
  * G and G', F and F' gated by a liveness flag per 1024-lane tile
    (``bounce_planes_live``, ``pallas_bounce.py:492-572``:
    ``_make_kernel_live`` :420, ``_make_bwd_kernel_live`` :444), the
    shading of the unfused uber bounce (``ops/uber.bounce_uber`` under
    ``RRT_NO_UBER_FUSED=1``): a tile with no live lane copies o, d, L,
    beta and alive through, and in the backward that copy's cotangent
    with a zero light-table share.
    :func:`bounce_planes_live_plain` and :func:`bounce_planes_live_bwd_plain`
    are their plain versions, :func:`bounce_planes_live` and
    :func:`bounce_planes_live_bwd` the dispatchers (``bounce_planes_kernel``
    / ``bounce_planes_bwd_kernel`` of ``csrc/split.cu`` launched with the
    flags on the card), :class:`BouncePlanesLive` the ``custom_vjp``;
  * H, for scenes with noise textures, whose albedo the glue evaluates
    (``pallas_bounce.py:575-805``): :func:`su_plane_core` is the plain
    version of ``_su_plane_core`` (``pallas_bounce.py:590-634``) —
    ``pallas_shade._plane_core`` (:func:`ops.shade_core.plane_core`, all
    five materials and the light mixture) plus the estimator update — and
    of ``shade_update_kernel`` (``csrc/split.cu``); :func:`su_plane_core_vjp`
    is its adjoint, the plain version of ``shade_update_bwd_kernel``.
    :func:`su_planes` and :func:`su_planes_bwd` run the one or the other
    by the device of their tensors, :class:`ShadeUpdate` pairs them for
    autograd (``_su_planes_call``'s ``custom_vjp``), and
    :func:`shade_update_fused` is ``shade_update_fused`` (``:752``) on the
    port's plane layout.

H's plane layout ([N_SU, N]): 0..2 o, 3..5 d, 6..8 p, 9..11 n, 12..14
albedo, 15 fuzz, 16 ior, 17..19 L, 20..22 beta, 23..31 ub (9 uniforms),
32..37 gb (6 normals), 38 alive, 39 hit (0/1). Output of F and H
[N_SU_OUT, N]: o'(3) d'(3) L'(3) beta'(3) alive'.
"""

from __future__ import annotations

import os

import torch

from rust_ray_tracer_tpu_torch.ops.bounce_core import (N_IN_B,
                                                       bounce_plane_core,
                                                       bounce_plane_core_vjp,
                                                       update_vjp)
from rust_ray_tracer_tpu_torch.ops.intersect import (MATTR_ALBEDO, MATTR_EVEN,
                                                     MATTR_FUZZ, MATTR_IOR,
                                                     MATTR_ISCHK, MATTR_MKIND,
                                                     MATTR_ODD)
from rust_ray_tracer_tpu_torch.ops.shade_core import (LANES, LT_COLS,
                                                      _light_table,
                                                      plane_core,
                                                      plane_core_vjp)

N_SU = 40
N_SU_OUT = 13
LIVE_TILE = 8 * LANES   # lanes one liveness flag of G and G' covers


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


# ---------------------------------------------------------------------------
# F and F': the fused bounce of solid and checker scenes
# ---------------------------------------------------------------------------

MEGAKERNEL_FLAGS = ("RRT_NO_MEGAKERNEL", "RRT_NO_PALLAS_SHADE")


def megakernels_off() -> str | None:
    """The first of ``RRT_NO_MEGAKERNEL=1`` and ``RRT_NO_PALLAS_SHADE=1``
    that is set, read at each call as JAX reads them
    (``pallas_bounce.py:745-747, 811-813``), or None: under either the
    split route's bounce runs neither F nor H, but J, ``texture_value``,
    I and the torch update, and the trace kernel is off too
    (``ops/uber.ineligible_reason``). (Under ``RRT_NO_PALLAS_SHADE=1`` JAX
    also shades by XLA; the port's card shades by I, its counterpart.)"""
    return next((f for f in MEGAKERNEL_FLAGS if os.environ.get(f, "") == "1"),
                None)


def su_eligible(scene) -> bool:
    """``pallas_bounce.su_eligible`` (``:740-749``): kernel H takes any
    texture set; the light table with the background row must fit its
    backward's accumulator row (at most 8 lights); off under
    :func:`megakernels_off`."""
    return (megakernels_off() is None
            and (scene.n_lights + 1) * LT_COLS <= 128)


def fused_eligible(scene) -> bool:
    """``pallas_bounce.eligible`` (``:807-820``): no noise leaf, no image
    leaf, and the light table with the background row fits the backward's
    accumulator."""
    return (scene.perlin_vec.shape[0] == 0 and scene.img_data.shape[0] == 0
            and su_eligible(scene))


def bounce_planes(P, pkind, mkind, flags, lt, n_lights: int):
    """[N_SU_OUT, N] next-state planes of one bounce of the planes ``P``
    [46 (+6), N] (``ops/bounce_core.py``'s layout; the checker leaves when
    52) with the int32 ``pkind``, ``mkind``, ``flags`` [N]:
    :func:`ops.bounce_core.bounce_plane_core` for CPU tensors, kernel F
    (``csrc/split.cu``) for CUDA tensors."""
    dev = P.device.type
    if dev == "cpu":
        return bounce_plane_core(P, pkind, mkind, flags, lt, n_lights,
                                 P.shape[0] > N_IN_B)
    if dev != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    from rust_ray_tracer_tpu_torch.kernels import bounce_planes_kernel
    return bounce_planes_kernel(P, pkind, mkind, flags, lt, n_lights)


def bounce_planes_bwd(P, pkind, mkind, flags, lt, n_lights: int, g):
    """(dP like ``P``, dlt like ``lt``) for the cotangents ``g``
    [N_SU_OUT, N] of :func:`bounce_planes`' outputs:
    :func:`ops.bounce_core.bounce_plane_core_vjp` for CPU tensors, kernel
    F' (``csrc/split.cu``) and B''s sum of its light-table partials for
    CUDA tensors."""
    dev = P.device.type
    if dev == "cpu":
        return bounce_plane_core_vjp(P, pkind, mkind, flags, lt, n_lights,
                                     P.shape[0] > N_IN_B, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    from rust_ray_tracer_tpu_torch.kernels import bounce_planes_bwd_kernel
    return bounce_planes_bwd_kernel(P, pkind, mkind, flags, lt, n_lights, g)


class BouncePlanes(torch.autograd.Function):
    """Kernel F as a differentiable function of its planes and the light
    table: ``_bounce_planes_call``'s ``custom_vjp`` (``pallas_bounce.py:
    359-407``). The forward is :func:`bounce_planes`, the backward
    :func:`bounce_planes_bwd` (F' recomputes the forward from the saved
    inputs), both by the tensors' device. The kind, material and flag
    planes take no gradient."""

    @staticmethod
    def forward(fctx, P, pkind, mkind, flags, lt, n_lights: int):
        fctx.save_for_backward(P, pkind, mkind, flags, lt)
        fctx.n_lights = n_lights
        return bounce_planes(P, pkind, mkind, flags, lt, n_lights)

    @staticmethod
    def backward(fctx, g):
        P, pkind, mkind, flags, lt = fctx.saved_tensors
        dP, dlt = bounce_planes_bwd(P, pkind, mkind, flags, lt,
                                    fctx.n_lights, g.contiguous())
        return dP, None, None, None, dlt, None


# ---------------------------------------------------------------------------
# G and G': F and F' that pass a tile with no live lane through
# ---------------------------------------------------------------------------

def live_tiles(alive):
    """[N / LIVE_TILE] int32: 1 where the 1024-lane tile of the alive
    plane ``alive`` [N] holds a live lane (``pallas_uber.py:1490-1492``)."""
    return (alive > 0.5).reshape(-1, LIVE_TILE).any(dim=1).to(torch.int32)


def _live_lanes(tlive):
    return torch.repeat_interleave(tlive > 0, LIVE_TILE)


def bounce_planes_live_plain(P, pkind, mkind, flags, lt, n_lights: int,
                             tlive):
    """Kernel G's plain version: :func:`ops.bounce_core.bounce_plane_core`
    of ``P`` [46 (+6), N], where a tile whose flag in ``tlive`` [N / 1024]
    is 0 copies its o, d, L, beta and alive planes through
    (``_make_kernel_live``, ``pallas_bounce.py:420-441``)."""
    out = bounce_plane_core(P, pkind, mkind, flags, lt, n_lights,
                            P.shape[0] > N_IN_B)
    through = torch.cat([P[0:6], P[24:30], P[45:46]])
    return torch.where(_live_lanes(tlive), out, through)


def bounce_planes_live_bwd_plain(P, pkind, mkind, flags, lt, n_lights: int,
                                 tlive, g):
    """Kernel G''s plain version: (dP like ``P``, dlt like ``lt``) for the
    cotangents ``g`` [13, N] of :func:`bounce_planes_live_plain`'s outputs
    (``_make_bwd_kernel_live``, ``pallas_bounce.py:444-487``). A live tile
    takes :func:`ops.bounce_core.bounce_plane_core_vjp`; a dead one the
    pass-through's cotangent (o, d, L, beta from ``g``, every other plane
    0) and no share of dlt."""
    live = _live_lanes(tlive)
    dP, dlt = bounce_plane_core_vjp(P, pkind, mkind, flags, lt, n_lights,
                                    P.shape[0] > N_IN_B,
                                    torch.where(live, g, 0.0))
    through = torch.zeros_like(P)
    through[0:6] = g[0:6]
    through[24:30] = g[6:12]
    return torch.where(live, dP, through), dlt


def bounce_planes_live(P, pkind, mkind, flags, lt, n_lights: int, tlive):
    """[N_SU_OUT, N] next-state planes of G: :func:`bounce_planes_live_plain`
    for CPU tensors, kernel G (``csrc/split.cu``) for CUDA tensors."""
    dev = P.device.type
    if dev == "cpu":
        return bounce_planes_live_plain(P, pkind, mkind, flags, lt, n_lights,
                                        tlive)
    if dev != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    from rust_ray_tracer_tpu_torch.kernels import bounce_planes_live_kernel
    return bounce_planes_live_kernel(P, pkind, mkind, flags, lt, n_lights,
                                     tlive)


def bounce_planes_live_bwd(P, pkind, mkind, flags, lt, n_lights: int, tlive,
                           g):
    """(dP like ``P``, dlt like ``lt``): :func:`bounce_planes_live_bwd_plain`
    for CPU tensors, kernel G' (``csrc/split.cu``) and B''s sum of its
    light-table partials for CUDA tensors."""
    dev = P.device.type
    if dev == "cpu":
        return bounce_planes_live_bwd_plain(P, pkind, mkind, flags, lt,
                                            n_lights, tlive, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    from rust_ray_tracer_tpu_torch.kernels import (
        bounce_planes_live_bwd_kernel)
    return bounce_planes_live_bwd_kernel(P, pkind, mkind, flags, lt,
                                         n_lights, tlive, g)


class BouncePlanesLive(torch.autograd.Function):
    """Kernel G as a differentiable function of its planes and the light
    table: ``bounce_planes_live``'s ``custom_vjp`` (``pallas_bounce.py:
    492-572``). The forward is :func:`bounce_planes_live`, the backward
    :func:`bounce_planes_live_bwd` (G' recomputes the forward from the
    saved inputs), both by the tensors' device. The kind, material, flag
    and liveness planes take no gradient."""

    @staticmethod
    def forward(fctx, P, pkind, mkind, flags, lt, n_lights: int, tlive):
        fctx.save_for_backward(P, pkind, mkind, flags, lt, tlive)
        fctx.n_lights = n_lights
        return bounce_planes_live(P, pkind, mkind, flags, lt, n_lights, tlive)

    @staticmethod
    def backward(fctx, g):
        P, pkind, mkind, flags, lt, tlive = fctx.saved_tensors
        dP, dlt = bounce_planes_live_bwd(P, pkind, mkind, flags, lt,
                                         fctx.n_lights, tlive, g.contiguous())
        return dP, None, None, None, dlt, None, None


def bounce_fused(st, sel, rnd_b, lt, n_lights: int, has_checker: bool):
    """The next state [14, N] of one split-route bounce of ``st`` [14, N]
    (o, d, time, alive, L, beta) for the phase-1 selection ``sel``
    (``ops/intersect.Select``) and the bounce's randoms ``rnd_b`` [>= 15,
    N]: ``bounce_fused`` (``pallas_bounce.py:822-899``) on the port's
    plane layout, through :class:`BouncePlanes`. The winner's albedo, fuzz,
    ior and (``has_checker``) checker leaves come from ``sel.attr``;
    ``flags`` holds FlipFace (bit 0) and the checker flag (bit 1)."""
    attr = sel.attr
    cols = [st[0:7], sel.t_min[None], sel.t_max[None], sel.pack.T,
            sel.t_med[None], attr[:, MATTR_ALBEDO].T,
            attr[:, MATTR_FUZZ:MATTR_IOR + 1].T, st[8:14], rnd_b[0:15],
            st[7:8]]
    flags = sel.flip.to(torch.int32)
    if has_checker:
        cols += [attr[:, MATTR_EVEN].T, attr[:, MATTR_ODD].T]
        flags = flags | ((attr[:, MATTR_ISCHK] > 0.5).to(torch.int32) << 1)
    P = torch.cat(cols).contiguous()
    out = BouncePlanes.apply(P, sel.kind.to(torch.int32).contiguous(),
                             attr[:, MATTR_MKIND].to(torch.int32).contiguous(),
                             flags.contiguous(), lt, n_lights)
    return torch.cat([out[0:6], st[6:7], out[12:13], out[6:12]])
