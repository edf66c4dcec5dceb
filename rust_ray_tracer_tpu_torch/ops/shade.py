"""Material shading of the split route's plain tail: TPU kernels I and I'.

Counterpart of ``rust_ray_tracer_tpu/ops/shade.py`` (``Scatter``,
``shade``, ``shade.py:56``) and of ``ops/pallas_shade.shade_fused``
(``pallas_shade.py:539``), the kernel ``shade`` hands off to on the TPU:
all five materials and the light-mixture sampling of every lane, for a
scene whose light table overflows the fused kernels' 128-lane row (9
lights or more, ``pallas_bounce.su_eligible``). The integrator then runs
the estimator update in torch (``ops/integrator.bounce_split``).

  * :func:`shade_planes` runs :func:`shade_plane_core`
    (``ops/shade_core.plane_core``, the plain version of ``_plane_core``,
    ``pallas_shade.py:112-342``) for CPU tensors and kernel I (``shade_kernel``, ``csrc/shade.cu``; JAX's
    ``_shade_pallas``, ``:420``) for CUDA tensors;
  * :func:`shade_planes_bwd` runs :func:`shade_plane_core_vjp` or kernel I'
    (``shade_bwd_kernel``; JAX's ``_shade_bwd_pallas``, ``:465``) with
    B''s fixed-order sum of its per-block light-table partials;
  * :class:`ShadeFused` pairs them for autograd (``shade_fused``'s
    ``custom_vjp``): the randoms and the kinds take no cotangent (detached
    sampling, ``:552-563``); the light table's flows into ``light_c``,
    ``light_r``, ``light_q``, ``light_u``, ``light_v`` through the
    differentiable ``light_table`` cat;
  * :func:`shade` is JAX's ``shade``: the winner's material kind, fuzz and
    ior from its gathered material row, the albedo from ``texture_value``,
    and the bounce's uniforms ``ub`` [C, 9] and normals ``gb`` [C, 6] from
    the wave's randoms (the SCATTER and FUZZ draws that kernels F and H
    read too).

JAX's ``ops/sampling.py`` is not ported as a module: its cosine, ball and
light sample/pdf helpers are the ones ``ops/shade_core.plane_core``
already computes (``_onb``, ``_ball``, ``_sphere_pdf_fwd``,
``_quad_pdf_fwd``), as ``_plane_core`` inlines them in JAX.

Plane layout of I: data [14, N] d(3) p(3) n(3) albedo(3) fuzz ior, rng
[15, N] ub(9) gb(6), int32 kind [N], lt [n_lights, LT_COLS]. Output
[10, N]: emitted(3) weight(3) direction(3) alive (1.0 / 0.0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_ray_tracer_tpu_torch.ops.intersect import (MATTR_FUZZ, MATTR_IOR,
                                                     MATTR_MKIND)
from rust_ray_tracer_tpu_torch.models.scene import (LIGHT_QUAD, LIGHT_SPHERE,
                                                    MAT_LAMBERTIAN)
from rust_ray_tracer_tpu_torch.ops.shade_core import (EPS, PI, _dot, _max,
                                                      _plane_fwd,
                                                      _quad_pdf_fwd,
                                                      _safe_sqrt, _where,
                                                      plane_core,
                                                      plane_core_vjp)
from rust_ray_tracer_tpu_torch.ops.texture import texture_value

N_OUT = 10
CAND_CHUNK = 32         # kernel I's lights a candidate mask covers


class Scatter(NamedTuple):
    emitted: torch.Tensor    # [C, 3] radiance emitted at the hit
    weight: torch.Tensor     # [C, 3] multiplicative throughput factor
    direction: torch.Tensor  # [C, 3] next ray direction
    alive: torch.Tensor      # [C] bool, continue tracing?


def shade_plane_core(data, rng, kind, lt, n_lights: int):
    """Kernel I's plain version: [10, N] output planes of the shading of
    ``data`` [14, N] and ``rng`` [15, N] with int32 ``kind`` [N] and the
    lights ``lt`` [n_lights, LT_COLS] (:func:`ops.shade_core.plane_core`
    on stacked planes)."""
    return torch.stack(plane_core(tuple(data), tuple(rng), kind, lt,
                                  n_lights))


def _sphere_disc(lt, l, p, sd):
    """(disc, aa, bb) of sphere light row ``l`` against the lines p + t sd,
    with ``_sphere_pdf_fwd``'s operations (kernel I's ``sphere_disc``)."""
    c, r = (lt[l, 1], lt[l, 2], lt[l, 3]), lt[l, 4]
    ocx, ocy, ocz = p[0] - c[0], p[1] - c[1], p[2] - c[2]
    aa = _dot(*sd, *sd)
    bb = _dot(ocx, ocy, ocz, *sd)
    cc = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
    return bb * bb - aa * cc, aa, bb


def _sphere_candidate_pdf(lt, l, p, sd):
    """Kernel I's ``sphere_candidate_pdf``: the sphere light's pdf where
    its discriminant is positive, the hit test on the far root alone."""
    disc, aa, bb = _sphere_disc(lt, l, p, sd)
    r2 = (-bb + _safe_sqrt(disc)) / _max(aa, EPS)
    c, r = (lt[l, 1], lt[l, 2], lt[l, 3]), lt[l, 4]
    tc = (c[0] - p[0], c[1] - p[1], c[2] - p[2])
    cos_max = _safe_sqrt(1.0 - r * r / _max(_dot(*tc, *tc), EPS))
    solid = 2.0 * PI * (1.0 - cos_max)
    return _where(r2 >= 1e-4, 1.0 / _max(solid, EPS), 0.0)


def shade_candidates_replay(data, rng, kind, lt, n_lights: int):
    """Kernel I's order of work (``csrc/shade.cu`` ``CandidateLights``)
    replayed in torch: (the [10, N] output planes, the candidate lights of
    each lane [N] int32, 0 off the Lambertian lanes). The lights' part of
    the mixture pdf goes in chunks of CAND_CHUNK lights, in order: pass 1
    marks a sphere light where its discriminant is positive, a quad light
    always, a row of another kind never; pass 2 adds the full pdf of each
    marked light in light order, a sphere's on its far root alone. Every
    other operation is :func:`shade_plane_core`'s, and the planes are its
    bit for bit: a light left out has pdf +0, the sum starts at +0 and no
    term is negative. Takes ``lt`` rows' kinds from the host."""
    n_cand = torch.zeros(kind.shape, dtype=torch.int32, device=kind.device)
    kinds = lt[:n_lights, 0].tolist()

    def candidate_pdf_sum(lt, n_lights, p, sd):
        nonlocal n_cand
        pdf_sum = torch.zeros_like(p[0])
        for base in range(0, n_lights, CAND_CHUNK):
            chunk = range(base, min(base + CAND_CHUNK, n_lights))
            marks = []
            for l in chunk:                         # pass 1
                if kinds[l] == LIGHT_SPHERE:
                    marks.append(_sphere_disc(lt, l, p, sd)[0] > 0.0)
                else:
                    marks.append(torch.full_like(pdf_sum, kinds[l]
                                                 == LIGHT_QUAD,
                                                 dtype=torch.bool))
            for l, mark in zip(chunk, marks):       # pass 2
                if kinds[l] == LIGHT_SPHERE:
                    term = _sphere_candidate_pdf(lt, l, p, sd)
                else:
                    term = _quad_pdf_fwd((lt[l, 5], lt[l, 6], lt[l, 7]),
                                         (lt[l, 8], lt[l, 9], lt[l, 10]),
                                         (lt[l, 11], lt[l, 12], lt[l, 13]),
                                         p, sd)[0]
                pdf_sum = torch.where(mark, pdf_sum + term, pdf_sum)
                n_cand = n_cand + mark.to(torch.int32)
        return pdf_sum

    out = _plane_fwd(tuple(data), tuple(rng), kind, lt, n_lights,
                     candidate_pdf_sum)["out"]
    n_cand = torch.where(kind == MAT_LAMBERTIAN, n_cand,
                         torch.zeros_like(n_cand))
    return torch.stack(out), n_cand


def shade_plane_core_vjp(data, rng, kind, lt, n_lights: int, g):
    """Kernel I''s plain version: (d_data [14, N], dlt like ``lt``) for
    the cotangents ``g`` [9, N] of emitted, weight and direction (alive
    takes none; ``plane_core_vjp``)."""
    cot = tuple(g) + (torch.zeros_like(g[0]),)
    d_data, dlt = plane_core_vjp(tuple(data), tuple(rng), kind, lt, n_lights,
                                 cot)
    return torch.stack(d_data), dlt


def shade_planes(data, rng, kind, lt, n_lights: int):
    """[10, N] output planes of the shading of ``data`` [14, N] and ``rng``
    [15, N] with int32 ``kind`` [N] and the lights ``lt`` [n_lights,
    LT_COLS]: :func:`shade_plane_core` for CPU tensors, kernel I
    (``csrc/shade.cu``) for CUDA tensors."""
    dev = data.device.type
    if dev == "cpu":
        return shade_plane_core(data, rng, kind, lt, n_lights)
    if dev != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    from rust_ray_tracer_tpu_torch.kernels import shade_kernel
    return shade_kernel(data, rng, kind, lt, n_lights)


def shade_planes_bwd(data, rng, kind, lt, n_lights: int, g):
    """(d_data [14, N], dlt like ``lt``) for the cotangents ``g`` [9, N]
    of :func:`shade_planes`' emitted, weight and direction planes (alive
    takes none): :func:`shade_plane_core_vjp` for CPU tensors, kernel I'
    and B''s sum of its light-table partials for CUDA tensors."""
    dev = data.device.type
    if dev == "cpu":
        return shade_plane_core_vjp(data, rng, kind, lt, n_lights, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    from rust_ray_tracer_tpu_torch.kernels import shade_bwd_kernel
    return shade_bwd_kernel(data, rng, kind, lt, n_lights, g)


class ShadeFused(torch.autograd.Function):
    """Kernel I as a differentiable function of its data planes and the
    light table (``shade_fused``'s ``custom_vjp``, ``pallas_shade.py:
    538-563``). The forward is :func:`shade_planes`, the backward
    :func:`shade_planes_bwd` (I' recomputes the shading from the saved
    inputs), both by the tensors' device: on the card the kernels run or
    the call raises, never the plain version. The randoms and the kinds
    take no gradient."""

    @staticmethod
    def forward(fctx, data, rng, kind, lt, n_lights: int):
        fctx.save_for_backward(data, rng, kind, lt)
        fctx.n_lights = n_lights
        return shade_planes(data, rng, kind, lt, n_lights)

    @staticmethod
    def backward(fctx, g):
        data, rng, kind, lt = fctx.saved_tensors
        d_data, dlt = shade_planes_bwd(data, rng, kind, lt, fctx.n_lights,
                                       g[:9].contiguous())
        return d_data, None, None, dlt, None


def shade_fused(d_in, p, normal, albedo, kind, fuzz, ior, ub, gb, lt,
                n_lights: int) -> Scatter:
    """The Scatter of rays ``d_in``, ``p``, ``normal``, ``albedo`` [C, 3],
    int32 ``kind``, ``fuzz``, ``ior`` [C] with randoms ``ub`` [C, 9], ``gb``
    [C, 6] and the lights ``lt`` [n_lights, LT_COLS], through
    :class:`ShadeFused` (``shade_fused``, ``pallas_shade.py:539``)."""
    data = torch.cat([d_in.T, p.T, normal.T, albedo.T, fuzz[None],
                      ior[None]]).contiguous()
    rng = torch.cat([ub.T, gb.T]).detach().contiguous()
    out = ShadeFused.apply(data, rng, kind.to(torch.int32).contiguous(),
                           lt.contiguous(), n_lights)
    return Scatter(emitted=out[0:3].T, weight=out[3:6].T,
                   direction=out[6:9].T, alive=out[9] > 0.5)


def shade(scene, d_in, p, normal, u, v, mat, attr, rnd_b, lt) -> Scatter:
    """One bounce of material evaluation (``shade``, ``shade.py:56``) for
    rays ``d_in`` [C, 3] whose winners hit at ``p`` with ``normal`` [C, 3]
    and surface coordinates ``u``, ``v`` [C]: material ids ``mat`` [C] and
    the material rows ``attr`` [C, A] the selection gathered
    (``ops/intersect.Select``; the kind, fuzz and ior columns), the albedo
    from ``texture_value``, the randoms ``rnd_b`` [>= 15, C] (``ub`` its
    rows 0..8, ``gb`` 9..14) and the lights ``lt`` [n_lights, LT_COLS].
    Outputs mean something only where the ray hit; the caller masks."""
    albedo = texture_value(scene, scene.mat_tex[mat.long()], u, v, p)
    return shade_fused(d_in, p, normal, albedo,
                       attr[:, MATTR_MKIND].to(torch.int32),
                       attr[:, MATTR_FUZZ], attr[:, MATTR_IOR],
                       rnd_b[0:9].T, rnd_b[9:15].T, lt, scene.n_lights)
