"""Phase-2 hit attributes of the split route: TPU kernel J and its
backward J'.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_hit.py``
(``hit_attrs_fused``, ``pallas_hit.py:263``): the winner's (t, p, normal,
u, v) from its unified parameter pack. :func:`hit_planes` runs
``ops/hit_core.hit_plane_core`` (the plain version) for CPU tensors and
``hit_attrs_kernel`` (``csrc/split.cu``) for CUDA tensors;
:func:`hit_planes_bwd` runs ``hit_plane_core_vjp`` or
``hit_attrs_bwd_kernel`` likewise, and :class:`HitPlanes` pairs the two
for autograd (``_hit_planes_call``'s ``custom_vjp``, ``pallas_hit.py:
213-269``). :func:`hit_attrs_fused` packs the planes and applies the
sphere-UV epilogue (``_sphere_uv``) in torch, which autograd
differentiates, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.hit_core import (hit_plane_core,
                                                    hit_plane_core_vjp)
from rust_ray_tracer_tpu_torch.ops.intersect import KIND_SPH, _sphere_uv


def hit_planes(planes, kind, flip):
    """[12, N] attribute planes (t, p, n, u, v, the sphere-UV source) of
    [19, N] planes (o, d, time, tmin, tmax, pack, tmed) and int32 ``kind``,
    ``flip`` [N]."""
    dev = planes.device.type
    if dev == "cpu":
        return hit_plane_core(planes, kind, flip)
    if dev != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    from rust_ray_tracer_tpu_torch.kernels import hit_attrs_kernel
    return hit_attrs_kernel(planes, kind, flip)


def hit_planes_bwd(planes, kind, flip, g):
    """[19, N] cotangent of the input planes for the cotangents ``g``
    [12, N] of :func:`hit_planes`' outputs: ``hit_plane_core_vjp`` for CPU
    tensors, kernel J' (``csrc/split.cu``) for CUDA tensors."""
    dev = planes.device.type
    if dev == "cpu":
        return hit_plane_core_vjp(planes, kind, flip, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    from rust_ray_tracer_tpu_torch.kernels import hit_attrs_bwd_kernel
    return hit_attrs_bwd_kernel(planes, kind, flip, g)


class HitPlanes(torch.autograd.Function):
    """Kernel J as a differentiable function of its input planes: the
    forward :func:`hit_planes`, the backward :func:`hit_planes_bwd`, by the
    tensors' device. The winner's kind and flip take no gradient."""

    @staticmethod
    def forward(fctx, planes, kind, flip):
        fctx.save_for_backward(planes, kind, flip)
        return hit_planes(planes, kind, flip)

    @staticmethod
    def backward(fctx, g):
        planes, kind, flip = fctx.saved_tensors
        return hit_planes_bwd(planes, kind, flip, g.contiguous()), None, None


def hit_attrs_fused(o, d, time, t_min, t_max, kind, flip, pack, t_med):
    """(t [C], p [C, 3], normal [C, 3], u [C], v [C]) of the winners
    ``kind``, ``flip``, ``pack`` [C, 9] and ``t_med`` [C] for rays ``o``,
    ``d`` [C, 3] at ``time`` in [t_min, t_max]; also the [12, C] planes
    they are views of."""
    planes = torch.cat([o.T, d.T, time[None], t_min[None], t_max[None],
                        pack.T, t_med[None]]).contiguous()
    out = HitPlanes.apply(planes, kind.to(torch.int32).contiguous(),
                          flip.to(torch.int32).contiguous())
    u_s, v_s = _sphere_uv(out[9:12].T)
    sph = kind == KIND_SPH
    return (out[0], out[1:4].T, out[4:7].T, torch.where(sph, u_s, out[7]),
            torch.where(sph, v_s, out[8]), out)
