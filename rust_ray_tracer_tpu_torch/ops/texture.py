"""Branchless texture evaluation over the scene's texture table.

Counterpart of ``rust_ray_tracer_tpu/ops/texture.py`` (``texture_value``,
``texture.py:51``): every shaded ray evaluates the leaf kinds the scene
has — solid and marble noise (``texture.rs:74-82``, through
:func:`ops.perlin.turb`) — and selects by its texture kind, plus one level
of checker indirection (``texture.rs:50-57``). The split route runs it as
torch glue between kernels J and H, as the JAX package runs it in XLA.

Image leaves are not ported (ROADMAP queue 1 item 12): a scene whose
image table is not empty raises. Where ``./earthmap.jpg`` is missing, the
compiler already made its textures solid yellow, as the reference does.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.models.scene import TEX_CHECKER, TEX_NOISE
from rust_ray_tracer_tpu_torch.ops import gather, perlin


def _leaf_value(scene, tid, p, turb):
    """Solid or marble value of texture ids ``tid`` [...] at ``p``
    [..., 3]; ``turb`` is ``perlin.turb`` at ``p`` (None without noise)."""
    out = gather.rows(scene.tex_color, tid)
    if turb is not None:
        marble = 0.5 * (1.0 + torch.sin(gather.rows(scene.tex_scale, tid)
                                         * p[..., 2] + 10.0 * turb))
        out = torch.where((scene.tex_kind[tid] == TEX_NOISE)[..., None],
                          marble[..., None].expand_as(out), out)
    return out


def texture_value(scene, tid, u, v, p):
    """Texture colour [..., 3] of texture ids ``tid`` [...] at surface
    coordinates (u, v) and hit points ``p`` [..., 3]; (u, v) would address
    an image leaf, which is not ported. The turbulence is evaluated once
    and shared by the checker's leaves: the same values the JAX package
    computes once per leaf."""
    if scene.img_data.shape[0]:
        raise NotImplementedError(
            "image textures are not ported to the torch package yet "
            "(ROADMAP queue 1 item 12)")
    tid = tid.long()
    turb = (perlin.turb(scene.perlin_vec, scene.perlin_px, scene.perlin_py,
                        scene.perlin_pz, p)
            if scene.perlin_vec.shape[0] else None)
    out = _leaf_value(scene, tid, p, turb)
    if scene.tex_even.shape[0]:
        even = _leaf_value(scene, scene.tex_even.long()[tid], p, turb)
        odd = _leaf_value(scene, scene.tex_odd.long()[tid], p, turb)
        sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                 * torch.sin(10.0 * p[..., 2]))
        checker = torch.where((sines < 0.0)[..., None], odd, even)
        out = torch.where((scene.tex_kind[tid] == TEX_CHECKER)[..., None],
                          checker, out)
    return out
