"""Branchless texture evaluation over the scene's texture table.

Counterpart of ``rust_ray_tracer_tpu/ops/texture.py`` (``texture_value``,
``texture.py:51``): every shaded ray evaluates the leaf kinds the scene
has — solid, marble noise (``texture.rs:74-82``, through
:func:`ops.perlin.turb`) and image (``texture.rs:109-127``: the nearest
texel, v flipped) — and selects by its texture kind, plus one level of
checker indirection (``texture.rs:50-57``). The split route runs it as
torch glue between kernels J and H, as the JAX package runs it in XLA.

Every table read is a row gather through ``ops/gather.rows``, the image
atlas's texels too, so the backward sums each table's cotangent in a
fixed order (B' on the card), with no float atomics.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.models.scene import (TEX_CHECKER, TEX_IMAGE,
                                                    TEX_NOISE)
from rust_ray_tracer_tpu_torch.ops import gather, perlin


def _texel(scene, tid, u, v):
    """The nearest texel [..., 3] of the image leaf of texture ids ``tid``
    at (u, v) (``texture.py:37-47``): u and v clipped to [0, 1], v
    flipped, each scaled by the image's own width or height, truncated
    and clipped to the last column or row; one gather from the atlas
    flattened to [I * Hm * Wm, 3]."""
    img = scene.tex_image[tid].long()
    size = scene.img_size[img]
    h, w = size[..., 0], size[..., 1]
    cu = torch.clamp(u, 0.0, 1.0)
    cv = 1.0 - torch.clamp(v, 0.0, 1.0)
    x = torch.minimum(torch.clamp_min((cu * w.to(u.dtype)).to(torch.int32),
                                      0), w - 1)
    y = torch.minimum(torch.clamp_min((cv * h.to(u.dtype)).to(torch.int32),
                                      0), h - 1)
    _, hm, wm, _ = scene.img_data.shape
    row = (img * hm + y.long()) * wm + x.long()
    return gather.rows(scene.img_data.reshape(-1, 3), row)


def _leaf_value(scene, tid, u, v, p, turb):
    """Solid, marble or image value of texture ids ``tid`` [...] at
    (u, v) and ``p`` [..., 3]; ``turb`` is ``perlin.turb`` at ``p`` (None
    without noise)."""
    out = gather.rows(scene.tex_color, tid)
    kind = scene.tex_kind[tid]
    if turb is not None:
        marble = 0.5 * (1.0 + torch.sin(gather.rows(scene.tex_scale, tid)
                                         * p[..., 2] + 10.0 * turb))
        out = torch.where((kind == TEX_NOISE)[..., None],
                          marble[..., None].expand_as(out), out)
    if scene.img_data.shape[0]:
        out = torch.where((kind == TEX_IMAGE)[..., None],
                          _texel(scene, tid, u, v), out)
    return out


def texture_value(scene, tid, u, v, p):
    """Texture colour [..., 3] of texture ids ``tid`` [...] at surface
    coordinates (u, v) and hit points ``p`` [..., 3]. The turbulence is
    evaluated once and shared by the checker's leaves: the same values the
    JAX package computes once per leaf."""
    tid = tid.long()
    turb = (perlin.turb(scene.perlin_vec, scene.perlin_px, scene.perlin_py,
                        scene.perlin_pz, p)
            if scene.perlin_vec.shape[0] else None)
    out = _leaf_value(scene, tid, u, v, p, turb)
    if scene.tex_even.shape[0]:
        even = _leaf_value(scene, scene.tex_even.long()[tid], u, v, p, turb)
        odd = _leaf_value(scene, scene.tex_odd.long()[tid], u, v, p, turb)
        sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                 * torch.sin(10.0 * p[..., 2]))
        checker = torch.where((sines < 0.0)[..., None], odd, even)
        out = torch.where((scene.tex_kind[tid] == TEX_CHECKER)[..., None],
                          checker, out)
    return out
