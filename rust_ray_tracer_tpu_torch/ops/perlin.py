"""Perlin gradient noise and the marble texture, batched over rays.

Counterpart of ``rust_ray_tracer_tpu/ops/perlin.py`` (:func:`noise` and
:func:`turb`, ``perlin.py:44-82``) and of the in-kernel marble of TPU
kernel C, ``pallas_bounce._noise_row`` / ``_marble_row``
(``pallas_bounce.py:125-175``): :func:`marble` follows ``_marble_row``
operation for operation and is the plain version of the marble inside the
Hopper trace kernels (``csrc/trace_common.cuh``); :func:`marble_vjp` is
its hand-derived adjoint, the plain version of the one inside the backward
kernel.

The tables (:class:`PerlinTables`) are a 256-entry gradient table and three
permutations (perlin.rs:44-51), seeded at scene compile time. The JAX
kernel reads them through one-hot MXU contractions, which are exact, so a
plain indexed gather gives the same values. The marble of the trace
kernels gives them no gradient: a fixed procedural basis, detached by
design (``pallas_bounce.py:99-107``). :func:`noise` and :func:`turb`, the
split route's ``texture_value`` in torch, differentiate through the
gradient table as JAX's XLA ``turb`` does, its gathers summed in a fixed
order by ``ops/gather.rows``.

Indices are ``floor(x)`` cast to int32, then ``& 255`` on two's
complement, so negative cells wrap as in JAX. At the kinks the adjoint
follows ``jax.vjp``: ``floor`` has no derivative and ``abs'(0) = +1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_ray_tracer_tpu_torch.ops import gather

_MASK = 255          # perlin.rs:47-50
OCTAVES = 7          # turb depth (perlin.rs:58, texture.rs:80)


class PerlinTables(NamedTuple):
    """``vec`` [256, 3] float32 gradients; ``perm`` [3, 256] int32, the x,
    y and z permutations (``perlin_px``, ``perlin_py``, ``perlin_pz``)."""

    vec: torch.Tensor
    perm: torch.Tensor


def noise(perlin_vec, px, py, pz, p):
    """Gradient noise at points ``p`` [..., 3] -> [...] (perlin.rs:86-105);
    the JAX ``ops/perlin.noise``."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int32)
    s = uvw * uvw * (3.0 - 2.0 * uvw)
    perm = (px.long(), py.long(), pz.long())
    h = [[perm[a][((ijk[..., a] + d) & _MASK).long()] for d in (0, 1)]
         for a in range(3)]
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                grad = gather.rows(perlin_vec,
                                   (h[0][di] ^ h[1][dj] ^ h[2][dk]).long())
                weight = uvw - torch.tensor([di, dj, dk], dtype=p.dtype,
                                            device=p.device)
                w = ((di * s[..., 0] + (1 - di) * (1 - s[..., 0]))
                     * (dj * s[..., 1] + (1 - dj) * (1 - s[..., 1]))
                     * (dk * s[..., 2] + (1 - dk) * (1 - s[..., 2])))
                acc = acc + w * (grad * weight).sum(-1)
    return acc


def turb(perlin_vec, px, py, pz, p, depth: int = OCTAVES):
    """Fractal turbulence ``|sum_i 0.5**i * noise(2**i p)|``
    (perlin.rs:58-71); the JAX ``ops/perlin.turb``."""
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    for i in range(depth):
        acc = acc + weight * noise(perlin_vec, px, py, pz, p * 2.0 ** i)
        weight *= 0.5
    return acc.abs()


def _cell(tables: PerlinTables, x, y, z):
    """Per axis: the cell offset u, its Hermite weight s and the two
    permutation entries of the cell's corners (``_noise_row``'s prologue)."""
    out = []
    for c, perm in zip((x, y, z), tables.perm.long()):
        f = torch.floor(c)
        u = c - f
        i = f.to(torch.int32)
        s = u * u * (3.0 - 2.0 * u)
        out.append((u, s, (perm[(i & _MASK).long()],
                           perm[((i + 1) & _MASK).long()])))
    return out


def _corners(tables: PerlinTables, cell):
    """The 8 corners in ``_noise_row``'s order (di, dj, dk nested):
    (di, dj, dk, weights (wi, wj, wk), gradient (g0, g1, g2))."""
    (ux, sx, hx), (uy, sy, hy), (uz, sz, hz) = cell
    vec = tables.vec
    for di in range(2):
        wi = sx if di else 1.0 - sx
        for dj in range(2):
            wj = sy if dj else 1.0 - sy
            for dk in range(2):
                wk = sz if dk else 1.0 - sz
                g = vec[(hx[di] ^ hy[dj] ^ hz[dk]).long()]
                yield di, dj, dk, (wi, wj, wk), (g[..., 0], g[..., 1],
                                                 g[..., 2])


def _noise_row(tables: PerlinTables, x, y, z):
    """One octave of gradient noise, as ``pallas_bounce._noise_row``."""
    cell = _cell(tables, x, y, z)
    ux, uy, uz = cell[0][0], cell[1][0], cell[2][0]
    acc = torch.zeros_like(x)
    for di, dj, dk, (wi, wj, wk), (g0, g1, g2) in _corners(tables, cell):
        dot = g0 * (ux - di) + g1 * (uy - dj) + g2 * (uz - dk)
        acc = acc + (wi * wj * wk) * dot
    return acc


def _turb_acc(tables: PerlinTables, px, py, pz):
    """The signed octave sum of ``_marble_row`` (before the abs)."""
    acc = torch.zeros_like(px)
    w = 1.0
    for i in range(OCTAVES):
        s = float(2.0 ** i)
        acc = acc + w * _noise_row(tables, px * s, py * s, pz * s)
        w *= 0.5
    return acc


def marble(tables: PerlinTables, px, py, pz, scale):
    """``0.5 * (1 + sin(scale * z + 10 * turb(p, 7)))`` (texture.rs:74-82)
    at points (px, py, pz), elementwise with ``scale``: the plain version
    of the Hopper kernels' marble, following ``_marble_row``."""
    acc = _turb_acc(tables, px, py, pz)
    return 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * acc.abs()))


def marble_vjp(tables: PerlinTables, px, py, pz, scale, g):
    """Adjoint of :func:`marble` for the cotangent ``g``: (dpx, dpy, dpz,
    dscale). The tables take none.

    A first pass gives ``acc`` (so sign(acc) and cos(arg)); a second pass
    re-evaluates each octave's corners and accumulates d acc / dp through
    the Hermite weights (``s' = 6u(1-u)``) and the ``(u - d)`` terms of
    each corner's dot. ``floor`` has no derivative; ``abs'(0) = +1``.
    """
    acc = _turb_acc(tables, px, py, pz)
    arg = scale * pz + 10.0 * acc.abs()
    g_arg = g * (0.5 * torch.cos(arg))
    g_acc = g_arg * 10.0 * torch.where(acc >= 0, 1.0, -1.0).to(g.dtype)
    dx = torch.zeros_like(px)
    dy = torch.zeros_like(py)
    dz = torch.zeros_like(pz)
    w = 1.0
    for i in range(OCTAVES):
        s = float(2.0 ** i)
        cell = _cell(tables, px * s, py * s, pz * s)
        ux, uy, uz = cell[0][0], cell[1][0], cell[2][0]
        ds = [6.0 * u * (1.0 - u) for u in (ux, uy, uz)]
        nx = torch.zeros_like(px)
        ny = torch.zeros_like(px)
        nz = torch.zeros_like(px)
        for di, dj, dk, (wi, wj, wk), (g0, g1, g2) in _corners(tables, cell):
            dot = g0 * (ux - di) + g1 * (uy - dj) + g2 * (uz - dk)
            sgn = [1.0 if d else -1.0 for d in (di, dj, dk)]
            wijk = wi * wj * wk
            nx = nx + sgn[0] * ds[0] * (wj * wk) * dot + wijk * g0
            ny = ny + sgn[1] * ds[1] * (wi * wk) * dot + wijk * g1
            nz = nz + sgn[2] * ds[2] * (wi * wj) * dot + wijk * g2
        # d noise(p * s) / dp = s * d noise / dx, weighted by the octave's w
        dx = dx + (w * s) * nx
        dy = dy + (w * s) * ny
        dz = dz + (w * s) * nz
        w *= 0.5
    return (g_acc * dx, g_acc * dy, g_acc * dz + g_arg * scale, g_arg * pz)
