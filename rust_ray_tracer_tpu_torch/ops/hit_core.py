"""Phase-2 hit attributes on per-ray planes: the plain version of the hit
stage inside the trace kernel.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_hit.py``:
:func:`hit_plane_core` is the plain version of ``_hit_plane_core``
(``pallas_hit.py:54-195``). The winner's 9-float parameter pack is
unified across primitive kinds — rows 9..17 read as (v0, e1, e2) for a
triangle, (c0, c1, t0, t1, r) for a sphere and (q, u, v) for a quad —
and every sub-computation is ``_safe_div`` / ``_safe_sqrt`` guarded, so
the two non-winner readings give finite values that the kind select
discards. ``csrc/trace_wave.cu`` computes only the winner's reading,
with the same formulas.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.intersect import (
    KIND_MED, KIND_NONE, KIND_QUAD, KIND_SPH, KIND_TRI)
from rust_ray_tracer_tpu_torch.ops.shade_core import (
    _dot, _max, _normalize, _safe_sqrt, _where)

EPS = 1e-12
N_IN = 19    # o(3) d(3) time tmin tmax pack(9) tmed
N_OUT = 12   # t p(3) n(3) u v uvsrc(3)


def _safe_div(a, b):
    bs = torch.where(b.abs() < EPS, _where(b < 0, -EPS, EPS), b)
    return a / bs


def hit_plane_core(P, kind, flip):
    """Hit attributes for the detached closest-hit selection.

    Args:
      P: ``[N_IN, ...]`` input planes.
      kind, flip: int32 planes (``KIND_*``; FlipFace flag).

    Returns ``[N_OUT, ...]``: t (inf on miss), p(3), normal(3), u, v
    (triangle/quad only) and the sphere-UV source vector.
    """
    ox, oy, oz = P[0], P[1], P[2]
    dx, dy, dz = P[3], P[4], P[5]
    time, tmin, tmax = P[6], P[7], P[8]
    v0x, v0y, v0z = P[9], P[10], P[11]
    e1x, e1y, e1z = P[12], P[13], P[14]
    e2x, e2y, e2z = P[15], P[16], P[17]
    c0x, c0y, c0z = v0x, v0y, v0z
    c1x, c1y, c1z = e1x, e1y, e1z
    st0, st1, sr = e2x, e2y, e2z
    qx, qy, qz = v0x, v0y, v0z
    qux, quy, quz = e1x, e1y, e1z
    qvx, qvy, qvz = e2x, e2y, e2z
    tmed = P[18]

    # ---- triangle ------------------------------------------------------
    tnx = e1y * e2z - e1z * e2y
    tny = e1z * e2x - e1x * e2z
    tnz = e1x * e2y - e1y * e2x
    det = -(dx * tnx + dy * tny + dz * tnz)
    mx_ = oy * dz - oz * dy
    my_ = oz * dx - ox * dz
    mz_ = ox * dy - oy * dx
    c_e2v0x = e2y * v0z - e2z * v0y
    c_e2v0y = e2z * v0x - e2x * v0z
    c_e2v0z = e2x * v0y - e2y * v0x
    c_v0e1x = v0y * e1z - v0z * e1y
    c_v0e1y = v0z * e1x - v0x * e1z
    c_v0e1z = v0x * e1y - v0y * e1x
    u_num = (_dot(mx_, my_, mz_, e2x, e2y, e2z)
             - _dot(dx, dy, dz, c_e2v0x, c_e2v0y, c_e2v0z))
    v_num = (-_dot(mx_, my_, mz_, e1x, e1y, e1z)
             - _dot(dx, dy, dz, c_v0e1x, c_v0e1y, c_v0e1z))
    t_num = (_dot(ox, oy, oz, tnx, tny, tnz)
             - _dot(v0x, v0y, v0z, tnx, tny, tnz))
    inv_det = _safe_div(torch.ones_like(det), det)
    t_tri = t_num * inv_det
    u_tri = u_num * inv_det
    v_tri = v_num * inv_det
    sgn = _where(det > 0, 1.0, _where(det < 0, -1.0, 0.0))
    ntx, nty, ntz = _normalize(tnx, tny, tnz)
    ntx, nty, ntz = ntx * sgn, nty * sgn, ntz * sgn

    # ---- sphere --------------------------------------------------------
    frac = _safe_div(time - st0, st1 - st0)
    cenx = c0x + frac * (c1x - c0x)
    ceny = c0y + frac * (c1y - c0y)
    cenz = c0z + frac * (c1z - c0z)
    ocx, ocy, ocz = ox - cenx, oy - ceny, oz - cenz
    a = dx * dx + dy * dy + dz * dz
    b = _dot(ocx, ocy, ocz, dx, dy, dz)
    cc = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - sr * sr
    disc = b * b - a * cc
    ok = disc > 0.0
    sq = _safe_sqrt(disc)
    root1 = _safe_div(-b - sq, a)
    root2 = _safe_div(-b + sq, a)
    ok1 = ok & (root1 >= tmin) & (root1 <= tmax)
    t_sph = torch.where(ok1, root1, root2)
    psx = ox + t_sph * dx
    psy = oy + t_sph * dy
    psz = oz + t_sph * dz
    # floor 1e-12: the adjoint computes -1/floor^2, which 1e-20 overflows
    inv_r = 1.0 / _max(sr, 1e-12)
    nsx, nsy, nsz = ((psx - cenx) * inv_r, (psy - ceny) * inv_r,
                     (psz - cenz) * inv_r)
    # UV source: unit normal for the near root, world p for the far
    uvx = torch.where(ok1, nsx, psx)
    uvy = torch.where(ok1, nsy, psy)
    uvz = torch.where(ok1, nsz, psz)

    # ---- quad ----------------------------------------------------------
    wnx = quy * qvz - quz * qvy
    wny = quz * qvx - qux * qvz
    wnz = qux * qvy - quy * qvx
    denom = _dot(dx, dy, dz, wnx, wny, wnz)
    t_qud = _safe_div(_dot(qx - ox, qy - oy, qz - oz, wnx, wny, wnz), denom)
    wx_ = ox + t_qud * dx - qx
    wy_ = oy + t_qud * dy - qy
    wz_ = oz + t_qud * dz - qz
    inv_n2 = _safe_div(torch.ones_like(denom),
                       _dot(wnx, wny, wnz, wnx, wny, wnz))
    alpha = _dot(wy_ * qvz - wz_ * qvy, wz_ * qvx - wx_ * qvz,
                 wx_ * qvy - wy_ * qvx, wnx, wny, wnz) * inv_n2
    beta = _dot(quy * wz_ - quz * wy_, quz * wx_ - qux * wz_,
                qux * wy_ - quy * wx_, wnx, wny, wnz) * inv_n2
    nqx, nqy, nqz = _normalize(wnx, wny, wnz)
    dsign = _where(_dot(dx, dy, dz, nqx, nqy, nqz) > 0, -1.0, 1.0)
    nqx, nqy, nqz = nqx * dsign, nqy * dsign, nqz * dsign

    # ---- select --------------------------------------------------------
    is_tri = kind == KIND_TRI
    is_sph = kind == KIND_SPH
    is_qud = kind == KIND_QUAD
    is_med = kind == KIND_MED

    def sel(tv, sv, qv, mv, default):
        return torch.where(is_tri, tv, torch.where(
            is_sph, sv, torch.where(is_qud, qv,
                                    torch.where(is_med, mv, default))))

    zero = torch.zeros_like(dx)
    one = torch.ones_like(dx)
    t = sel(t_tri, t_sph, t_qud, tmed, zero)
    t_out = torch.where(kind == KIND_NONE, torch.full_like(t, torch.inf), t)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    nx = sel(ntx, nsx, nqx, one, one)
    ny = sel(nty, nsy, nqy, zero, zero)
    nz = sel(ntz, nsz, nqz, zero, zero)
    ny = torch.where(flip > 0, -ny.abs(), ny)   # geometry/mod.rs:226-230
    uu = sel(u_tri, zero, alpha, zero, zero)
    vv = sel(v_tri, zero, beta, zero, zero)
    return torch.stack([t_out, px, py, pz, nx, ny, nz, uu, vv,
                        uvx, uvy, uvz])
