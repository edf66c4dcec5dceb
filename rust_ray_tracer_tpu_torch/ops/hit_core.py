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

:func:`hit_plane_core_vjp` is its hand-derived adjoint, the counterpart
of ``jax.vjp`` of ``_hit_plane_core``; ``csrc/trace_wave_bwd.cu``
computes the winner's branch of it.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.intersect import (
    KIND_MED, KIND_NONE, KIND_QUAD, KIND_SPH, KIND_TRI)
from rust_ray_tracer_tpu_torch.ops.shade_core import (
    _add3, _cross, _cross_bwd, _dot, _mask, _max, _normalize,
    _normalize_bwd, _pick_bwd, _safe_div, _safe_div_bwd, _safe_sqrt,
    _safe_sqrt_bwd, _scale3, _where)

N_IN = 19    # o(3) d(3) time tmin tmax pack(9) tmed
N_OUT = 12   # t p(3) n(3) u v uvsrc(3)


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


def hit_plane_core_vjp(P, kind, flip, cot):
    """Adjoint of :func:`hit_plane_core`: the cotangent of ``P``
    ``[N_IN, ...]`` for output cotangents ``cot`` ``[N_OUT, ...]``.

    Counterpart of ``jax.vjp`` of ``pallas_hit._hit_plane_core``
    (``pallas_hit.py:54``). The ray (o, d), the shutter time (a moving
    sphere's centre), the winner pack and the medium distance take
    cotangents; tmin and tmax only feed comparisons. Each kind's branch
    takes the cotangent of the lanes that select it; the sphere's UV
    source is unselected, so its cotangent reaches the sphere branch on
    every lane, as in JAX.
    """
    ox, oy, oz = P[0], P[1], P[2]
    dx, dy, dz = P[3], P[4], P[5]
    o, d = (ox, oy, oz), (dx, dy, dz)
    time, tmin, tmax = P[6], P[7], P[8]
    v0 = (P[9], P[10], P[11])
    e1 = (P[12], P[13], P[14])
    e2 = (P[15], P[16], P[17])
    g_t_out, g_p, g_n = cot[0], (cot[1], cot[2], cot[3]), \
        (cot[4], cot[5], cot[6])
    g_u, g_v, g_uv = cot[7], cot[8], (cot[9], cot[10], cot[11])
    dP = torch.zeros_like(P)
    # the forward without the FlipFace fold: t, and the normal's y whose
    # sign picks the branch of -|ny|
    fwd = hit_plane_core(P, kind, torch.zeros_like(kind))
    t = torch.where(kind == KIND_NONE, torch.zeros_like(dx), fwd[0])
    ny_sel = fwd[5]

    # p = o + t * d; ny = where(flip, -|ny|, ny)
    g_t = _mask(kind != KIND_NONE, g_t_out) + _dot(*g_p, *d)
    g_o = g_p
    g_d = _scale3(t, g_p)
    g_ny = torch.where(flip > 0, -torch.where(ny_sel >= 0, g_n[1],
                                              -g_n[1]), g_n[1])
    g_n = (g_n[0], g_ny, g_n[2])
    is_tri, is_sph, is_qud = (kind == KIND_TRI, kind == KIND_SPH,
                              kind == KIND_QUAD)

    # ---- triangle ------------------------------------------------------
    gt, gu, gv = (_mask(is_tri, x) for x in (g_t, g_u, g_v))
    gn = tuple(_mask(is_tri, x) for x in g_n)
    tn = _cross(e1, e2)
    det = -_dot(*d, *tn)
    m = _cross(o, d)
    c_e2v0 = _cross(e2, v0)
    c_v0e1 = _cross(v0, e1)
    u_num = _dot(*m, *e2) - _dot(*d, *c_e2v0)
    v_num = -_dot(*m, *e1) - _dot(*d, *c_v0e1)
    t_num = _dot(*o, *tn) - _dot(*v0, *tn)
    inv_det = _safe_div(torch.ones_like(det), det)
    g_inv = gt * t_num + gu * u_num + gv * v_num
    g_tn_, g_un, g_vn = gt * inv_det, gu * inv_det, gv * inv_det
    _, g_det = _safe_div_bwd(torch.ones_like(det), det, g_inv)
    sgn = _where(det > 0, 1.0, _where(det < 0, -1.0, 0.0))
    g_tn = _normalize_bwd(*tn, *_scale3(sgn, gn))
    g_d = _add3(g_d, _scale3(-g_det, tn))
    g_tn = _add3(g_tn, _scale3(-g_det, d))
    g_o = _add3(g_o, _scale3(g_tn_, tn))
    g_tn = _add3(g_tn, _scale3(g_tn_, _add3(o, _scale3(-1.0, v0))))
    g_v0 = _scale3(-g_tn_, tn)
    g_m = _add3(_scale3(g_un, e2), _scale3(-g_vn, e1))
    g_e2 = _scale3(g_un, m)
    g_e1 = _scale3(-g_vn, m)
    g_d = _add3(g_d, _add3(_scale3(-g_un, c_e2v0), _scale3(-g_vn, c_v0e1)))
    ga, gb = _cross_bwd(e2, v0, _scale3(-g_un, d))
    g_e2, g_v0 = _add3(g_e2, ga), _add3(g_v0, gb)
    ga, gb = _cross_bwd(v0, e1, _scale3(-g_vn, d))
    g_v0, g_e1 = _add3(g_v0, ga), _add3(g_e1, gb)
    ga, gb = _cross_bwd(o, d, g_m)
    g_o, g_d = _add3(g_o, ga), _add3(g_d, gb)
    ga, gb = _cross_bwd(e1, e2, g_tn)
    g_e1, g_e2 = _add3(g_e1, ga), _add3(g_e2, gb)
    g_pack = list(g_v0 + g_e1 + g_e2)

    # ---- sphere --------------------------------------------------------
    gt = _mask(is_sph, g_t)
    gns = tuple(_mask(is_sph, x) for x in g_n)
    c0, c1 = v0, e1
    st0, st1, sr = e2
    num, den = time - st0, st1 - st0
    frac = _safe_div(num, den)
    dc = _add3(c1, _scale3(-1.0, c0))
    cen = _add3(c0, _scale3(frac, dc))
    oc = _add3(o, _scale3(-1.0, cen))
    a = _dot(*d, *d)
    b = _dot(*oc, *d)
    cc = _dot(*oc, *oc) - sr * sr
    disc = b * b - a * cc
    sq = _safe_sqrt(disc)
    nb1, nb2 = -b - sq, -b + sq
    root1 = _safe_div(nb1, a)
    ok1 = (disc > 0.0) & (root1 >= tmin) & (root1 <= tmax)
    t_sph = torch.where(ok1, root1, _safe_div(nb2, a))
    ps = _add3(o, _scale3(t_sph, d))
    m_r = _max(sr, 1e-12)
    inv_r = 1.0 / m_r
    g_ns = _add3(gns, tuple(_mask(ok1, x) for x in g_uv))
    g_ps = tuple(_mask(~ok1, x) for x in g_uv)
    rel = _add3(ps, _scale3(-1.0, cen))
    g_ps = _add3(g_ps, _scale3(inv_r, g_ns))
    g_cen = _scale3(-inv_r, g_ns)
    g_invr = _dot(*g_ns, *rel)
    g_o = _add3(g_o, g_ps)
    gt = gt + _dot(*g_ps, *d)
    g_d = _add3(g_d, _scale3(t_sph, g_ps))
    g_sr = _pick_bwd(sr, m_r, 1e-12, -g_invr / (m_r * m_r))
    g_nb1, g_a = _safe_div_bwd(nb1, a, _mask(ok1, gt))
    g_nb2, g_a2 = _safe_div_bwd(nb2, a, _mask(~ok1, gt))
    g_a = g_a + g_a2
    g_b = -g_nb1 - g_nb2
    g_disc = _safe_sqrt_bwd(disc, g_nb2 - g_nb1)
    g_b = g_b + 2.0 * b * g_disc
    g_a = g_a - cc * g_disc
    g_cc = -a * g_disc
    g_oc = _add3(_scale3(2.0 * g_cc, oc), _scale3(g_b, d))
    g_sr = g_sr - 2.0 * sr * g_cc
    g_d = _add3(g_d, _add3(_scale3(g_b, oc), _scale3(2.0 * g_a, d)))
    g_o = _add3(g_o, g_oc)
    g_cen = _add3(g_cen, _scale3(-1.0, g_oc))
    g_frac = _dot(*g_cen, *dc)
    g_c1 = _scale3(frac, g_cen)
    g_c0 = _add3(g_cen, _scale3(-frac, g_cen))
    g_num, g_den = _safe_div_bwd(num, den, g_frac)
    g_sph = list(g_c0 + g_c1) + [-g_num - g_den, g_den, g_sr]
    g_time = g_num

    # ---- quad ----------------------------------------------------------
    gt, ga_, gb_ = (_mask(is_qud, x) for x in (g_t, g_u, g_v))
    gnq = tuple(_mask(is_qud, x) for x in g_n)
    q, qu, qv = v0, e1, e2
    wn = _cross(qu, qv)
    denom = _dot(*d, *wn)
    qo = _add3(q, _scale3(-1.0, o))
    qnum = _dot(*qo, *wn)
    t_q = _safe_div(qnum, denom)
    w = _add3(_add3(o, _scale3(t_q, d)), _scale3(-1.0, q))
    n2 = _dot(*wn, *wn)
    inv_n2 = _safe_div(torch.ones_like(denom), n2)
    wxv = _cross(w, qv)
    uxw = _cross(qu, w)
    A = _dot(*wxv, *wn)
    B = _dot(*uxw, *wn)
    nq = _normalize(*wn)
    dsign = _where(_dot(*d, *nq) > 0, -1.0, 1.0)
    g_wn = _normalize_bwd(*wn, *_scale3(dsign, gnq))
    gA, gB = ga_ * inv_n2, gb_ * inv_n2
    _, g_n2 = _safe_div_bwd(torch.ones_like(denom), n2, ga_ * A + gb_ * B)
    g_wn = _add3(g_wn, _add3(_scale3(gA, wxv), _scale3(gB, uxw)))
    g_w, g_qv = _cross_bwd(w, qv, _scale3(gA, wn))
    g_qu, gw2 = _cross_bwd(qu, w, _scale3(gB, wn))
    g_w = _add3(g_w, gw2)
    g_wn = _add3(g_wn, _scale3(2.0 * g_n2, wn))
    g_o = _add3(g_o, g_w)
    gt = gt + _dot(*g_w, *d)
    g_d = _add3(g_d, _scale3(t_q, g_w))
    g_q = _scale3(-1.0, g_w)
    g_qn, g_dn = _safe_div_bwd(qnum, denom, gt)
    g_q = _add3(g_q, _scale3(g_qn, wn))
    g_o = _add3(g_o, _scale3(-g_qn, wn))
    g_wn = _add3(g_wn, _add3(_scale3(g_qn, qo), _scale3(g_dn, d)))
    g_d = _add3(g_d, _scale3(g_dn, wn))
    ga, gb = _cross_bwd(qu, qv, g_wn)
    g_qu, g_qv = _add3(g_qu, ga), _add3(g_qv, gb)
    g_quad = list(g_q + g_qu + g_qv)

    for i in range(9):
        dP[9 + i] = g_pack[i] + g_sph[i] + g_quad[i]
    dP[0:3] = torch.stack(g_o)
    dP[3:6] = torch.stack(g_d)
    dP[6] = g_time
    dP[18] = _mask(kind == KIND_MED, g_t)
    return dP

