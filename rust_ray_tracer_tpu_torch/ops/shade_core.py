"""Material shading on per-ray planes: the plain version of the shade
stage inside the trace kernel.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_shade.py``: ``LT_COLS``,
``_light_table`` (``pallas_shade.py:404``), the helpers ``_dot``,
``_normalize``, ``_safe_sqrt``, ``_onb``, ``_ball``, and
:func:`plane_core`, the plain version of ``_plane_core`` (``:112-342``):
all five materials plus light-mixture sampling on planes of any shape.
Its ``lax.stop_gradient`` sites are ``.detach()`` here (detached-sampling
discipline: gradients flow through BSDF values and pdfs, never through
sampled directions). ``csrc/trace_wave.cu`` mirrors it line for line.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.models.scene import (
    LIGHT_QUAD, LIGHT_SPHERE, MAT_DIELECTRIC, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_LIGHT, MAT_METAL)

LANES = 128
PDF_FLOOR = 1e-5        # ray.rs:112
EPS = 1e-12
PI = 3.14159265358979

N_DATA = 14             # d(3) p(3) n(3) albedo(3) fuzz ior
N_RNG = 15              # 9 uniforms + 6 normals
LT_COLS = 14            # light row: kind c(3) r q(3) u(3) v(3)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _max(x, c: float):
    """jnp.maximum against a constant: NaN propagates."""
    return torch.maximum(x, x.new_tensor(c))


def _min(x, c: float):
    return torch.minimum(x, x.new_tensor(c))


def _normalize(x, y, z):
    n2 = x * x + y * y + z * z
    inv = torch.rsqrt(_max(n2, EPS))
    inv = torch.where(n2 > 0, inv, torch.zeros_like(inv))
    return x * inv, y * inv, z * inv


def _safe_sqrt(x):
    return torch.sqrt(_max(x, EPS)) * (x > 0)


def _onb(wx, wy, wz):
    """Duff et al. branchless ONB (matches linalg.orthonormal_basis)."""
    wx, wy, wz = _normalize(wx, wy, wz)
    sign = torch.where(wz >= 0.0, 1.0, -1.0).to(wx.dtype)
    den = sign + wz
    a = -1.0 / (den + torch.where(den.abs() < 1e-8, 1e-8, 0.0).to(wx.dtype))
    b = wx * wy * a
    ux, uy, uz = 1.0 + sign * wx * wx * a, sign * b, -sign * wx
    vx, vy, vz = b, sign + wy * wy * a, -wy
    return (ux, uy, uz), (vx, vy, vz), (wx, wy, wz)


def _ball(gx, gy, gz, u):
    dx, dy, dz = _normalize(gx, gy, gz)
    r = torch.exp(torch.log(_max(u, 1e-30)) / 3.0)
    return dx * r, dy * r, dz * r


def _where(c, a, b):
    """jnp.where with scalar branches allowed on either side."""
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=torch.float32, device=c.device)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=torch.float32, device=c.device)
    return torch.where(c, a, b)


def plane_core(data, rng, kind, lt, n_lights: int):
    """Shade math for rays laid out as planes.

    Args:
      data: N_DATA planes (dx,dy,dz, px,py,pz, nx,ny,nz, ax,ay,az, fuzz, ior).
      rng: N_RNG planes (u0..u4, ul0, ul1, ufr, uir, g0..g5).
      kind: int32 plane of material ids.
      lt: [>= n_lights, LT_COLS] light table (rows past n_lights ignored).
      n_lights: light count.

    Returns 10 planes: emitted(3), weight(3), direction(3), alive (float).
    """
    dx, dy, dz, px, py, pz, nx, ny, nz, ax, ay, az, fuzz, ior = data
    u0, u1, u2, u3, u4, ul0, ul1, ufr, uir, g0, g1, g2, g3, g4, g5 = rng

    udx, udy, udz = _normalize(dx, dy, dz)

    # ---- Lambertian: cosine sample about n --------------------------
    (bux, buy, buz), (bvx, bvy, bvz), (bwx, bwy, bwz) = _onb(nx, ny, nz)
    z = _safe_sqrt(1.0 - u1)
    phi = 2.0 * PI * u0
    sr = _safe_sqrt(u1)
    lx, ly, lz = torch.cos(phi) * sr, torch.sin(phi) * sr, z
    cosx = lx * bux + ly * bvx + lz * bwx
    cosy = lx * buy + ly * bvy + lz * bwy
    cosz = lx * buz + ly * bvz + lz * bwz

    if n_lights:
        li = torch.clamp_max((u4 * n_lights).to(torch.int32), n_lights - 1)
        ldx = torch.zeros_like(dx)
        ldy = torch.zeros_like(dx)
        ldz = torch.zeros_like(dx)
        for l in range(n_lights):
            kf = lt[l, 0]
            cx, cy, cz, r = lt[l, 1], lt[l, 2], lt[l, 3], lt[l, 4]
            qx, qy, qz = lt[l, 5], lt[l, 6], lt[l, 7]
            lux, luy, luz = lt[l, 8], lt[l, 9], lt[l, 10]
            lvx, lvy, lvz = lt[l, 11], lt[l, 12], lt[l, 13]
            # sphere: cone sample toward center (sphere.rs:114-119)
            tcx, tcy, tcz = cx - px, cy - py, cz - pz
            dist_sq = _dot(tcx, tcy, tcz, tcx, tcy, tcz)
            cos_max = _safe_sqrt(1.0 - r * r / _max(dist_sq, EPS))
            zz = 1.0 + ul1 * (cos_max - 1.0)
            ph = 2.0 * PI * ul0
            ss = _safe_sqrt(1.0 - zz * zz)
            sx, sy, szl = torch.cos(ph) * ss, torch.sin(ph) * ss, zz
            (cux, cuy, cuz), (cvx, cvy, cvz), (cwx, cwy, cwz) = \
                _onb(tcx, tcy, tcz)
            sphx = sx * cux + sy * cvx + szl * cwx
            sphy = sx * cuy + sy * cvy + szl * cwy
            sphz = sx * cuz + sy * cvz + szl * cwz
            # quad: uniform point (aarect.rs:134-143)
            qdx = qx + ul0 * lux + ul1 * lvx - px
            qdy = qy + ul0 * luy + ul1 * lvy - py
            qdz = qz + ul0 * luz + ul1 * lvz - pz
            is_sph = kf == float(LIGHT_SPHERE)
            is_quad = kf == float(LIGHT_QUAD)
            cand_x = _where(is_sph, sphx, _where(is_quad, qdx, 1.0))
            cand_y = _where(is_sph, sphy, _where(is_quad, qdy, 0.0))
            cand_z = _where(is_sph, sphz, _where(is_quad, qdz, 0.0))
            sel = li == l
            ldx = torch.where(sel, cand_x, ldx)
            ldy = torch.where(sel, cand_y, ldy)
            ldz = torch.where(sel, cand_z, ldz)
        mix = u3 < 0.5
        # detached sampling: the scatter direction is a constant of the
        # estimator; pdf and scattering pdf below stay attached
        sdx = torch.where(mix, cosx, ldx).detach()
        sdy = torch.where(mix, cosy, ldy).detach()
        sdz = torch.where(mix, cosz, ldz).detach()
        # mixture pdf = 0.5 cos_pdf + 0.5 mean_l light_pdf
        ndx, ndy, ndz = _normalize(sdx, sdy, sdz)
        cos_pdf = _max(_dot(ndx, ndy, ndz, bwx, bwy, bwz) / PI, 0.0)
        pdf_sum = torch.zeros_like(dx)
        for l in range(n_lights):
            kf = lt[l, 0]
            cx, cy, cz, r = lt[l, 1], lt[l, 2], lt[l, 3], lt[l, 4]
            qx, qy, qz = lt[l, 5], lt[l, 6], lt[l, 7]
            lux, luy, luz = lt[l, 8], lt[l, 9], lt[l, 10]
            lvx, lvy, lvz = lt[l, 11], lt[l, 12], lt[l, 13]
            # sphere solid-angle pdf (sphere.rs:101-112)
            ocx, ocy, ocz = px - cx, py - cy, pz - cz
            aa = _dot(sdx, sdy, sdz, sdx, sdy, sdz)
            bb = _dot(ocx, ocy, ocz, sdx, sdy, sdz)
            cc = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = bb * bb - aa * cc
            sq = _safe_sqrt(disc)
            aas = _max(aa, EPS)
            r1 = (-bb - sq) / aas
            r2 = (-bb + sq) / aas
            hits_s = (disc > 0.0) & ((r1 >= 1e-4) | (r2 >= 1e-4))
            dist_sq = _dot(cx - px, cy - py, cz - pz,
                           cx - px, cy - py, cz - pz)
            cos_max = _safe_sqrt(1.0 - r * r / _max(dist_sq, EPS))
            solid = 2.0 * PI * (1.0 - cos_max)
            pdf_s = _where(hits_s, 1.0 / _max(solid, EPS), 0.0)
            # quad area pdf (aarect.rs:123-132)
            wnx = luy * lvz - luz * lvy
            wny = luz * lvx - lux * lvz
            wnz = lux * lvy - luy * lvx
            n2 = wnx * wnx + wny * wny + wnz * wnz
            denom = _dot(sdx, sdy, sdz, wnx, wny, wnz)
            dsafe = torch.where(denom.abs() < EPS,
                                _where(denom < 0, -EPS, EPS), denom)
            tq = _dot(qx - px, qy - py, qz - pz, wnx, wny, wnz) / dsafe
            wx_ = px + tq * sdx - qx
            wy_ = py + tq * sdy - qy
            wz_ = pz + tq * sdz - qz
            inv_n2 = 1.0 / _max(n2, EPS)
            al = _dot(wy_ * lvz - wz_ * lvy, wz_ * lvx - wx_ * lvz,
                      wx_ * lvy - wy_ * lvx, wnx, wny, wnz) * inv_n2
            be = _dot(luy * wz_ - luz * wy_, luz * wx_ - lux * wz_,
                      lux * wy_ - luy * wx_, wnx, wny, wnz) * inv_n2
            hits_q = ((tq >= 1e-3) & torch.isfinite(tq)
                      & (al >= 0.0) & (al <= 1.0)
                      & (be >= 0.0) & (be <= 1.0))
            area = _safe_sqrt(n2)
            dlen2 = _max(aa, EPS)
            distq = tq * tq * dlen2
            # both divisions guarded: a null quad row (n2 == 0) would
            # make the untaken branch 0/0 and poison the adjoint
            cosq = denom.abs() / _max(_safe_sqrt(n2), EPS) \
                / _max(_safe_sqrt(dlen2), 1e-20)
            pdf_q = _where(hits_q, distq / _max(cosq * area, EPS), 0.0)
            kf_pdf = _where(kf == float(LIGHT_SPHERE), pdf_s,
                            _where(kf == float(LIGHT_QUAD), pdf_q, 0.0))
            pdf_sum = pdf_sum + kf_pdf
        pdf = 0.5 * cos_pdf + 0.5 * pdf_sum / n_lights
        lamx, lamy, lamz = sdx, sdy, sdz
    else:
        lamx, lamy, lamz = cosx.detach(), cosy.detach(), cosz.detach()
        ndx, ndy, ndz = _normalize(lamx, lamy, lamz)
        pdf = _max(_dot(ndx, ndy, ndz, bwx, bwy, bwz) / PI, 0.0)

    # pdf.max(1e-5) with Rust's NaN semantics: a NaN pdf takes the floor
    pdf = _where(pdf > PDF_FLOOR, pdf, PDF_FLOOR)
    nlx, nly, nlz = _normalize(lamx, lamy, lamz)
    spdf = _max(_dot(nx, ny, nz, nlx, nly, nlz) / PI, 0.0)
    lam_w = spdf / pdf

    # ---- Metal ------------------------------------------------------
    dn2 = 2.0 * _dot(udx, udy, udz, nx, ny, nz)
    rx, ry, rz = udx - dn2 * nx, udy - dn2 * ny, udz - dn2 * nz
    fbx, fby, fbz = (c.detach() for c in _ball(g0, g1, g2, ufr))
    mx, my, mz = rx + fuzz * fbx, ry + fuzz * fby, rz + fuzz * fbz
    metal_ok = _dot(mx, my, mz, nx, ny, nz) > 0.0

    # ---- Dielectric -------------------------------------------------
    d_dot_n = _dot(dx, dy, dz, nx, ny, nz)
    exiting = d_dot_n > 0.0
    ratio = torch.where(exiting, ior, 1.0 / ior)
    nox = torch.where(exiting, -nx, nx)
    noy = torch.where(exiting, -ny, ny)
    noz = torch.where(exiting, -nz, nz)
    cos_t = _min(-_dot(udx, udy, udz, nox, noy, noz), 1.0)
    sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
    tir = ratio * sin_t > 1.0
    pox = ratio * (udx + cos_t * nox)
    poy = ratio * (udy + cos_t * noy)
    poz = ratio * (udz + cos_t * noz)
    kk = (1.0 - (pox * pox + poy * poy + poz * poz)).abs()
    sk = _safe_sqrt(kk)
    refx, refy, refz = pox - sk * nox, poy - sk * noy, poz - sk * noz
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    one_m = 1.0 - cos_t
    om2 = one_m * one_m
    schl = r0 + (1.0 - r0) * om2 * om2 * one_m
    do_refl = tir | (schl >= u2)
    dieux = torch.where(do_refl, rx, refx)
    dieuy = torch.where(do_refl, ry, refy)
    dieuz = torch.where(do_refl, rz, refz)

    # ---- DiffuseLight / Isotropic ----------------------------------
    front = d_dot_n < 0.0
    ibx, iby, ibz = (c.detach() for c in _ball(g3, g4, g5, uir))

    # ---- select -----------------------------------------------------
    is_lam = kind == MAT_LAMBERTIAN
    is_met = kind == MAT_METAL
    is_die = kind == MAT_DIELECTRIC
    is_iso = kind == MAT_ISOTROPIC
    is_lig = kind == MAT_LIGHT

    def sel3(lamv, metv, diev, isov, default):
        return _where(is_lam, lamv,
                      _where(is_met, metv,
                             _where(is_die, diev,
                                    _where(is_iso, isov, default))))

    one = torch.ones_like(dx)
    zero = torch.zeros_like(dx)
    emit = is_lig & front
    em = (torch.where(emit, ax, zero), torch.where(emit, ay, zero),
          torch.where(emit, az, zero))
    wt = (sel3(ax * lam_w, ax, one, ax, zero),
          sel3(ay * lam_w, ay, one, ay, zero),
          sel3(az * lam_w, az, one, az, zero))
    dr = (sel3(lamx, mx, dieux, ibx, one),
          sel3(lamy, my, dieuy, iby, one),
          sel3(lamz, mz, dieuz, ibz, one))
    alive_f = torch.where(is_met, torch.where(metal_ok, one, zero),
                          torch.where(is_lig, zero, one))
    return em + wt + dr + (alive_f,)


def _light_table(scene):
    """[n_lights, LT_COLS] rows kind, c(3), r, q(3), u(3), v(3); one zero
    row when the scene has no lights."""
    if scene.n_lights:
        return torch.cat(
            [scene.light_kind.to(torch.float32)[:, None], scene.light_c,
             scene.light_r[:, None], scene.light_q, scene.light_u,
             scene.light_v], dim=1)
    return torch.zeros((1, LT_COLS), dtype=torch.float32,
                       device=scene.device)
