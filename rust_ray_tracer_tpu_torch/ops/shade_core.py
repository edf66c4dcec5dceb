"""Material shading on per-ray planes: the plain version of the shade
stage inside the trace kernels, and its adjoint.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_shade.py``: ``LT_COLS``,
``_light_table`` (``pallas_shade.py:404``), the helpers ``_dot``,
``_normalize``, ``_safe_sqrt``, ``_onb``, ``_ball``, and
:func:`plane_core`, the plain version of ``_plane_core`` (``:112-342``):
all five materials plus light-mixture sampling on planes of any shape.
Its ``lax.stop_gradient`` sites are ``.detach()`` here (detached-sampling
discipline: gradients flow through BSDF values and pdfs, never through
sampled directions). ``csrc/trace_wave.cu`` mirrors it line for line.

:func:`plane_core_vjp` is its hand-derived adjoint, the counterpart of
``jax.vjp`` of ``_plane_core`` as the backward trace kernel takes it
(``pallas_uber.py:975``). It follows JAX's conventions at the kinks (the
``*_bwd`` helpers below); ``csrc/trace_wave_bwd.cu`` mirrors it.
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
TWO_PI = 2.0 * PI

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


def _rsqrt(x):
    """``1 / sqrt(x)`` rounded twice, as the Hopper kernels compute it
    (``csrc/trace_common.cuh`` normalize) and as torch's CPU ``rsqrt``
    does; torch's CUDA ``rsqrt`` is an approximation that differs in the
    last ulp, which the marble noise amplifies into pixel differences."""
    return 1.0 / torch.sqrt(x)


def _normalize(x, y, z):
    n2 = x * x + y * y + z * z
    inv = _rsqrt(_max(n2, EPS))
    inv = torch.where(n2 > 0, inv, torch.zeros_like(inv))
    return x * inv, y * inv, z * inv


def _safe_sqrt(x):
    return torch.sqrt(_max(x, EPS)) * (x > 0)


def _safe_div(a, b):
    bs = torch.where(b.abs() < EPS, _where(b < 0, -EPS, EPS), b)
    return a / bs


def _safe_div_bwd(a, b, g):
    """Cotangents (da, db) through ``_safe_div(a, b)``: the clamped
    divisor is a constant, so b takes none where |b| < EPS."""
    bs = torch.where(b.abs() < EPS, _where(b < 0, -EPS, EPS), b)
    return g / bs, _mask(~(b.abs() < EPS), -g * a / (bs * bs))


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


# ---------------------------------------------------------------------------
# adjoint helpers: JAX's reverse-mode rules at the kinks
# ---------------------------------------------------------------------------

def _mask(c, g):
    """Cotangent of the taken branch of ``jnp.where(c, x, ...)``."""
    return torch.where(c, g, torch.zeros_like(g))


def _pick_bwd(x, m, c: float, g):
    """Cotangent reaching ``x`` through ``m = jnp.maximum(x, c)`` (or
    ``jnp.minimum``): all of ``g`` where x is the result, half on a tie
    with the constant, none where the constant won or x is NaN (JAX's
    ``_balanced_eq``)."""
    return torch.where(x == m, torch.where(m == c, 0.5 * g, g),
                       torch.zeros_like(g))


def _safe_sqrt_bwd(x, g):
    """Cotangent of ``x`` through ``_safe_sqrt(x)``."""
    m = _max(x, EPS)
    gm = (g * (x > 0)) * (0.5 / torch.sqrt(m))
    return _pick_bwd(x, m, EPS, gm)


def _normalize_bwd(x, y, z, gx, gy, gz):
    """Cotangent of (x, y, z) through ``_normalize``; rsqrt's derivative
    is taken as JAX takes it, ``-0.5 * rsqrt(m) / m``."""
    n2 = x * x + y * y + z * z
    m = _max(n2, EPS)
    r = _rsqrt(m)
    live = n2 > 0
    inv = torch.where(live, r, torch.zeros_like(r))
    gr = _mask(live, gx * x + gy * y + gz * z)
    gn2 = _pick_bwd(n2, m, EPS, gr * (-0.5 * (r / m)))
    return (gx * inv + 2.0 * x * gn2, gy * inv + 2.0 * y * gn2,
            gz * inv + 2.0 * z * gn2)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _cross_bwd(a, b, g):
    """Cotangents of a and b through ``_cross(a, b)``: (b x g, g x a)."""
    return _cross(b, g), _cross(g, a)


def _xyz(v):
    """The component triple of a [..., 3] tensor."""
    return v[..., 0], v[..., 1], v[..., 2]


def _add3(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _scale3(s, a):
    return tuple(s * x for x in a)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _light_rows(lt, l):
    """(kind, c, r, q, u, v) of light row ``l`` as 0-d tensors."""
    row = lt[l]
    return (row[0], (row[1], row[2], row[3]), row[4],
            (row[5], row[6], row[7]), (row[8], row[9], row[10]),
            (row[11], row[12], row[13]))


def _sphere_pdf_fwd(c, r, p, sd):
    """Sphere solid-angle pdf (sphere.rs:101-112) and its intermediates."""
    ocx, ocy, ocz = p[0] - c[0], p[1] - c[1], p[2] - c[2]
    sdx, sdy, sdz = sd
    aa = _dot(sdx, sdy, sdz, sdx, sdy, sdz)
    bb = _dot(ocx, ocy, ocz, sdx, sdy, sdz)
    cc = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
    disc = bb * bb - aa * cc
    sq = _safe_sqrt(disc)
    aas = _max(aa, EPS)
    r1 = (-bb - sq) / aas
    r2 = (-bb + sq) / aas
    hits = (disc > 0.0) & ((r1 >= 1e-4) | (r2 >= 1e-4))
    tc = (c[0] - p[0], c[1] - p[1], c[2] - p[2])
    dist_sq = _dot(*tc, *tc)
    m_d = _max(dist_sq, EPS)
    x = 1.0 - r * r / m_d
    cos_max = _safe_sqrt(x)
    solid = 2.0 * PI * (1.0 - cos_max)
    m_s = _max(solid, EPS)
    pdf = _where(hits, 1.0 / m_s, 0.0)
    return pdf, dict(hits=hits, tc=tc, dist_sq=dist_sq, m_d=m_d, x=x,
                     solid=solid, m_s=m_s)


def _quad_pdf_fwd(q, lu, lv, p, sd):
    """Quad area pdf (aarect.rs:123-132) and its intermediates."""
    sdx, sdy, sdz = sd
    wn = _cross(lu, lv)
    wnx, wny, wnz = wn
    n2 = wnx * wnx + wny * wny + wnz * wnz
    denom = _dot(sdx, sdy, sdz, wnx, wny, wnz)
    dsafe = torch.where(denom.abs() < EPS, _where(denom < 0, -EPS, EPS),
                        denom)
    qp = (q[0] - p[0], q[1] - p[1], q[2] - p[2])
    num = _dot(*qp, wnx, wny, wnz)
    tq = num / dsafe
    wx_ = p[0] + tq * sdx - q[0]
    wy_ = p[1] + tq * sdy - q[1]
    wz_ = p[2] + tq * sdz - q[2]
    inv_n2 = 1.0 / _max(n2, EPS)
    lux, luy, luz = lu
    lvx, lvy, lvz = lv
    al = _dot(wy_ * lvz - wz_ * lvy, wz_ * lvx - wx_ * lvz,
              wx_ * lvy - wy_ * lvx, wnx, wny, wnz) * inv_n2
    be = _dot(luy * wz_ - luz * wy_, luz * wx_ - lux * wz_,
              lux * wy_ - luy * wx_, wnx, wny, wnz) * inv_n2
    hits = ((tq >= 1e-3) & torch.isfinite(tq)
            & (al >= 0.0) & (al <= 1.0) & (be >= 0.0) & (be <= 1.0))
    area = _safe_sqrt(n2)
    dlen2 = _max(_dot(sdx, sdy, sdz, sdx, sdy, sdz), EPS)
    distq = tq * tq * dlen2
    # both divisions guarded: a null quad row (n2 == 0) would make the
    # untaken branch 0/0 and poison the adjoint
    s1 = _safe_sqrt(n2)
    m1 = _max(s1, EPS)
    m2 = _max(_safe_sqrt(dlen2), 1e-20)
    cosq = denom.abs() / m1 / m2
    ca = cosq * area
    m_c = _max(ca, EPS)
    pdf = _where(hits, distq / m_c, 0.0)
    return pdf, dict(wn=wn, n2=n2, denom=denom, dsafe=dsafe, qp=qp, num=num,
                     tq=tq, hits=hits, area=area, dlen2=dlen2, distq=distq,
                     s1=s1, m1=m1, m2=m2, cosq=cosq, ca=ca, m_c=m_c)


def every_light_pdf_sum(lt, n_lights: int, p, sd):
    """The lights' part of the mixture pdf for the direction ``sd`` from
    ``p``: each light's pdf (sphere solid angle, quad area, else 0) added
    in light order."""
    pdf_sum = torch.zeros_like(p[0])
    for l in range(n_lights):
        kf, c, r, q, lu, lv = _light_rows(lt, l)
        pdf_s, _ = _sphere_pdf_fwd(c, r, p, sd)
        pdf_q, _ = _quad_pdf_fwd(q, lu, lv, p, sd)
        kf_pdf = _where(kf == float(LIGHT_SPHERE), pdf_s,
                        _where(kf == float(LIGHT_QUAD), pdf_q, 0.0))
        pdf_sum = pdf_sum + kf_pdf
    return pdf_sum


def _plane_fwd(data, rng, kind, lt, n_lights: int,
               light_pdf_sum=every_light_pdf_sum) -> dict:
    """Forward of :func:`plane_core` with the intermediates its adjoint
    reads; ``light_pdf_sum(lt, n_lights, p, sd)`` gives the lights' part
    of the mixture pdf (:func:`every_light_pdf_sum`)."""
    dx, dy, dz, px, py, pz, nx, ny, nz, ax, ay, az, fuzz, ior = data
    u0, u1, u2, u3, u4, ul0, ul1, ufr, uir, g0, g1, g2, g3, g4, g5 = rng
    p = (px, py, pz)

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
            kf, (cx, cy, cz), r, (qx, qy, qz), (lux, luy, luz), \
                (lvx, lvy, lvz) = _light_rows(lt, l)
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
        sd = (sdx, sdy, sdz)
        # mixture pdf = 0.5 cos_pdf + 0.5 mean_l light_pdf
        ndx, ndy, ndz = _normalize(sdx, sdy, sdz)
        cos_in = _dot(ndx, ndy, ndz, bwx, bwy, bwz) / PI
        cos_pdf = _max(cos_in, 0.0)
        pdf_sum = light_pdf_sum(lt, n_lights, p, sd)
        pdf = 0.5 * cos_pdf + 0.5 * pdf_sum / n_lights
        lamx, lamy, lamz = sdx, sdy, sdz
    else:
        lamx, lamy, lamz = cosx.detach(), cosy.detach(), cosz.detach()
        ndx, ndy, ndz = _normalize(lamx, lamy, lamz)
        cos_in = _dot(ndx, ndy, ndz, bwx, bwy, bwz) / PI
        pdf = _max(cos_in, 0.0)
        sd = (lamx, lamy, lamz)
    pdf_raw = pdf

    # pdf.max(1e-5) with Rust's NaN semantics: a NaN pdf takes the floor
    pdf = _where(pdf > PDF_FLOOR, pdf, PDF_FLOOR)
    nlx, nly, nlz = _normalize(lamx, lamy, lamz)
    s_in = _dot(nx, ny, nz, nlx, nly, nlz) / PI
    spdf = _max(s_in, 0.0)
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
    cos_in_t = -_dot(udx, udy, udz, nox, noy, noz)
    cos_t = _min(cos_in_t, 1.0)
    sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
    tir = ratio * sin_t > 1.0
    pox = ratio * (udx + cos_t * nox)
    poy = ratio * (udy + cos_t * noy)
    poz = ratio * (udz + cos_t * noz)
    k_in = 1.0 - (pox * pox + poy * poy + poz * poz)
    kk = k_in.abs()
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
    return dict(
        out=em + wt + dr + (alive_f,), ud=(udx, udy, udz),
        bw=(bwx, bwy, bwz), nd=(ndx, ndy, ndz), sd=sd, cos_in=cos_in,
        pdf_raw=pdf_raw, pdf=pdf, nl=(nlx, nly, nlz), s_in=s_in, spdf=spdf,
        lam_w=lam_w, dn2=dn2, fb=(fbx, fby, fbz), exiting=exiting,
        ratio=ratio, no=(nox, noy, noz), cos_in_t=cos_in_t, cos_t=cos_t,
        po=(pox, poy, poz), k_in=k_in, kk=kk, sk=sk, do_refl=do_refl,
        emit=emit, is_lam=is_lam, is_met=is_met, is_die=is_die,
        is_iso=is_iso)


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
    return _plane_fwd(data, rng, kind, lt, n_lights)["out"]


# ---------------------------------------------------------------------------
# adjoint
# ---------------------------------------------------------------------------

def _sphere_pdf_bwd(c, r, p, sd, g):
    """Cotangents (dc, dr, dp) of one sphere light's pdf. Only the cone's
    solid angle carries one: the hit test is a select condition."""
    _, f = _sphere_pdf_fwd(c, r, p, sd)
    m_s = f["m_s"]
    g_ms = _mask(f["hits"], -g / (m_s * m_s))
    g_solid = _pick_bwd(f["solid"], m_s, EPS, g_ms)
    g_x = _safe_sqrt_bwd(f["x"], -(g_solid * TWO_PI))
    g_q = -g_x                                   # x = 1 - rr / m_d
    m_d = f["m_d"]
    rr = r * r
    g_rr = g_q / m_d
    g_md = -g_q * rr / (m_d * m_d)
    g_dsq = _pick_bwd(f["dist_sq"], m_d, EPS, g_md)
    g_tc = _scale3(2.0 * g_dsq, f["tc"])         # tc = c - p
    return g_tc, 2.0 * r * g_rr, _scale3(-1.0, g_tc)


def _quad_pdf_bwd(q, lu, lv, p, sd, g):
    """Cotangents (dq, dlu, dlv, dp) of one quad light's pdf."""
    _, f = _quad_pdf_fwd(q, lu, lv, p, sd)
    m_c = f["m_c"]
    g_distq = _mask(f["hits"], g / m_c)
    g_mc = _mask(f["hits"], -g * f["distq"] / (m_c * m_c))
    g_ca = _pick_bwd(f["ca"], m_c, EPS, g_mc)
    g_cosq = g_ca * f["area"]
    g_area = g_ca * f["cosq"]
    g_t1 = g_cosq / f["m2"]                       # cosq = (|den| / m1) / m2
    m1 = f["m1"]
    absd = f["denom"].abs()
    g_abs = g_t1 / m1
    g_m1 = -g_t1 * absd / (m1 * m1)
    g_s1 = _pick_bwd(f["s1"], m1, EPS, g_m1)
    n2 = f["n2"]
    g_n2 = _safe_sqrt_bwd(n2, g_s1) + _safe_sqrt_bwd(n2, g_area)
    denom = f["denom"]
    g_den = torch.where(denom >= 0, g_abs, -g_abs)
    tq = f["tq"]
    g_tq = 2.0 * (g_distq * f["dlen2"]) * tq      # distq = tq * tq * dlen2
    dsafe = f["dsafe"]
    g_num = g_tq / dsafe
    g_den = g_den + _mask(denom.abs() >= EPS,
                          -g_tq * f["num"] / (dsafe * dsafe))
    wn = f["wn"]
    g_wn = _add3(_add3(_scale3(g_num, f["qp"]), _scale3(g_den, sd)),
                 _scale3(2.0 * g_n2, wn))
    g_lu, g_lv = _cross_bwd(lu, lv, g_wn)
    g_q = _scale3(g_num, wn)
    return g_q, g_lu, g_lv, _scale3(-1.0, g_q)


def plane_core_vjp(data, rng, kind, lt, n_lights: int, cot):
    """Adjoint of :func:`plane_core`: the cotangents of ``data`` (14
    planes) and of ``lt`` (``lt``'s shape, each entry summed over the
    planes) for the output cotangents ``cot`` (the 10 output planes; the
    alive plane is a select of constants and takes none).

    Counterpart of ``jax.vjp`` of ``pallas_shade._plane_core``
    (``pallas_shade.py:112-340``): the sampled directions are constants
    (the detached sites at ``:190-192, 260-262, 275, 308``), the mixture
    pdf takes a share from every light row (``:197-257``), and the kinks
    follow JAX (even split on a max/min tie, nothing to an untaken
    ``where`` branch, ``abs'(0) = 1``).
    """
    dx, dy, dz, px, py, pz, nx, ny, nz, ax, ay, az, fuzz, ior = data
    f = _plane_fwd(data, rng, kind, lt, n_lights)
    g_em, g_wt, g_dr = cot[0:3], cot[3:6], cot[6:9]
    is_lam, is_met, is_die, is_iso = (f["is_lam"], f["is_met"],
                                      f["is_die"], f["is_iso"])
    lam_w = f["lam_w"]

    # ---- select ------------------------------------------------------
    g_a = tuple(_mask(f["emit"], ge) + _mask(is_lam, gw * lam_w)
                + _mask(is_met | is_iso, gw) for ge, gw in zip(g_em, g_wt))
    g_lamw = _mask(is_lam, g_wt[0] * ax + g_wt[1] * ay + g_wt[2] * az)
    g_m = tuple(_mask(is_met, g) for g in g_dr)
    g_dieu = tuple(_mask(is_die, g) for g in g_dr)

    zero = torch.zeros_like(dx)
    g_p = (zero, zero, zero)
    g_n = (zero, zero, zero)
    d_lt = torch.zeros_like(lt)

    # ---- Lambertian: lam_w = spdf / pdf ------------------------------
    pdf, spdf = f["pdf"], f["spdf"]
    g_spdf = g_lamw / pdf
    g_pdf = _mask(f["pdf_raw"] > PDF_FLOOR, -g_lamw * spdf / (pdf * pdf))
    g_s = _pick_bwd(f["s_in"], spdf, 0.0, g_spdf) / PI
    g_n = _add3(g_n, _scale3(g_s, f["nl"]))
    if n_lights:
        g_cos = 0.5 * g_pdf
        g_ps = (g_pdf / n_lights) * 0.5
        sd = f["sd"]
        rows = []
        for l in range(n_lights):
            kf, c, r, q, lu, lv = _light_rows(lt, l)
            gs = _mask(kf == float(LIGHT_SPHERE), g_ps)
            gq = _mask(kf == float(LIGHT_QUAD), g_ps)
            g_c, g_r, gp_s = _sphere_pdf_bwd(c, r, (px, py, pz), sd, gs)
            g_q, g_lu, g_lv, gp_q = _quad_pdf_bwd(q, lu, lv, (px, py, pz),
                                                  sd, gq)
            g_p = _add3(g_p, _add3(gp_s, gp_q))
            rows.append(torch.stack([torch.zeros_like(g_r), *g_c, g_r, *g_q,
                                     *g_lu, *g_lv]))
        d_lt[:n_lights] = torch.stack(rows).reshape(
            n_lights, LT_COLS, -1).sum(-1)
    else:
        g_cos = g_pdf
    g_c = _pick_bwd(f["cos_in"], _max(f["cos_in"], 0.0), 0.0, g_cos) / PI
    g_bw = _scale3(g_c, f["nd"])
    g_n = _add3(g_n, _normalize_bwd(nx, ny, nz, *g_bw))

    # ---- Dielectric: refraction, then the shared reflection ----------
    do_refl = f["do_refl"]
    g_r = _add3(g_m, tuple(_mask(do_refl, g) for g in g_dieu))
    g_ref = tuple(_mask(~do_refl, g) for g in g_dieu)
    no, sk, po = f["no"], f["sk"], f["po"]
    g_po = g_ref
    g_sk = -_dot(*g_ref, *no)
    g_no = _scale3(-sk, g_ref)
    g_kk = _safe_sqrt_bwd(f["kk"], g_sk)
    g_kin = torch.where(f["k_in"] >= 0, g_kk, -g_kk)
    g_po = _add3(g_po, _scale3(-2.0 * g_kin, po))
    ud, cos_t, ratio = f["ud"], f["cos_t"], f["ratio"]
    e = _add3(ud, _scale3(cos_t, no))
    g_ratio = _dot(*g_po, *e)
    g_e = _scale3(ratio, g_po)
    g_ud = g_e
    g_cost = _dot(*g_e, *no)
    g_no = _add3(g_no, _scale3(cos_t, g_e))
    g_ct = -_pick_bwd(f["cos_in_t"], cos_t, 1.0, g_cost)
    g_ud = _add3(g_ud, _scale3(g_ct, no))
    g_no = _add3(g_no, _scale3(g_ct, ud))
    ex = f["exiting"]
    g_n = _add3(g_n, tuple(torch.where(ex, -g, g) for g in g_no))
    g_ior = torch.where(ex, g_ratio, -g_ratio / (ior * ior))

    # ---- Metal: m = r + fuzz * fb; r = ud - dn2 * n -----------------
    g_fuzz = _dot(*g_m, *f["fb"])
    dn2 = f["dn2"]
    g_ud = _add3(g_ud, g_r)
    g_dot = 2.0 * -_dot(*g_r, nx, ny, nz)
    g_n = _add3(g_n, _scale3(-dn2, g_r))
    g_ud = _add3(g_ud, _scale3(g_dot, (nx, ny, nz)))
    g_n = _add3(g_n, _scale3(g_dot, ud))
    g_d = _normalize_bwd(dx, dy, dz, *g_ud)

    return (g_d + g_p + g_n + g_a + (g_fuzz, g_ior)), d_lt


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
